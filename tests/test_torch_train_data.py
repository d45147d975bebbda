"""The port's training input path against the JAX package's, on the CPU:
HREM training samples (host-voxelized and raw-event modes, flips drawn
from one seed), the augmentor's draws, ``collate``/``ArenaCollate``, the
pack pool's ring, ``batch_iterator``'s order, the device-side flips and
training preprocess, and K2's bf16 plain version; then the
port's training CLI for two steps on a two-sample synthetic split, its log,
``metrics.jsonl``, checkpoints and a ``-se`` resume.  Inputs are drawn
from numpy seeds; the HREM split is at its protocol resolution
(1280×720), with few events."""

import itertools
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eemflow_tpu.data.augment import FlowAugmentor as JaxFlowAugmentor
from eemflow_tpu.data.device_input import flip_batch as jax_flip_batch
from eemflow_tpu.data.device_input import make_device_preprocess as jax_make_device_preprocess
from eemflow_tpu.data.hrem import HREMEventFlow as JaxHREMEventFlow
from eemflow_tpu.data.loader import ArenaCollate as JaxArenaCollate
from eemflow_tpu.data.loader import batch_iterator as jax_batch_iterator
from eemflow_tpu.data.loader import collate as jax_collate
from eemflow_tpu.ops.correlation import local_correlation as jax_local_correlation

from eemflow_tpu_torch.data.augment import FlowAugmentor
from eemflow_tpu_torch.data.device_input import flip_batch, make_device_preprocess
from eemflow_tpu_torch.data.hrem import HREMEventFlow
from eemflow_tpu_torch.data.loader import ArenaCollate, batch_iterator, collate, prefetch
from eemflow_tpu_torch.events.io import write_flo
from eemflow_tpu_torch.events.voxel import BufferPool
from eemflow_tpu_torch.models.eemflow import INDEX_53
from eemflow_tpu_torch.ops.correlation import local_correlation_plain, local_correlation_windowed
from eemflow_tpu_torch.tools.train_hrem import main as train_main

H, W = 720, 1280
# h/v flips at even odds, so that a few samples see every case
AUG = {"crop_size": [512, 960], "do_flip": True, "h_flip_prob": 0.5, "v_flip_prob": 0.5}
# K2 in bf16: JAX rounds every product to bf16, the port sums the float32
# products of the bf16 operands and rounds once; relative to max(1, |JAX|)
K2_BF16_TOL = 5e-3


def make_train_split(base, n_samples, seed=7, n_events=2000):
    """A synthetic HREM training split: ``train/dt1/<name>/{events1.npz,
    events2.npz, flow.flo}`` at 1280×720."""
    rng = np.random.default_rng(seed)
    root = os.path.join(base, "hrem")
    for i in range(n_samples):
        d = os.path.join(root, "train", "dt1", f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        for name in ("events1.npz", "events2.npz"):
            n = n_events + 100 * i  # samples of different lengths
            np.savez(
                os.path.join(d, name),
                x=rng.integers(0, W, n).astype(np.int32), y=rng.integers(0, H, n).astype(np.int32),
                t=np.sort(rng.integers(0, 10**9, n)).astype(np.int64), p=rng.integers(0, 2, n).astype(np.int8),
            )
        write_flo((rng.standard_normal((H, W, 2)) * 2).astype(np.float32), os.path.join(d, "flow.flo"))
    return root


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return make_train_split(str(tmp_path_factory.mktemp("hrem_train")), 3)


def _pair(root, seed, **kw):
    """The JAX and the port dataset on ``root`` with one seed each."""
    kw = dict(dt="dt1", train=True, aug_params=AUG, **kw)
    return (JaxHREMEventFlow(root, rng=np.random.default_rng(seed), **kw),
            HREMEventFlow(root, rng=np.random.default_rng(seed), **kw))


def _assert_same_sample(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("raw_events", [False, True], ids=["host_voxelize", "raw_events"])
def test_hrem_training_samples_match_jax(split, raw_events):
    """Two passes over three samples, one seed: the same grids or packed
    events, the same flipped labels and flags, ``valid`` all ones, no
    ``fflow``."""
    kw = dict(raw_events=True, bucket_size=1 << 13, bucket_rungs=2) if raw_events else {}
    jds, ds = _pair(split, seed=3, **kw)
    assert len(ds) == len(jds) == 3
    seen = set()
    for i in list(range(3)) * 2:
        a, b = jds[i], ds[i]
        _assert_same_sample(a, b)
        assert "fflow" not in b and b["flow"].shape == (16, 16, 2)
        assert (b["valid"] == 1).all() and b["valid"].shape == (16, 16)
        if raw_events:
            seen.add((bool(b["flip_h"]), bool(b["flip_v"])))
    if raw_events:
        assert seen == {(False, False), (False, True), (True, False), (True, True)}, seen


def test_host_and_raw_modes_flip_the_label_alike(split):
    """One seed: the host mode's flipped label is the raw mode's, and its
    grids are the raw mode's flags applied to the unflipped grids."""
    host = HREMEventFlow(split, train=True, aug_params=AUG, rng=np.random.default_rng(9))
    raw = HREMEventFlow(split, train=True, aug_params=AUG, rng=np.random.default_rng(9), raw_events=True,
                        bucket_size=1 << 13)
    plain = HREMEventFlow(split, train=True)
    for i in range(3):
        a, b, c = host[i], raw[i], plain[i]
        np.testing.assert_array_equal(a["flow"], b["flow"])
        g = c["event_volume_old"]
        if b["flip_h"]:
            g = g[:, ::-1]
        if b["flip_v"]:
            g = g[::-1]
        np.testing.assert_array_equal(a["event_volume_old"], g)


def test_full_res_flow_label(split):
    jds, ds = _pair(split, seed=1, full_res_flow=True)
    a, b = jds[0], ds[0]
    _assert_same_sample(a, b)
    assert b["flow"].shape == (H, W, 2)


def test_eval_split_stays_the_default(split):
    """``train`` defaults to False: the test split (absent here) is read."""
    ds = HREMEventFlow(split)
    assert ds.type == "val" and len(ds) == 0


def test_augmentor_draws_match_jax():
    for seed in range(4):
        ours = FlowAugmentor(**AUG, rng=np.random.default_rng(seed))
        theirs = JaxFlowAugmentor(**AUG, rng=np.random.default_rng(seed))
        flow = np.random.default_rng(seed).standard_normal((6, 8, 2)).astype(np.float32)
        imgs = [np.arange(6 * 8 * 3, dtype=np.float32).reshape(6, 8, 3) + k for k in range(2)]
        for a, b in zip(ours(*imgs, flow, without_resize=True), theirs(*imgs, flow, without_resize=True)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.draw_flips(flow), theirs.draw_flips(flow)):
            np.testing.assert_array_equal(a, b)
    # the resize branch (MVSEC's training path, ported since) draws and
    # computes as JAX's: scale and stretch, cv2's linear resize, flips, crop
    rng = np.random.default_rng(0)
    big = [rng.standard_normal((520, 968, 5)).astype(np.float32) for _ in range(2)]
    big_flow = rng.standard_normal((520, 968, 2)).astype(np.float32)
    ours = FlowAugmentor(**AUG, rng=np.random.default_rng(9))
    theirs = JaxFlowAugmentor(**AUG, rng=np.random.default_rng(9))
    for a, b in zip(ours(*big, big_flow), theirs(*big, big_flow)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _samples(rng, lengths):
    return [
        {"events_old": rng.standard_normal((n, 4)).astype(np.float32), "n_old": np.int32(n),
         "flow": rng.standard_normal((4, 4, 2)), "flip_h": np.bool_(n % 2), "names": f"s{n}"}
        for n in lengths
    ]


@pytest.mark.parametrize("slots", [1, 2])
def test_collate_and_arena_match_jax(slots):
    """Padded event buffers, stacked arrays, numbers and names; the arena's
    rotating buffers give the same batches."""
    rng = np.random.default_rng(slots)
    arena = ArenaCollate(slots=slots)
    jarena = JaxArenaCollate(slots=slots, force_arena=True)
    for lengths in ((5, 9, 3), (7, 7, 7), (5, 9, 3)):
        batch = _samples(rng, lengths)
        ref = jax_collate(batch)
        for got in (collate(batch), arena(batch), jarena(batch)):
            assert set(got) == set(ref) and got["names"] == ref["names"]
            for k in ref:
                if k != "names":
                    np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_arena_rotates_its_buffers():
    """A batch's buffers are refilled only ``slots`` calls later."""
    rng = np.random.default_rng(1)
    arena = ArenaCollate(slots=2)
    first = arena(_samples(rng, (4, 4)))
    kept = first["flow"].copy()
    second = arena(_samples(rng, (4, 4)))
    assert not np.shares_memory(first["flow"], second["flow"])
    np.testing.assert_array_equal(first["flow"], kept)
    third = arena(_samples(rng, (4, 4)))
    assert np.shares_memory(first["flow"], third["flow"])


def test_buffer_pool_ensure_ring():
    pool = BufferPool(ring=2)
    a = pool.get(8)
    pool.ensure_ring(5)
    assert pool.ring == 5 and len(pool._pool[8]) == 5
    got = [pool.get(8) for _ in range(5)]
    assert sum(g is a for g in got) == 1  # reused only after a whole ring
    pool.ensure_ring(3)
    assert pool.ring == 5  # never shrinks


class _Indexed:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("order", [dict(shuffle=True), dict(shuffle=False, drop_last=False)],
                         ids=["shuffled", "in_order_keep_last"])
def test_batch_iterator_order_matches_jax(order):
    """Three epochs of batches of 3 from 11 samples: JAX's order, its
    last partial batch dropped or kept alike."""
    kw = dict(batch_size=3, seed=4, **order)
    per_epoch = 3 if kw.get("drop_last", True) else 4
    ours = [b["i"].tolist() for b in itertools.islice(batch_iterator(_Indexed(), **kw), 3 * per_epoch)]
    theirs = [b["i"].tolist() for b in jax_batch_iterator(_Indexed(), epochs=3, **kw)]
    assert ours == theirs and len(ours) == 3 * per_epoch


def test_batch_iterator_grows_the_pack_ring():
    class WithPool(_Indexed):
        _pack_pool = BufferPool()

    next(batch_iterator(WithPool(), batch_size=10))
    assert WithPool._pack_pool.ring == 24


def test_prefetch_passes_items_and_errors():
    assert list(prefetch(iter(range(7)), depth=2)) == list(range(7))

    def bad():
        yield 1
        raise OSError("read failed")

    it = prefetch(bad())
    assert next(it) == 1
    with pytest.raises(OSError, match="read failed"):
        next(it)


def test_flip_batch_matches_jax():
    rng = np.random.default_rng(2)
    grids = rng.standard_normal((4, 9, 11, 3)).astype(np.float32)
    fh = np.array([False, True, False, True])
    fv = np.array([False, False, True, True])
    np.testing.assert_array_equal(
        flip_batch(torch.from_numpy(grids), torch.from_numpy(fh), torch.from_numpy(fv)).numpy(),
        np.asarray(jax_flip_batch(jnp.asarray(grids), jnp.asarray(fh), jnp.asarray(fv))),
    )


def _raw_batch(rng, h, w, n_valid, N=512):
    ev = np.zeros((2, len(n_valid), N, 4), np.float32)
    for f in range(2):
        for b, n in enumerate(n_valid):
            ev[f, b, :n, 0] = np.sort(rng.uniform(0, 5e4, n))
            ev[f, b, :n, 1] = rng.integers(-2, w + 2, n)
            ev[f, b, :n, 2] = rng.integers(-2, h + 2, n)
            ev[f, b, :n, 3] = rng.integers(0, 2, n)
    batch = {
        "events_old": ev[0], "events_new": ev[1],
        "n_old": np.asarray(n_valid, np.int32), "n_new": np.asarray(n_valid[::-1], np.int32),
        "flip_h": np.array([True, False, True]), "flip_v": np.array([False, True, True]),
        "flow": rng.standard_normal((3, 4, 4, 2)).astype(np.float32),
    }
    return batch


@pytest.mark.parametrize("case", ["flips", "no_flips", "host_voxelized"])
def test_training_preprocess_matches_jax(case):
    """Raw events voxelized on the device and flipped where the batch has
    flags, as JAX's step does; a host-voxelized batch passes through."""
    h, w, bins = 24, 40, 5
    rng = np.random.default_rng(3)
    batch = _raw_batch(rng, h, w, (400, 250, 0))
    if case == "no_flips":
        del batch["flip_h"], batch["flip_v"]
    if case == "host_voxelized":
        batch = {"event_volume_old": rng.standard_normal((3, h, w, bins)).astype(np.float32),
                 "event_volume_new": rng.standard_normal((3, h, w, bins)).astype(np.float32),
                 "flow": batch["flow"]}
    got = make_device_preprocess(bins, h, w)({k: torch.from_numpy(v) for k, v in batch.items()})
    ref = jax_make_device_preprocess(bins, h, w)({k: jnp.asarray(v) for k, v in batch.items()})
    assert set(got) == set(ref) == {"event_volume_old", "event_volume_new", "flow"}
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.shape == r.shape, k
        # the grids: float32 in another summation order
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("channels", [16, 32, 64])
def test_local_correlation_bf16_matches_jax(channels):
    """K2's plain version on bf16 operands (the float32 correlation rounded
    once to bf16) against the JAX correlation on the same bf16 inputs; the
    windowed formulation K2's backward differentiates gives the plain
    version's result but for the rounding of a float32 sum in another
    order."""
    rng = np.random.default_rng(channels)
    x, y = (rng.standard_normal((2, 12, 20, channels)).astype(np.float32) for _ in range(2))
    xb, yb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, y))
    got = local_correlation_plain(xb, yb, 4, INDEX_53)
    assert got.dtype == torch.bfloat16
    ref = jax_local_correlation(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16), 4, INDEX_53)
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= K2_BF16_TOL * max(1.0, np.abs(ref).max()), err
    windowed = local_correlation_windowed(xb, yb, 4, INDEX_53).float()
    assert float((windowed - got.float()).abs().max()) <= K2_BF16_TOL * max(1.0, float(got.float().abs().max()))


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_cli_on_cpu_logs_checkpoints_and_resumes(tmp_path):
    """``train_hrem --device cpu``, B=1, two steps of one step an epoch with
    device voxelize and the default config (bf16): its log, ``metrics.jsonl``
    and two checkpoints; then ``-se 1`` runs the second epoch again from
    the first checkpoint and ends at the same step and learning rate."""
    root = make_train_split(str(tmp_path), 2, seed=8)
    args = ["--data_root", root, "-bs", "1", "--train_iters", "2", "--val_iters", "1",
            "--device", "cpu", "--device_voxelize", "--save_dir", str(tmp_path / "runs")]
    state = train_main(args)
    run = tmp_path / "runs" / "eemflow_dt1_lr1e-05_wd0.0"
    ckpt = torch.load(run / "ckpt" / "epoch_2.pt", weights_only=True)
    assert state.step == ckpt["step"] == 2
    resumed = train_main(args + ["-se", "1"])
    assert sorted(os.listdir(run / "ckpt")) == ["epoch_1.pt", "epoch_2.pt"]
    with open(run / "config.json") as f:
        cfg = json.load(f)
    assert cfg["train"]["mixed_precision"] is True and cfg["cli"]["device"] == "cpu"
    with open(run / "log.txt") as f:
        log = f.read()
    assert log.count("dataset: 2 samples") == 2 and "resumed from epoch 1" in log
    recs = _read_jsonl(run / "metrics.jsonl")
    assert [(r["kind"], r["epoch"], r["n_steps"]) for r in recs] == [("epoch", 1, 1), ("epoch", 2, 1), ("epoch", 2, 1)]
    assert all(np.isfinite(r["mean_loss"]) and r["mean_loss"] > 0 for r in recs)
    assert resumed.step == 2 and resumed.opt.lr == state.opt.lr
    assert resumed.opt.scheduler.last_epoch == state.opt.scheduler.last_epoch == 2
    assert all(p.dtype == torch.float32 for p in resumed.model.parameters())
