"""MVSEC evaluation in the port against the JAX package, on the CPU: the
HDF5 event tables (the port's own numpy reader and writer against h5py),
the dataset (dt1 and dt4, train and val, host and raw events, at the 32×40
size of ``tests/test_data.py``), the augmentor's resize branch (against
JAX's and against cv2), the device crop, ``gt_flow``, the offline encoder,
the ``Tester``'s MVSEC metrics, and the ``test_mvsec`` CLI with the golden
EEMFlow weights at MVSEC's 260×346 → 256 against JAX's ``Tester``.

Every fixture's timestamps sit at MVSEC's magnitude (an offset of 1.5e9 s):
relative time must be taken in float64 before events become float32."""

import importlib.util
import os

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eemflow_tpu.data.mvsec as jax_mvsec
from eemflow_tpu.compat.torch_loader import convert_for_model, load_torch_checkpoint
from eemflow_tpu.data.augment import FlowAugmentor as JaxAugmentor
from eemflow_tpu.data.device_input import make_device_preprocess as jax_preprocess
from eemflow_tpu.data.gt_flow import estimate_corresponding_gt_flow as jax_gt_flow
from eemflow_tpu.eval.runner import Tester as JaxTester
from eemflow_tpu.events.io import read_events_h5 as jax_read_h5, write_events_h5 as jax_write_h5
from eemflow_tpu.models import get_eval_model as jax_eval_model

import eemflow_tpu_torch.data.mvsec as port_mvsec
from eemflow_tpu_torch.data.augment import FlowAugmentor, _resize
from eemflow_tpu_torch.data.device_input import crop_batch, make_device_preprocess
from eemflow_tpu_torch.data.gt_flow import _remap_nearest, estimate_corresponding_gt_flow
from eemflow_tpu_torch.eval.runner import Tester as PortTester
from eemflow_tpu_torch.events.io import read_events_h5, read_flow_npy, write_events_h5
from eemflow_tpu_torch.tools import mvsec_encoder
from eemflow_tpu_torch.tools.test_mvsec import main as mvsec_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "tests", "fixtures", "eemflow_hrem_golden.pth.tar")
T0 = 1.5e9  # MVSEC's absolute timestamps are seconds since the epoch
FRAMES = (3, 8)  # the valid range of the synthetic sequences


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_mvsec_fixture(base, sequences=("indoor_flying1",), h=32, w=40, n_events=300, seed=7,
                       first=2, last=18):
    """Synthetic MVSEC sequences: per-frame event tables ``event/{i+1:06d}.h5``
    (sorted timestamps at T0 + i·0.03 s) and ``flowgt_dt1``/``flowgt_dt4``
    ``{i}.npy`` [2, h, w], frames ``first``..``last``."""
    rng = np.random.default_rng(seed)
    root = os.path.join(base, "mvsec")
    for seq in sequences:
        d = os.path.join(root, seq)
        for sub in ("event", "flowgt_dt1", "flowgt_dt4"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i in range(first, last):
            ev = np.stack([
                T0 + np.sort(rng.uniform(i * 0.03, (i + 1) * 0.03, n_events)),
                rng.integers(0, w, n_events).astype(np.float64),
                rng.integers(0, h, n_events).astype(np.float64),
                rng.integers(0, 2, n_events).astype(np.float64),
            ], axis=1)
            write_events_h5(ev, os.path.join(d, "event", f"{i + 1:06d}.h5"))
            for sub in ("flowgt_dt1", "flowgt_dt4"):
                np.save(os.path.join(d, sub, f"{i}.npy"), (rng.standard_normal((2, h, w)) * 2).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return make_mvsec_fixture(str(tmp_path_factory.mktemp("mvsec_small")), ("indoor_flying1", "outdoor_day1"))


@pytest.fixture(scope="module")
def full_root(tmp_path_factory):
    """260×346 sequences for the CLI: frames 3..5 evaluated."""
    return make_mvsec_fixture(str(tmp_path_factory.mktemp("mvsec_full")), ("indoor_flying1", "outdoor_day1"),
                              h=260, w=346, n_events=3000, seed=55, first=3, last=14)


# --- io -------------------------------------------------------------------


def test_h5_round_trip_and_cross_reads_with_h5py(tmp_path):
    rng = np.random.default_rng(0)
    for n in (0, 1, 1000):
        ev = np.stack([T0 + np.sort(rng.uniform(0, 0.03, n)), rng.integers(0, 346, n),
                       rng.integers(0, 260, n), rng.integers(0, 2, n)], axis=1).astype(np.float64)
        ours, theirs = str(tmp_path / f"ours{n}.h5"), str(tmp_path / f"theirs{n}.h5")
        write_events_h5(ev, ours)
        jax_write_h5(ev, theirs)  # h5py's defaults
        for path in (ours, theirs):
            np.testing.assert_array_equal(read_events_h5(path), ev)
            np.testing.assert_array_equal(jax_read_h5(path), ev)
        with h5py.File(ours, "r") as f:
            assert sorted(f["myDataset"]) == ["p", "ts", "x", "y"]
            for i, k in enumerate(("ts", "x", "y", "p")):
                assert f["myDataset"][k].dtype == np.float64
                np.testing.assert_array_equal(f["myDataset"][k][()], ev[:, i])
    # datasets at the root, without the group (the JAX reader takes both)
    root_level = str(tmp_path / "root.h5")
    with h5py.File(root_level, "w") as f:
        for i, k in enumerate(("ts", "x", "y", "p")):
            f.create_dataset(k, data=ev[:, i])
    np.testing.assert_array_equal(read_events_h5(root_level), ev)
    flow = rng.standard_normal((2, 4, 5)).astype(np.float32)
    np.save(tmp_path / "0.npy", flow)
    np.testing.assert_array_equal(read_flow_npy(str(tmp_path / "0.npy")), flow)


def test_h5_reader_refuses_other_layouts(tmp_path):
    data = np.arange(100, dtype=np.float64)
    for layout in ("chunked", "gzip", "float32", "latest superblock"):
        path = str(tmp_path / f"{layout.replace(' ', '_')}.h5")
        with h5py.File(path, "w", libver="latest" if layout == "latest superblock" else "earliest") as f:
            g = f.create_group("myDataset")
            for k in ("ts", "x", "y", "p"):
                if layout == "chunked":
                    g.create_dataset(k, data=data, chunks=(10,))
                elif layout == "gzip":
                    g.create_dataset(k, data=data, compression="gzip")
                else:
                    g.create_dataset(k, data=data.astype(np.float32) if layout == "float32" else data)
        with pytest.raises(ValueError, match=path):
            read_events_h5(path)


# --- the dataset ----------------------------------------------------------


def _small(cls, h=32, w=40):
    return type("Small" + cls.__name__, (cls,), {"image_height": h, "image_width": w})


def _datasets(root, dt, mode, eval_type="dense", seq="indoor_flying1", seed=3, bucket_size=1024):
    """The JAX and the port's dataset on the same files and draws (dt4's
    1,200 events a window overflow the default bucket: the counters too
    must agree)."""
    train = mode.startswith("train")
    kw = dict(train=train, eval_type=eval_type, raw_events=mode.endswith("raw"), bucket_size=bucket_size,
              bucket_rungs=3)
    if train:
        kw["aug_params"] = {"crop_size": [24, 32], "min_scale": -0.1, "max_scale": 1.0, "do_flip": True}
    jcls = jax_mvsec.MvsecEventFlow if dt == "dt1" else jax_mvsec.MvsecEventFlow_dt4
    pcls = port_mvsec.MvsecEventFlow if dt == "dt1" else port_mvsec.MvsecEventFlow_dt4
    table = {seq: [FRAMES]}
    ours = _small(pcls)(root, seq, rng=np.random.default_rng(seed), valid_time_index=table, **kw)
    old = jax_mvsec.VALID_TIME_INDEX[seq]
    jax_mvsec.VALID_TIME_INDEX[seq] = table[seq]
    try:
        theirs = _small(jcls)(root, seq, rng=np.random.default_rng(seed), **kw)
    finally:
        jax_mvsec.VALID_TIME_INDEX[seq] = old
    return theirs, ours


def _assert_samples_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        if np.issubdtype(x.dtype, np.floating) and k != "event_valid" and k != "valid":
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(y, x, err_msg=k)


@pytest.mark.parametrize("dt", ["dt1", "dt4"])
@pytest.mark.parametrize("mode", ["val", "val_raw", "train", "train_raw"])
def test_dataset_matches_jax(small_root, dt, mode):
    eval_type = "sparse" if mode.startswith("val") else "dense"
    theirs, ours = _datasets(small_root, dt, mode, eval_type)
    assert len(ours) == len(theirs) == FRAMES[1] - FRAMES[0]
    assert ours.event_list == theirs.event_list and ours.evaluation_type == eval_type
    k = 4 if dt == "dt4" else 1
    assert len(ours.event_list) == len(ours) + 2 * k - 1  # the trailing files, no wrap-around
    for idx in (0, len(ours) - 1, 2):
        _assert_samples_equal(theirs[idx], ours[idx])
    if mode.endswith("raw"):
        assert ours.overflow.summary() == theirs.overflow.summary()


def test_raw_events_at_mvsec_timestamps_voxelize_as_the_host(small_root):
    """Relative time in float64 before the float32 pack: the device path's
    plain K1 over the whole frame, then the centre crop, gives the host
    path's grids (normalized over the whole frame, then cropped)."""
    for dt in ("dt1", "dt4"):
        _, host = _datasets(small_root, dt, "val")
        _, raw = _datasets(small_root, dt, "val_raw", bucket_size=2048)
        pre = make_device_preprocess(5, 32, 40, crop_size=(24, 32))
        for idx in (0, len(host) - 1):
            h, r = host.get_sample(idx), raw.get_sample(idx)
            n = int(r["n_old"])
            t = r["events_old"][:n, 0]
            assert t[0] == 0 and 0 < t[-1] < 0.03e6 * host.dt_intervals  # µs since the window's first event
            batch = {k: torch.from_numpy(np.asarray(r[k])[None]) for k in ("events_old", "events_new", "n_old", "n_new")}
            out = pre(batch)
            top, left = (32 - 24) // 2, (40 - 32) // 2
            for key in ("old", "new"):
                np.testing.assert_allclose(out[f"event_volume_{key}"][0].numpy(),
                                           h[f"event_volume_{key}"][top:top + 24, left:left + 32],
                                           rtol=0, atol=1e-5)


def test_dataset_options(small_root):
    """The unported families' options raise; ``valid_time_index`` leaves the
    module's table as it was; the val centre crop at 260x346."""
    for option in ("with_dense", "time_stack", "with_images", "seg_events"):
        with pytest.raises(NotImplementedError, match="item 7"):
            port_mvsec.MvsecEventFlow(small_root, "indoor_flying1", **{option: True})
    before = {k: list(v) for k, v in port_mvsec.VALID_TIME_INDEX.items()}
    ds = _small(port_mvsec.MvsecEventFlow)(small_root, "indoor_flying1", train=False,
                                           valid_time_index={"indoor_flying1": [(3, 5)], "outdoor_day1": [(4, 6)]})
    assert ds.names == [3, 4]
    ds.change_test_sequence("outdoor_day1")
    assert ds.names == [4, 5] and port_mvsec.VALID_TIME_INDEX == before
    a = np.arange(260 * 346).reshape(260, 346)
    np.testing.assert_array_equal(port_mvsec.center_crop(a), jax_mvsec.center_crop(a))
    assert port_mvsec.center_crop(a)[0, 0] == 2 * 346 + 45


# --- the augmentor ----------------------------------------------------------


@pytest.mark.parametrize("channels", [2, 5])
def test_resize_matches_cv2(channels):
    rng = np.random.default_rng(channels)
    aug = FlowAugmentor(crop_size=(256, 256), min_scale=-0.2, max_scale=1.0, rng=rng)
    for _ in range(12):
        img = (rng.standard_normal((260, 346, channels)) * 3).astype(np.float32)
        sx, sy = aug._sample_scales(260, 346)  # the config's range, with stretch
        ref = cv2.resize(img, None, fx=sx, fy=sy, interpolation=cv2.INTER_LINEAR)
        got = _resize(img, sx, sy)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    one = rng.standard_normal((30, 41, 1)).astype(np.float32)
    assert _resize(one, 1.37, 0.83).shape == cv2.resize(one, None, fx=1.37, fy=0.83).shape == (25, 56)


def test_augmentor_matches_jax():
    rng = np.random.default_rng(11)
    kw = dict(crop_size=[24, 32], min_scale=-0.1, max_scale=1.0, do_flip=True)
    ours, theirs = FlowAugmentor(**kw, rng=np.random.default_rng(5)), JaxAugmentor(**kw, rng=np.random.default_rng(5))
    for _ in range(10):
        ev1, ev2 = (rng.standard_normal((32, 40, 5)).astype(np.float32) for _ in range(2))
        flow = rng.standard_normal((32, 40, 2)).astype(np.float32)
        for a, b in zip(ours(ev1, ev2, flow), theirs(ev1, ev2, flow)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert ours.draw_crop(260, 346) == theirs.draw_crop(260, 346)
    assert ours.rng.random() == theirs.rng.random()


def test_crop_and_device_preprocess_match_jax(small_root):
    _, raw = _datasets(small_root, "dt1", "train_raw")
    samples = [raw[i] for i in range(3)]
    keys = ("events_old", "events_new", "n_old", "n_new", "flip_h", "flip_v", "crop_y", "crop_x")
    batch = {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}
    batch["events_old"] = np.stack([np.pad(s["events_old"], ((0, 1024 - len(s["events_old"])), (0, 0)))
                                    for s in samples])
    batch["events_new"] = np.stack([np.pad(s["events_new"], ((0, 1024 - len(s["events_new"])), (0, 0)))
                                    for s in samples])
    for crop_keys in (True, False):  # random offsets; the static centre crop
        b = {k: v for k, v in batch.items() if crop_keys or k not in ("crop_y", "crop_x")}
        theirs = jax.jit(jax_preprocess(5, 32, 40, crop_size=(24, 32)))({k: jnp.asarray(v) for k, v in b.items()})
        ours = make_device_preprocess(5, 32, 40, crop_size=(24, 32))({k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(ours) == sorted(theirs)
        for k in ("event_volume_old", "event_volume_new"):
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=0, atol=1e-5)
    g = np.random.default_rng(0).standard_normal((3, 10, 12, 2)).astype(np.float32)
    got = crop_batch(torch.from_numpy(g), torch.tensor([0, 2, 6]), torch.tensor([5, 0, 7]), (4, 6)).numpy()
    for i, (y, x) in enumerate(((0, 5), (2, 0), (6, 6))):  # 7 + 6 > 12: clamped as dynamic_slice clamps
        np.testing.assert_array_equal(got[i], g[i, y:y + 4, x:x + 6])


# --- the metrics ----------------------------------------------------------


class _EchoModel(torch.nn.Module):
    """The old volume's first two channels as the flow."""

    def forward(self, ev_old, ev_new):
        return None, [ev_old[..., :2] * 3.0]


class _JaxEcho:
    def apply(self, variables, ev_old, ev_new):
        return None, [ev_old[..., :2] * 3.0]


class _Samples(list):
    evaluation_type = "sparse"


def test_tester_metrics_match_jax_with_is_car_and_sparse():
    rng = np.random.default_rng(2)
    samples = _Samples()
    for _ in range(3):
        flow = (rng.standard_normal((256, 256, 2)) * 2).astype(np.float32)
        flow[rng.random((256, 256)) < 0.1] = 0  # no GT
        samples.append({
            "event_volume_old": rng.standard_normal((256, 256, 5)).astype(np.float32),
            "event_volume_new": rng.standard_normal((256, 256, 5)).astype(np.float32),
            "flow": flow,
            "event_valid": (rng.random((256, 256, 1)) < 0.3).astype(np.float32),
        })
    for is_car in (False, True):
        ours = PortTester(_EchoModel(), "cpu", is_car=is_car).test_sequence(samples, batch_size=2)
        theirs = JaxTester(_JaxEcho(), {}, is_car=is_car).test_sequence(samples, batch_size=2)
        for k in ("AEE", "pct1_outlier", "pct3_outlier"):
            assert abs(ours[k] - theirs[k]) < 1e-6, (is_car, k)
    dense = _Samples(samples)
    dense.evaluation_type = "dense"
    car = PortTester(_EchoModel(), "cpu", is_car=True).test_sequence(dense)["AEE"]
    assert abs(car - PortTester(_EchoModel(), "cpu").test_sequence(dense)["AEE"]) > 1e-4  # rows 190+ left out


# --- gt_flow and the encoder ----------------------------------------------


def test_gt_flow_matches_cv2_and_jax():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((20, 30)).astype(np.float32) + 5
    # half-integer coordinates round half to even, as cv2 rounds them
    xs = (rng.integers(-3, 34, (20, 30)) + 0.5).astype(np.float32)
    ys = (rng.integers(-3, 24, (20, 30)) + 0.5).astype(np.float32)
    np.testing.assert_array_equal(_remap_nearest(img, xs, ys), cv2.remap(img, xs, ys, cv2.INTER_NEAREST))
    xs = rng.uniform(-2, 32, (20, 30)).astype(np.float32)
    np.testing.assert_array_equal(_remap_nearest(img, xs, ys), cv2.remap(img, xs, ys, cv2.INTER_NEAREST))
    x_flows = rng.standard_normal((6, 20, 30)).round(1) * 2
    y_flows = rng.standard_normal((6, 20, 30)).round(1) * 2
    x_flows[:, 0, :3] = 0
    ts = np.arange(6) * 0.05 + T0
    for start, end in ((T0 + 0.01, T0 + 0.03), (T0 + 0.02, T0 + 0.17), (T0 + 0.05, T0 + 0.2)):
        for a, b in zip(estimate_corresponding_gt_flow(x_flows, y_flows, ts, start, end),
                        jax_gt_flow(x_flows, y_flows, ts, start, end)):
            np.testing.assert_array_equal(a, b)


def _jax_encoder():
    spec = importlib.util.spec_from_file_location("jax_mvsec_encoder", os.path.join(REPO, "tools", "mvsec_encoder.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_encoder_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    h, w, n_img, n_ev = 12, 16, 7, 4000
    data, gt = str(tmp_path / "seq_data.hdf5"), str(tmp_path / "seq_gt.hdf5")
    t = T0 + np.sort(rng.uniform(0, 0.35, n_ev))
    image_ts = T0 + np.arange(n_img) * 0.05 + 0.01
    with h5py.File(data, "w") as f:
        left = f.create_group("davis/left")
        left.create_dataset("events", data=np.stack(
            [rng.integers(0, w, n_ev), rng.integers(0, h, n_ev), t, rng.choice([-1, 1], n_ev)], 1).astype(np.float64),
            chunks=(1000, 4), compression="gzip")
        left.create_dataset("image_raw_event_inds", data=np.searchsorted(t, image_ts))
        left.create_dataset("image_raw_ts", data=image_ts)
    with h5py.File(gt, "w") as f:
        left = f.create_group("davis/left")
        left.create_dataset("flow_dist", data=(rng.standard_normal((9, 2, h, w)) * 2).round(1))
        left.create_dataset("flow_dist_ts", data=T0 + np.arange(9) * 0.045)
    jax_enc = _jax_encoder()
    for dt in (1, 4):
        ours, theirs = str(tmp_path / f"ours{dt}"), str(tmp_path / f"theirs{dt}")
        mvsec_encoder.main(["--data", data, "--gt", gt, "--out", ours, "-dt", str(dt)])
        jax_enc.encode_events(data, os.path.join(theirs, "event"), dt)
        jax_enc.encode_flowgt(data, gt, os.path.join(theirs, f"flowgt_dt{dt}"), dt)
        for sub in ("event", f"flowgt_dt{dt}"):
            names = sorted(os.listdir(os.path.join(theirs, sub)))
            assert names and names == sorted(os.listdir(os.path.join(ours, sub)))
            for name in names:
                a, b = os.path.join(ours, sub, name), os.path.join(theirs, sub, name)
                read = read_events_h5 if sub == "event" else np.load
                np.testing.assert_array_equal(read(a), read(b))
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(SystemExit, match="h5py"):
        mvsec_encoder.main(["--data", data, "--out", str(tmp_path / "x"), "--only_event"])


# --- the CLI ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tester():
    """JAX's ``Tester`` with the golden EEMFlow weights, its forward compiled
    once for the 256x256 crop at a low optimisation level."""
    sd = {k: v for k, v in load_torch_checkpoint(CKPT).items() if k != "index"}
    variables = convert_for_model("eemflow", sd)
    tester = JaxTester(jax_eval_model("eemflow"), variables)
    x = np.zeros((1, 256, 256, 5), np.float32)
    tester._fwd = tester._fwd.lower(variables, {"event_volume_old": x, "event_volume_new": x}).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return tester


def _cli(root, out, *extra, seq="indoor_flying1", dt="dt1"):
    res = mvsec_cli(["-model", "eemflow", "-int", dt, "--sequence", seq, "--data_root", root,
                      "--checkpoint", CKPT, "--frames", "3", "5", "--stride", "1", "--save_dir", str(out),
                      "--save_csv", "--device", "cpu", *extra])
    with open(os.path.join(str(out), f"eemflow_{dt}_{seq}", "test_epe_per_sample.csv")) as f:
        rows = f.read().split()[1:]
    return res, np.array([float(r.split(",")[1]) for r in rows])


@pytest.mark.parametrize("dt,seq,eval_type", [
    ("dt1", "indoor_flying1", "dense"), ("dt1", "outdoor_day1", "sparse"), ("dt4", "indoor_flying1", "dense")])
def test_cli_matches_jax_tester(full_root, jax_tester, tmp_path, dt, seq, eval_type):
    res, epe = _cli(full_root, tmp_path, "--eval_type", eval_type, seq=seq, dt=dt)
    cls = jax_mvsec.MvsecEventFlow if dt == "dt1" else jax_mvsec.MvsecEventFlow_dt4
    old = jax_mvsec.VALID_TIME_INDEX[seq]
    jax_mvsec.VALID_TIME_INDEX[seq] = [(3, 5)]
    try:
        ds = cls(full_root, seq, train=False, eval_type=eval_type)
        jax_tester.is_car = "outdoor" in seq
        jax_tester.save_path, jax_tester.save_csv = str(tmp_path / "jax"), True
        theirs = jax_tester.test_sequence(ds)
    finally:
        jax_mvsec.VALID_TIME_INDEX[seq] = old
    with open(tmp_path / "jax" / "test_epe_per_sample.csv") as f:
        jax_epe = np.array([float(r.split(",")[1]) for r in f.read().split()[1:]])
    assert res["n_samples"] == theirs["n_samples"] == 2
    np.testing.assert_allclose(epe, jax_epe, rtol=0, atol=1e-4)
    assert abs(res["AEE"] - theirs["AEE"]) < 1e-4


def test_cli_device_voxelize_and_batch_match_host(full_root, tmp_path):
    for dt in ("dt1", "dt4"):
        host, host_epe = _cli(full_root, tmp_path / f"host{dt}", dt=dt)
        for name, extra in (("dev", ("--device_voxelize",)), ("dev_b2", ("--device_voxelize", "--eval_batch", "2")),
                            ("b2", ("--eval_batch", "2"))):
            _, epe = _cli(full_root, tmp_path / f"{name}{dt}", *extra, dt=dt)
            np.testing.assert_allclose(epe, host_epe, rtol=0, atol=1e-5, err_msg=f"{dt} {name}")


def test_cli_refusals_and_frames_override(full_root, tmp_path):
    before = {k: list(v) for k, v in port_mvsec.VALID_TIME_INDEX.items()}
    # a research mode runs (it refused before the research testers were ported)
    assert mvsec_cli(["-model", "eemflow", "--sequence", "indoor_flying1", "--data_root", full_root, "--checkpoint",
                      CKPT, "--frames", "3", "5", "--stride", "1", "--save_dir", str(tmp_path), "--device", "cpu",
                      "--mode", "warp", "--max_samples", "1"]) == 1
    assert os.path.exists(tmp_path / "eemflow_dt1_indoor_flying1" / "warp" / "000000_ev2_warped.png")
    with pytest.raises(SystemExit, match="item 6"):
        _cli(full_root, tmp_path, "--shard_eval")
    res, _ = _cli(full_root, tmp_path, "--max_samples", "1")
    assert res["n_samples"] == 1 and port_mvsec.VALID_TIME_INDEX == before
