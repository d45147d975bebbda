"""The port's serving path on the CPU: its C++ event packer and host
voxelizer against the JAX package's (``eemflow_tpu.native``), and its
serving CLI (``eemflow_tpu_torch.tools.serve``, called in process) against
one jitted JAX forward per sample on the same packed events, at 128×192
with the golden EEMFlow checkpoint.

Tolerances: the packer bitwise (both cast the same float64 arithmetic to
float32 once); the host voxelizer 1e-6 (both accumulate cells in float32
in event order and normalize in float64: the same operations, so any
difference is the last bit of a float32); a served ``.flo`` 1e-4 absolute
against JAX's forward (the JAX CLI's own limit, ``tests/test_serve_cli.py``:
float32 in another summation order through the pyramid, the correlation
and the decoders), in pair mode, ``--stream``, the ``--loops`` wrap
re-prime, ``--chunk`` (2, and 8: a whole stream in one chunk), ``--batch
2 --stream``, ``--host_voxelize`` (also with ``--stream --batch 2 --chunk
4``, whose grids outnumber the host voxelizer's first ring);
``--bf16`` against float32 within 2% relative L2 of the flow (bf16 keeps 8
bits of mantissa: each conv rounds its inputs and weights by up to 2^-9
relative, and ~25 such roundings through the pyramid and the decoders
leave the flow a few tenths of a percent off; 0.23% on this fixture);
``-model eraft`` against ``Tester``'s flow on the same inputs, 1e-5 (the
same functions on the same tensors)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eemflow_tpu import native as jax_native
from eemflow_tpu.compat.torch_loader import convert_for_model
from eemflow_tpu.compat.torch_loader import load_torch_checkpoint as jax_load_torch_checkpoint
from eemflow_tpu.data.device_input import make_device_preprocess as jax_make_device_preprocess
from eemflow_tpu.models import get_eval_model as jax_get_eval_model

from eemflow_tpu_torch import native
from eemflow_tpu_torch.data.staging import Staging
from eemflow_tpu_torch.events.io import read_flo
from eemflow_tpu_torch.tools.serve import main as serve

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "fixtures", "eemflow_hrem_golden.pth.tar")
ERAFT_CKPT = os.path.join(HERE, "fixtures", "eraft_hrem_golden.pth.tar")
H, W, BUCKET, BINS = 128, 192, 8192, 5
N_EVENTS = 5000
FLO_TOL = 1e-4
VOX_TOL = 1e-6
BF16_REL_L2 = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _columns(rng, n, h=64, w=96, sorted_t=True):
    t = rng.integers(0, 10**9, n)
    return {
        "t": (np.sort(t) if sorted_t else t).astype(np.int64),
        "x": rng.integers(0, w, n).astype(np.int16),
        "y": rng.integers(0, h, n).astype(np.int16),
        "p": rng.integers(0, 2, n).astype(np.int8),
    }


def test_port_packer_is_native():
    assert native.have_native(), native.native_status()
    assert native.native_status().startswith("native: eemflow_tpu_torch/native/_build/")
    assert jax_native.have_native()


@pytest.mark.parametrize(
    "n,bucket,sorted_t",
    [(3000, 4096, True), (5000, 4096, True), (0, 64, True), (900, 1024, False)],
    ids=["padded", "overflow", "empty", "unsorted"],
)
def test_decode_pack_npz_bitwise_against_jax(n, bucket, sorted_t):
    d = _columns(np.random.default_rng(n), n, sorted_t=sorted_t)
    got, nv, dropped = native.decode_pack_npz(d, bucket)
    ref, nv_ref, dropped_ref = jax_native.decode_pack_npz(d, bucket)
    assert (nv, dropped) == (nv_ref, dropped_ref) == (min(n, bucket), max(0, n - bucket))
    assert got.dtype == np.float32 and got.shape == (bucket, 4)
    np.testing.assert_array_equal(got, ref)
    if n == 0:
        assert not got.any()


def test_decode_pack_arrays_writes_into_out():
    d = _columns(np.random.default_rng(7), 2000)
    out = np.full((2048, 4), 7.0, np.float32)
    got, nv, _ = native.decode_pack_arrays(d["t"], d["x"], d["y"], d["p"], 2048, out=out)
    ref, nv_ref, _ = jax_native.decode_pack_arrays(d["t"], d["x"], d["y"], d["p"], 2048)
    assert got is out and nv == nv_ref
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.decode_pack_arrays(d["t"], d["x"], d["y"], d["p"], 2048, out=np.zeros((2048, 3), np.float32))


@pytest.mark.parametrize("map_zero", [False, True], ids=["pm1", "zero_one"])
def test_decode_pack_features_bitwise_against_jax(map_zero):
    rng = np.random.default_rng(3)
    n = 800
    pol = rng.integers(0, 2, n).astype(np.float64) if map_zero else rng.choice([-1.0, 1.0], n)
    feats = np.stack([np.sort(rng.uniform(0, 0.04, n)), rng.integers(0, 96, n), rng.integers(0, 64, n), pol], 1)
    got = native.decode_pack_features(feats, 1024, map_zero_polarity=map_zero)
    ref = jax_native.decode_pack_features(feats, 1024, map_zero_polarity=map_zero)
    assert got[1:] == ref[1:]
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
def test_host_voxelizer_against_jax_with_ring_reuse(nhwc):
    """Five inputs twice through a 2-slot ring: every grid against the JAX
    voxelizer's, computed fresh; zero events give an all-zero grid."""
    rng = np.random.default_rng(12)
    h, w = 64, 80
    ours = native.HostVoxelizer(BINS, h, w, ring=2, nhwc=nhwc)
    ref = jax_native.HostVoxelizer(BINS, h, w, ring=2, nhwc=nhwc)
    inputs = []
    for i in range(5):
        d = _columns(rng, 500 + 97 * i, h, w)
        inputs.append(native.decode_pack_arrays(d["t"], d["x"], d["y"], d["p"], 2048)[:2])
    for rows, nv in inputs * 2:
        got = ours(rows, nv)
        assert got.shape == ((h, w, BINS) if nhwc else (BINS, h, w))
        np.testing.assert_allclose(got, ref(rows, nv), rtol=0, atol=VOX_TOL)
    g0 = ours(np.zeros((8, 4), np.float32), 0)
    assert np.isfinite(g0).all() and not g0.any()


def test_staging_hands_a_buffer_out_again_only_after_its_upload():
    """On the CPU: a kept buffer may be claimed again only after its
    upload, which copies it, so that its owner may refill it at once; the
    host voxelizer grows its ring rather than overwrite a grid not yet
    uploaded; a taken buffer or a plain array passes through."""
    st = Staging(torch.device("cpu"))
    a = st.buffer((4,))
    assert not a.any() and st.claim(a)
    a[:] = 1.0
    assert not st.claim(a)  # handed out, not uploaded yet
    up = st.upload(a)
    assert st.claim(a) and up.tolist() == [1.0] * 4
    a[:] = 2.0
    assert up.tolist() == [1.0] * 4

    h, w = 16, 24
    vox = native.HostVoxelizer(BINS, h, w, ring=2, alloc=st.buffer, claim=st.claim)
    ref = jax_native.HostVoxelizer(BINS, h, w, ring=8)
    rng = np.random.default_rng(5)
    inputs = []
    for i in range(4):
        d = _columns(rng, 300 + 50 * i, h, w)
        inputs.append(native.decode_pack_arrays(d["t"], d["x"], d["y"], d["p"], 512)[:2])
    grids = [vox(rows, nv) for rows, nv in inputs]  # none uploaded: four distinct grids
    assert len({g.ctypes.data for g in grids}) == 4
    for g, (rows, nv) in zip(grids, inputs):
        np.testing.assert_allclose(st.upload(g).numpy(), ref(rows, nv), rtol=0, atol=VOX_TOL)
    again = vox(*inputs[0])  # every grid uploaded: the ring is reused
    assert any(again.ctypes.data == g.ctypes.data for g in grids)
    np.testing.assert_allclose(again, ref(*inputs[0]), rtol=0, atol=VOX_TOL)

    t = st.take((3,))
    t[:] = 4.0
    plain = np.arange(3, dtype=np.float32)
    assert st.upload(t).tolist() == [4.0] * 3 and st.upload(plain).tolist() == [0.0, 1.0, 2.0]
    assert st.fetch(torch.ones(2)).numpy().tolist() == [1.0, 1.0]


N_SAMPLES = 8


def _stream_fixture(base, n_windows=N_SAMPLES + 1):
    """A consecutive dt1 stream at 128×192: sample i = (window i, window
    i+1), so sample i's events2 is sample i+1's events1."""
    rng = np.random.default_rng(23)
    windows = [_columns(rng, N_EVENTS, H, W) for _ in range(n_windows)]
    for i in range(n_windows - 1):
        d = os.path.join(base, f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "events1.npz"), **windows[i])
        np.savez(os.path.join(d, "events2.npz"), **windows[i + 1])
    return sorted(os.listdir(base))


@pytest.fixture(scope="module")
def stream_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_stream"))
    names = _stream_fixture(root)
    return root, names


def _low_opt(fn, *args):
    """``fn`` jitted and compiled at LLVM optimization level 0 (the compile
    is the fixture's cost; results move in float32's last digits)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module")
def jax_flows(stream_root):
    """The JAX package's flow of every sample: its packer, its device
    voxelize and its forward, jitted once; and its forward on its host
    voxelizer's grids."""
    root, names = stream_root
    sd = {k: v for k, v in jax_load_torch_checkpoint(CKPT).items() if k != "index"}
    variables = convert_for_model("eemflow", sd)
    model = jax_get_eval_model("eemflow")
    pre = jax_make_device_preprocess(BINS, H, W)

    def pair(v, e1, e2, n1, n2):
        b = pre({"events_old": e1, "events_new": e2, "n_old": n1, "n_new": n2})
        return model.apply(v, b["event_volume_old"], b["event_volume_new"])[1][-1]

    def vols(v, a, b):
        return model.apply(v, a, b)[1][-1]

    ev = jnp.zeros((1, BUCKET, 4), jnp.float32)
    n = jnp.zeros((1,), jnp.int32)
    vol = jnp.zeros((1, H, W, BINS), jnp.float32)
    pair_c = _low_opt(pair, variables, ev, ev, n, n)
    vols_c = _low_opt(vols, variables, vol, vol)
    hvox = jax_native.HostVoxelizer(BINS, H, W, nhwc=True)
    out = {"pair": {}, "hostvox": {}}
    for name in names:
        packed, grids = [], []
        for f in ("events1.npz", "events2.npz"):
            with np.load(os.path.join(root, name, f)) as npz:
                rows, nv, _ = jax_native.decode_pack_npz(npz, BUCKET)
            packed.append((rows, nv))
            grids.append(hvox(rows, nv).copy())
        (r1, n1), (r2, n2) = packed
        out["pair"][name] = np.asarray(pair_c(variables, jnp.asarray(r1)[None], jnp.asarray(r2)[None],
                                              jnp.asarray([n1], jnp.int32), jnp.asarray([n2], jnp.int32))[0])
        out["hostvox"][name] = np.asarray(vols_c(variables, jnp.asarray(grids[0])[None],
                                                 jnp.asarray(grids[1])[None])[0])
    return out


def _serve(root, out_dir, *extra, model="eemflow", ckpt=CKPT):
    res = serve([
        "-model", model, "--checkpoint", ckpt, "--data_root", root, "--size", str(H), str(W),
        "--bucket_size", str(BUCKET), "--warmup", "0", "--out_dir", str(out_dir), "--device", "cpu", *extra,
    ])
    flows = {f[: -len(".flo")]: read_flo(os.path.join(str(out_dir), f)) for f in sorted(os.listdir(str(out_dir)))}
    return res, flows


@pytest.mark.parametrize(
    "extra,frames,want",
    [
        ((), N_SAMPLES, "pair"),
        (("--stream",), N_SAMPLES, "pair"),
        (("--stream", "--loops", "2"), 2 * N_SAMPLES, "pair"),
        (("--stream", "--chunk", "2"), N_SAMPLES, "pair"),
        (("--stream", "--batch", "2"), N_SAMPLES, "pair"),
        (("--host_voxelize",), N_SAMPLES, "hostvox"),
        (("--host_voxelize", "--stream", "--batch", "2", "--chunk", "4"), N_SAMPLES, "hostvox"),
        (("--stream", "--chunk", str(N_SAMPLES)), N_SAMPLES, "pair"),
    ],
    ids=["pair", "stream", "stream_loops_wrap", "stream_chunk2", "stream_batch2", "host_voxelize",
         "host_voxelize_stream_batch2", "stream_decoded_in_line"],
)
def test_served_flo_matches_jax_forward(stream_root, jax_flows, tmp_path, extra, frames, want):
    """Every served ``.flo`` against JAX's forward of the same sample.  With
    ``--loops 2`` the second loop overwrites the first's files: they are
    right only if the wrap re-primed the carried grid.  Every mode but
    ``--host_voxelize`` decodes in line; ``--chunk 8`` packs nine frames
    into pinned buffers before their first upload, and the host voxelizer's
    ring grows past its first two grids for the ten of ``--batch 2 --chunk
    4``: neither may wait for a buffer."""
    root, names = stream_root
    res, flows = _serve(root, tmp_path, *extra)
    assert res["frames"] == frames and res["packer"].startswith("native") and res["fps"] > 0
    assert sorted(flows) == names
    for name, flow in flows.items():
        assert flow.shape == (H, W, 2)
        np.testing.assert_allclose(flow, jax_flows[want][name], rtol=0, atol=FLO_TOL, err_msg=name)


def test_bf16_serving_near_float32(stream_root, tmp_path):
    root, _ = stream_root
    _, f32 = _serve(root, tmp_path / "f32")
    _, b16 = _serve(root, tmp_path / "b16", "--bf16")
    a = np.stack([f32[k] for k in sorted(f32)])
    b = np.stack([b16[k] for k in sorted(b16)])
    rel = np.linalg.norm(b - a) / np.linalg.norm(a)
    assert np.isfinite(b).all() and 0 < rel < BF16_REL_L2, rel


def test_serve_eraft_matches_tester(stream_root, tmp_path):
    """``-model eraft`` (the module path) against ``Tester.run_sample`` on
    the same packed events, device-voxelize preprocess and weights."""
    from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.eval.runner import Tester
    from eemflow_tpu_torch.models.registry import get_eval_model

    import shutil

    root, names = stream_root
    sub = os.path.join(str(tmp_path), "two")
    for name in names[:2]:
        shutil.copytree(os.path.join(root, name), os.path.join(sub, name))
    res, flows = _serve(sub, tmp_path / "out", model="eraft", ckpt=ERAFT_CKPT)
    model = get_eval_model("eraft")
    load_model_checkpoint(model, ERAFT_CKPT, "eraft")
    tester = Tester(model, torch.device("cpu"), preprocess=make_device_preprocess(BINS, H, W))
    for name in names[:2]:
        sample = {}
        for key, f in (("old", "events1.npz"), ("new", "events2.npz")):
            with np.load(os.path.join(root, name, f)) as npz:
                rows, nv, _ = native.decode_pack_npz(npz, BUCKET)
            sample[f"events_{key}"], sample[f"n_{key}"] = rows.copy(), np.int32(nv)
        np.testing.assert_allclose(flows[name], tester.run_sample(sample), rtol=0, atol=1e-5)
    assert res["frames"] == 2


@pytest.mark.parametrize(
    "extra,msg",
    [(("--chunk", "2"), "--stream lever"), (("--stream", "--chunk", "0"), ">= 1"),
     (("--stream", "--chunk", "3", "--loops", "2"), "mid-chunk")],
    ids=["chunk_without_stream", "chunk_below_1", "wrap_mid_chunk"],
)
def test_serve_refuses_bad_chunks(stream_root, tmp_path, extra, msg):
    root, _ = stream_root
    with pytest.raises(SystemExit, match=msg):
        _serve(root, tmp_path, *extra)
