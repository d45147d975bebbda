"""The port's pictures and small file helpers against the JAX package's on
the CPU, on inputs drawn from a seeded numpy generator: the colour codes
(``viz.flow_viz``), the research visualizers (``viz.visualizer``), the DSEC
helpers (``data.dsec``), PFM files (``events.io``) and ``ImagePadder``
(``ops.pad``) give equal arrays (``flow_error_image`` within 1e-6); the
port's PNG writer (numpy and zlib) gives files that cv2 decodes to the
arrays written, and the DSEC submission file decodes as JAX's does.  Then
the CLIs that write pictures: ``train_hrem --viz`` and ``serve --viz``.
The JAX package writes JPEGs through cv2 where the port writes PNGs of the
same stem: the tests compare pixel arrays, not file bytes."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eemflow_tpu.data import dsec as jax_dsec
from eemflow_tpu.events import io as jax_io
from eemflow_tpu.ops.pad import ImagePadder as JaxImagePadder
from eemflow_tpu.viz import flow_viz as jax_flow_viz
from eemflow_tpu.viz import visualizer as jax_visualizer

from eemflow_tpu_torch.data import dsec
from eemflow_tpu_torch.data.hrem import HREMEventFlow
from eemflow_tpu_torch.events import io
from eemflow_tpu_torch.events.io import read_flo, write_flo
from eemflow_tpu_torch.ops.pad import ImagePadder
from eemflow_tpu_torch.viz import flow_viz, visualizer
from eemflow_tpu_torch.viz.png import read_png, write_png

H, W = 48, 80


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flow(seed=0, h=H, w=W, scale=4.0):
    """A seeded flow with a non-finite vector and a zero one."""
    f = (np.random.default_rng(seed).standard_normal((h, w, 2)) * scale).astype(np.float32)
    f[0, 0] = (np.inf, 1.0)
    f[1, 1] = (np.nan, 0.0)
    f[2, 2] = 0.0
    return f


def _events(seed=1, n=3000, h=H, w=W):
    rng = np.random.default_rng(seed)
    ev = np.stack([np.sort(rng.random(n)), rng.integers(-2, w + 2, n), rng.integers(-2, h + 2, n),
                   rng.choice([-1.0, 1.0], n)], axis=1)
    ev[:5, 3] = 0.0  # zero polarities: negative to both packages
    return ev


@pytest.mark.parametrize("max_flow", [None, 3.0], ids=["own_scale", "max_flow"])
def test_flow_to_image_equals_jax(max_flow):
    f = _flow()
    np.testing.assert_array_equal(flow_viz.flow_to_image(f, max_flow), jax_flow_viz.flow_to_image(f, max_flow))
    np.testing.assert_array_equal(flow_viz._make_colorwheel(), jax_flow_viz._make_colorwheel())


def test_visualize_optical_flow_equals_jax():
    f = _flow(seed=2)
    f[1, 1] = (0.0, 0.0)  # the HSV code keeps NaN out; inf becomes 0
    got = flow_viz.visualize_optical_flow(f)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, jax_flow_viz.visualize_optical_flow(f))


def test_events_to_event_image_equals_jax():
    ev = _events()
    np.testing.assert_array_equal(flow_viz.events_to_event_image(ev, H, W),
                                  jax_flow_viz.events_to_event_image(ev, H, W))


def test_events_overlay_image_equals_jax():
    rng = np.random.default_rng(3)
    ev = _events(seed=4)
    for bg in (None, rng.random((H, W)) * 7 - 2, rng.random((H, W, 3))):
        np.testing.assert_array_equal(visualizer.events_overlay_image(ev, H, W, bg),
                                      jax_visualizer.events_overlay_image(ev, H, W, bg))


def test_normalize_map_equals_jax():
    m = np.random.default_rng(5).standard_normal((H, W)) * 3
    np.testing.assert_array_equal(visualizer._normalize_map(m), jax_visualizer._normalize_map(m))


@pytest.mark.parametrize("log_colors", [True, False], ids=["log_colors", "linear"])
def test_flow_error_image_within_1e6(log_colors):
    rng = np.random.default_rng(6)
    gt = _flow(seed=7)
    gt[~np.isfinite(gt)] = 0.0
    pred = gt + rng.standard_normal(gt.shape).astype(np.float32) * rng.choice([0.01, 1.0, 30.0], gt.shape[:2])[..., None]
    occ = (rng.random((H, W, 1)) < 0.9).astype(np.float32)
    noc = (rng.random((H, W, 1)) < 0.8).astype(np.float32)
    got = visualizer.flow_error_image(pred, gt, occ, noc, log_colors)
    want = jax_visualizer.flow_error_image(pred, gt, occ, noc, log_colors)
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_flow_16bit_codec_equals_jax():
    f = _flow(seed=8, scale=100.0)
    f[~np.isfinite(f)] = 0.0
    f[3, 3] = (300.0, -300.0)  # beyond the code's range: clipped
    valid = np.random.default_rng(9).random((H, W)) < 0.7
    for v in (None, valid):
        enc = dsec.flow_to_16bit(f, v)
        np.testing.assert_array_equal(enc, jax_dsec.flow_to_16bit(f, v))
        for a, b in zip(dsec.flow_16bit_to_float(enc), jax_dsec.flow_16bit_to_float(enc)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["grey8", "bgr8", "bgr16"])
def test_png_decodes_with_cv2_to_the_array_written(tmp_path, kind):
    rng = np.random.default_rng(10)
    shape = (H, W) if kind == "grey8" else (H, W, 3)
    dtype = np.uint16 if kind == "bgr16" else np.uint8
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / f"{kind}.png")
    write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(read_png(path), img)
    cv2.imwrite(str(tmp_path / "cv2.png"), img)  # cv2's file (filtered rows) is not what the reader takes
    with pytest.raises(ValueError, match="filter"):
        read_png(str(tmp_path / "cv2.png"))


def test_dsec_submission_file_decodes_as_jaxs(tmp_path):
    f = _flow(seed=11, scale=50.0)
    f[~np.isfinite(f)] = 0.0
    ours, theirs = str(tmp_path / "sub" / "port.png"), str(tmp_path / "sub" / "jax.png")
    dsec.write_flow_submission(f, ours)
    jax_dsec.write_flow_submission(f, theirs)
    got = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, cv2.imread(theirs, cv2.IMREAD_UNCHANGED))
    flow, valid = dsec.flow_16bit_to_float(read_png(ours)[..., ::-1])
    assert valid.all() and np.abs(flow - f).max() <= 1 / 128


def test_dsec_voxel_grid_equals_jax():
    ev = _events(seed=12)
    ev = ev[(ev[:, 1] >= 0) & (ev[:, 2] >= 0)]
    for normalize in (True, False):
        got = dsec.DSECVoxelGrid(5, H, W, normalize)(ev)
        np.testing.assert_array_equal(got, jax_dsec.DSECVoxelGrid(5, H, W, normalize)(ev))


@pytest.mark.parametrize("channels", [1, 3])
def test_pfm_read_and_written_by_both(tmp_path, channels):
    shape = (H, W) if channels == 1 else (H, W, 3)
    img = np.random.default_rng(13).standard_normal(shape).astype(np.float32)
    io.write_pfm(img, str(tmp_path / "port.pfm"), scale=2.0)
    jax_io.write_pfm(img, str(tmp_path / "jax.pfm"), scale=2.0)
    for path in ("port.pfm", "jax.pfm"):
        for reader in (io.read_pfm, jax_io.read_pfm):
            np.testing.assert_array_equal(reader(str(tmp_path / path)), img)
    with open(tmp_path / "port.pfm", "rb") as a, open(tmp_path / "jax.pfm", "rb") as b:
        assert a.read() == b.read()


def test_read_flow_any_on_flo_and_pfm(tmp_path):
    rng = np.random.default_rng(14)
    flow = rng.standard_normal((H, W, 2)).astype(np.float32)
    write_flo(flow, str(tmp_path / "a.flo"))
    pfm3 = np.concatenate([flow, rng.standard_normal((H, W, 1)).astype(np.float32)], axis=2)
    io.write_pfm(pfm3, str(tmp_path / "b.pfm"))
    for name, want in (("a.flo", flow), ("b.pfm", flow)):
        got = io.read_flow_any(str(tmp_path / name))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_io.read_flow_any(str(tmp_path / name)))


def test_image_padder_equals_jax():
    img = np.random.default_rng(15).standard_normal((2, 37, 70, 3)).astype(np.float32)
    ours, theirs = ImagePadder(min_size=16), JaxImagePadder(min_size=16)
    padded = ours.pad(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(padded, np.asarray(theirs.pad(jnp.asarray(img))))
    assert padded.shape == (2, 48, 80, 3) and (ours.pad_height, ours.pad_width) == (11, 10)
    np.testing.assert_array_equal(ours.unpad(torch.from_numpy(padded)).numpy(), img)
    np.testing.assert_array_equal(ours.unpad(torch.from_numpy(padded)).numpy(),
                                  np.asarray(theirs.unpad(jnp.asarray(padded))))


def test_create_gif_on_jaxs_contract(tmp_path):
    frames = [np.full((8, 8, 3), v, np.uint8) for v in (0, 128, 255)]
    path = str(tmp_path / "t.gif")
    assert visualizer.create_gif(frames, path) == jax_visualizer.create_gif(frames, str(tmp_path / "j.gif"))
    assert os.path.getsize(path) > 0


def test_flow_visualizer_events_writes_jaxs_pictures(tmp_path, monkeypatch):
    """Every picture of a visualized sample: the same stems and pixels as
    the JAX visualizer's (its writes captured before cv2's JPEG)."""
    rng = np.random.default_rng(16)
    gt = _flow(seed=17)
    gt[~np.isfinite(gt)] = 0.0
    est = gt + rng.standard_normal(gt.shape).astype(np.float32)
    valid = (rng.random((H, W)) < 0.8).astype(np.float32)
    image = rng.random((H, W))
    theirs = {}
    monkeypatch.setattr(jax_visualizer, "_imwrite", lambda p, img: theirs.__setitem__(os.path.basename(p), img))
    jax_visualizer.FlowVisualizerEvents(str(tmp_path / "jax")).visualize_sample(
        7, flow_gt=gt, flow_est=est, valid=valid, events=_events(seed=18), image=image)
    visualizer.FlowVisualizerEvents(str(tmp_path / "port")).visualize_sample(
        7, flow_gt=gt, flow_est=est, valid=valid, events=_events(seed=18), image=image)
    ours = sorted(os.listdir(tmp_path / "port"))
    assert [n[: -len(".png")] for n in ours] == sorted(n[: -len(".jpg")] for n in theirs) and len(ours) == 5
    for name in ours:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED),
                                      theirs[name[: -len(".png")] + ".jpg"], err_msg=name)


def _train_split(base, n_samples=2, h=64, w=128, n_events=3000):
    rng = np.random.default_rng(19)
    root = os.path.join(base, "hrem")
    for i in range(n_samples):
        d = os.path.join(root, "train", "dt1", f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        for name in ("events1.npz", "events2.npz"):
            np.savez(os.path.join(d, name), x=rng.integers(0, w, n_events).astype(np.int32),
                     y=rng.integers(0, h, n_events).astype(np.int32),
                     t=np.sort(rng.integers(0, 10**9, n_events)).astype(np.int64),
                     p=rng.integers(0, 2, n_events).astype(np.int8))
        write_flo((rng.standard_normal((h, w, 2)) * 2).astype(np.float32), os.path.join(d, "flow.flo"))
    return root


@pytest.mark.parametrize("extra", [(), ("--full_res_flow", "--device_voxelize")], ids=["meshflow", "full_res"])
def test_train_hrem_viz_writes_its_pictures(tmp_path, monkeypatch, extra):
    """``train_hrem --viz`` (every step here, as ``viz_every=1``): each
    step's ground truth, estimate and input maps; the masked estimate and
    the error map where the estimate and the label share a grid (not
    against the 16×16 meshflow label)."""
    import eemflow_tpu_torch.tools.train_hrem as train_hrem
    from eemflow_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(HREMEventFlow, "image_height", 64)
    monkeypatch.setattr(HREMEventFlow, "image_width", 128)
    monkeypatch.setattr(train_hrem, "Trainer", lambda **kw: Trainer(viz_every=1, **kw))
    root = _train_split(str(tmp_path))
    save = tmp_path / "runs"
    state = train_hrem.main(["-model", "eemflow", "--data_root", root, "--config", "configs/hrem_meshflow.json",
                             "-bs", "1", "--train_iters", "2", "--val_iters", "2", "--save_dir", str(save),
                             "--viz", "--device", "cpu", *extra])
    assert state.step == 2 and state.model.training
    viz_dir = save / os.listdir(save)[0] / "viz"
    names = sorted(os.listdir(viz_dir))
    tags = ["flow_gt", "flow_est", "map1", "map2"] + (["flow_est_masked", "error"] if extra else [])
    assert names == sorted(f"{i}_{t}.png" for i in (1, 2) for t in tags), names
    # the estimate at the input's grid; the label there or at the 16x16 mesh
    assert read_png(str(viz_dir / "1_flow_est.png")).shape == (64, 128, 3)
    assert read_png(str(viz_dir / "1_flow_gt.png")).shape == ((64, 128, 3) if extra else (16, 16, 3))
    assert read_png(str(viz_dir / "2_map1.png")).shape == (64, 128, 3)


def test_serve_viz_writes_a_png_beside_each_flo(tmp_path):
    """``serve --viz --out_dir``: ``<sample>.png`` beside each ``<sample>.flo``,
    the colour-wheel picture of that flow."""
    from eemflow_tpu_torch.tools.serve import main as serve

    rng = np.random.default_rng(20)
    root = tmp_path / "stream"
    for i in range(2):
        d = root / f"{i:05d}"
        d.mkdir(parents=True)
        for name in ("events1.npz", "events2.npz"):
            n = 2000
            np.savez(str(d / name), x=rng.integers(0, 96, n).astype(np.int32), y=rng.integers(0, 64, n).astype(np.int32),
                     t=np.sort(rng.integers(0, 10**9, n)).astype(np.int64), p=rng.integers(0, 2, n).astype(np.int8))
    out = tmp_path / "out"
    serve(["--data_root", str(root), "--size", "64", "96", "--bucket_size", "4096", "--warmup", "0",
           "--out_dir", str(out), "--viz", "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert names == ["00000.flo", "00000.png", "00001.flo", "00001.png"]
    for stem in ("00000", "00001"):
        flow = read_flo(str(out / f"{stem}.flo"))
        np.testing.assert_array_equal(read_png(str(out / f"{stem}.png")), flow_viz.flow_to_image(flow)[:, :, ::-1])
