"""The port's GMFlow (``models/gmflow.py``) against the JAX package's on the
CPU: the parts that carry a quirk alone (the shifted-window mask, the
window split and merge, the per-window position embedding, both matching
softmaxes, the flow propagation with its key projected from the query, in
its global and local-window branches), the one-scale model (eval and
train mode) and the two-scale one (train mode, every prediction) at 64×96
on the same numpy-seeded weights carried across by
``gmflow_state_dict_from_jax``; the golden checkpoint loading strictly;
``test_hrem`` with the golden at a reduced sensor (host and device
voxelize); ``test_mvsec``, ``serve``, ``time_eval`` and ``profile_model``.

Limits.  A part alone: 1e-5 of max(1, largest |output|) (float32, one
module).  The one-scale model: 1e-4·max(1, largest |flow|), as the zoo's
rows (measured 2.5e-3 px on flows of 55 and 78 px).  The two-scale model's
float32 flows cannot meet that on either side, nor JAX's own oracle limit
of 5e-2 px (``tests/test_gmflow_model.py:74``): its second scale warps the
features by the first scale's flow, and six transformer layers and a sharp
local matching carry each float32 rounding on.  At these weights JAX's
float32 lies up to 0.100 px from its float64 run on flows of 65-80 px, the
port's 0.060, and the two 0.127 apart.  So the port runs in float64
against JAX in float64 (``jax.enable_x64``) within 1e-4·max(1, |flow|)
(measured 5.0e-4 px: the position embedding and the grids stay float32 on
both sides), and its float32 flows are held within max(5e-2 px, 2× JAX's
own float32 distance) of that float64 reference."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eemflow_tpu.models.gmflow as jgm
from test_torch_gma import events

from eemflow_tpu_torch.compat.from_jax import gmflow_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import drop_prefixes, gmflow_alias, load_model_checkpoint
from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint
from eemflow_tpu_torch.models import gmflow as pgm
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model
from eemflow_tpu_torch.tools.test_hrem import main as hrem_cli

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
GOLDEN_CKPT = os.path.join(FIXTURES, "gmflow_hrem_golden.pth.tar")
FLOW_TOL = 1e-4
MODULE_TOL = 1e-5
NOISE_FLOOR = 5e-2  # JAX's own oracle limit, tests/test_gmflow_model.py:74
LOW_OPT = {"xla_backend_optimization_level": 0}
TWO_SCALE = dict(num_scales=2, upsample_factor=4, attn_splits_list=(2, 2), corr_radius_list=(-1, 4),
                 prop_radius_list=(-1, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_transformer_variables(jax_model, shape, seed, *args):
    """Variables of a JAX GMFlow or FlowFormer (shapes from ``eval_shape``)
    filled from a numpy seed as flax initialises them: conv kernels normal
    with variance 2/fan_in (1/fan_in in a GRU), ``Dense`` kernels 1/fan_in,
    the latent tokens N(0, 1); and, so that a wrong mapping shows, biases
    N(0, 0.01²), every LayerNorm scale uniform in [0.8, 1.2] and the GMA
    gate ``gamma`` uniform in [0.5, 1.5] (flax's 0 would hide the
    aggregation)."""
    ev = jnp.zeros((1, *shape))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), ev, ev, *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            var = (1.0 if s.ndim == 2 or "gru" in keys else 2.0) / fan_in
            return (rng.standard_normal(s.shape) * np.sqrt(var)).astype(np.float32)
        if keys[-1] == "latent_tokens":
            return rng.standard_normal(s.shape).astype(np.float32)
        if keys[-1] == "gamma":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if keys[-1] == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.01).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|Δ| {err:.3e} of max(1, |out|) {scale:.3f}"
    return err


# ------------------------------------------------------------------ parts


@pytest.mark.parametrize("hw,splits", [((16, 24), 2), ((12, 20), 2), ((8, 12), 4)], ids=["16x24_2", "12x20_2", "8x12_4"])
def test_shift_mask_and_windows_match_jax(hw, splits):
    """The −100 mask on cross-region pairs of the half-window shift, and
    the window split and merge (merge undoes split)."""
    h, w = hw
    wh, ww = h // splits, w // splits
    want = np.asarray(jgm.shift_window_attn_mask(h, w, wh, ww, wh // 2, ww // 2))
    got = pgm.shift_window_attn_mask(h, w, wh, ww, wh // 2, ww // 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {-100.0, 0.0}
    x = np.random.default_rng(3).standard_normal((2, h, w, 6)).astype(np.float32)
    win = pgm.split_windows(torch.from_numpy(x), splits)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jgm.split_windows(jnp.asarray(x), splits)))
    np.testing.assert_array_equal(pgm.merge_windows(win, splits).numpy(), x)


@pytest.mark.parametrize("splits", [1, 2])
def test_position_embedding_matches_jax(splits):
    """The DETR sine embedding, made per window and tiled over the windows
    when ``splits > 1`` (JAX ``gmflow.py:401-414``)."""
    fh, fw, c = 12, 20, 128
    if splits > 1:
        one = jgm.position_embedding_sine(fh // splits, fw // splits, c // 2)
        want = jgm.merge_windows(jnp.tile(one[None], (splits * splits, 1, 1, 1)), splits)[0]
    else:
        want = jgm.position_embedding_sine(fh, fw, c // 2)
    got = pgm.GMFlow(feature_channels=c)._position(fh, fw, splits, torch.float32, torch.device("cpu"))
    close(got, want, MODULE_TOL)


@pytest.mark.parametrize("hw,radius", [((16, 24), -1), ((16, 24), 4), ((6, 7), 4)],
                         ids=["global_16x24", "local_r4_16x24", "local_r4_6x7"])
def test_matching_softmax_matches_jax(hw, radius):
    """Global matching, and local matching within the radius: the ÷C
    correlation multiplied back by C, then ÷√C, −1e9 outside the frame (a
    6×7 grid is narrower than the 9×9 window)."""
    rng = np.random.default_rng(5)
    f0, f1 = (rng.standard_normal((2, *hw, 128)).astype(np.float32) * 0.3 for _ in range(2))
    if radius < 0:
        want = jgm.global_correlation_softmax(jnp.asarray(f0), jnp.asarray(f1))
        got = pgm.global_correlation_softmax(torch.from_numpy(f0), torch.from_numpy(f1))
    else:
        want = jgm.local_correlation_softmax(jnp.asarray(f0), jnp.asarray(f1), radius)
        got = pgm.local_correlation_softmax(torch.from_numpy(f0), torch.from_numpy(f1), radius)
    assert 0.5 < float(np.abs(want).max())
    close(got, want, MODULE_TOL)


@pytest.mark.parametrize("radius", [-1, 1, 2], ids=["global", "local_r1", "local_r2"])
def test_flow_propagation_matches_jax(radius):
    """``FeatureFlowAttention``: the key projected from the projected query
    (reference ``transformer.py:380``), global or in a (2r+1)² window."""
    rng = np.random.default_rng(6)
    f0 = rng.standard_normal((2, 8, 12, 128)).astype(np.float32)
    flow = (rng.standard_normal((2, 8, 12, 2)) * 3).astype(np.float32)
    jm = jgm.FeatureFlowAttention(128)
    shapes = jax.eval_shape(lambda *a: jm.init(*a, radius), jax.random.PRNGKey(0), jnp.asarray(f0), jnp.asarray(flow))
    fill = lambda s: (rng.standard_normal(s.shape) * (0.15 if s.ndim == 2 else 0.1)).astype(np.float32)
    variables = jax.tree_util.tree_map(fill, shapes)
    want = jm.apply(variables, jnp.asarray(f0), jnp.asarray(flow), radius)
    port = pgm.FeatureFlowAttention(128)
    port.load_state_dict(gmflow_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(f0), torch.from_numpy(flow), radius)
    close(got, want, MODULE_TOL)


# ------------------------------------------------------------ whole model


def jax_apply(model, variables, ev1, ev2, train):
    f = jax.jit(model.apply, static_argnums=3).lower(variables, ev1, ev2, train)
    return np.stack([np.asarray(p) for p in f.compile(compiler_options=LOW_OPT)(variables, ev1, ev2)[1]])


def port_apply(cfg, variables, ev1, ev2, train, dtype=torch.float32):
    model = pgm.GMFlow(**cfg).eval()
    model.load_state_dict(gmflow_state_dict_from_jax(variables), strict=True)
    model.to(dtype)
    with torch.no_grad():
        return model(torch.from_numpy(ev1).to(dtype), torch.from_numpy(ev2).to(dtype), train=train)[1].numpy()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_one_scale_matches_jax(train):
    """The shipped configuration (``configs/mvsec_gmflow.json``: one scale,
    6 layers, splits 2, global matching and propagation) at 64×96: the
    final flow, and in train mode the matching's bilinear prediction
    before it."""
    jm = jgm.GMFlow()
    variables = seeded_transformer_variables(jm, (64, 96, 5), 61)
    ev1, ev2 = events(62, 64, 96)
    want = jax_apply(jm, variables, ev1, ev2, train)
    got = port_apply({}, variables, ev1, ev2, train)
    assert want.shape == (2 if train else 1, 1, 64, 96, 2) and 1.0 < np.abs(want).max()
    close(got, want, FLOW_TOL)


@pytest.fixture(scope="module")
def two_scale():
    jm = jgm.GMFlow(**TWO_SCALE)
    variables = seeded_transformer_variables(jm, (64, 96, 5), 63)
    ev1, ev2 = events(64, 64, 96)
    f32 = jax_apply(jm, variables, ev1, ev2, True)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        f64 = jax_apply(jm, v64, ev1.astype(np.float64), ev2.astype(np.float64), True)
    return variables, ev1, ev2, f32, f64


def test_two_scale_matches_jax_in_float64(two_scale):
    """Two scales (the trident conv, the warp by the first scale's flow,
    local matching at radius 4 and propagation at radius 1, upsample factor
    4; train mode, all four predictions), both sides in float64."""
    variables, ev1, ev2, _, f64 = two_scale
    got = port_apply(TWO_SCALE, variables, ev1.astype(np.float64), ev2.astype(np.float64), True, torch.float64)
    assert f64.shape == (4, 1, 64, 96, 2) and 1.0 < np.abs(f64).max()
    for i in range(4):
        close(got[i], f64[i], FLOW_TOL)


def test_two_scale_float32_is_as_close_to_float64_as_jax(two_scale):
    variables, ev1, ev2, f32, f64 = two_scale
    got = port_apply(TWO_SCALE, variables, ev1, ev2, True)
    for i in range(4):
        theirs = float(np.abs(f32[i] - f64[i]).max())
        ours = float(np.abs(got[i] - f64[i]).max())
        assert ours <= max(NOISE_FLOOR, 2 * theirs), f"prediction {i}: {ours:.4f} px from float64, JAX's {theirs:.4f}"


# ------------------------------------------------- checkpoints and CLIs


def test_golden_loads_strictly_and_the_alias_inverts_the_converter():
    """The released layout loads strictly (no keys dropped); each key,
    through the JAX spelling (``gmflow_alias``) and back through the
    converter's path map, is itself."""
    assert drop_prefixes("gmflow") == ()
    model = get_eval_model("gmflow")
    load_model_checkpoint(model, GOLDEN_CKPT, "gmflow")
    keys = load_torch_checkpoint(GOLDEN_CKPT)
    tree = {}
    for k, v in keys.items():
        mod, _, leaf = k.rpartition(".")
        node = tree
        for p in gmflow_alias(mod):
            node = node.setdefault(p, {})
        if leaf == "weight":  # a LayerNorm's scale, a Dense's [in, out] or a conv's HWIO kernel
            leaf, v = ("scale", v) if v.ndim == 1 else ("kernel", v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T)
        node[leaf] = v
    back = gmflow_state_dict_from_jax({"params": tree})
    assert set(back) == set(keys)
    for k, v in keys.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def small_hrem_split(base, h, w, seed=11, n_events=4000):
    """A synthetic HREM test split (``test/dt1/indoor_fast/<i>``) at an
    h×w sensor, one sample."""
    from eemflow_tpu_torch.events.io import write_flo

    rng = np.random.default_rng(seed)
    root = os.path.join(base, "hrem")
    d = os.path.join(root, "test", "dt1", "indoor_fast", "00000")
    os.makedirs(d)
    for name in ("events1.npz", "events2.npz"):
        np.savez(os.path.join(d, name), x=rng.integers(0, w, n_events).astype(np.int32),
                 y=rng.integers(0, h, n_events).astype(np.int32),
                 t=np.sort(rng.integers(0, 10**9, n_events)).astype(np.int64),
                 p=rng.integers(0, 2, n_events).astype(np.int8))
    write_flo((rng.standard_normal((h, w, 2)) * 2).astype(np.float32), os.path.join(d, "flow.flo"))
    return root


def run_hrem_small(tmp_path, monkeypatch, name, ckpt, sensor, extra=()):
    """``test_hrem -model <name>`` with a golden checkpoint on a shrunken
    sensor, on the host path and with ``--device_voxelize``: the two AEEs."""
    from eemflow_tpu_torch.data.hrem import HREMEventFlow

    monkeypatch.setattr(HREMEventFlow, "image_height", sensor[0])
    monkeypatch.setattr(HREMEventFlow, "image_width", sensor[1])
    root = small_hrem_split(str(tmp_path / "data"), *sensor)
    aees = []
    for i, flags in enumerate(((), ("--device_voxelize", "--bucket_size", "8192"))):
        out = tmp_path / f"out{i}"
        res = hrem_cli(["-model", name, "-int", "dt1", "--data_root", root, "--checkpoint", ckpt,
                        "--save_dir", str(out), "--save_csv", "--device", "cpu", *extra, *flags])
        with open(os.path.join(str(out), f"{name}_dt1", "test_epe_per_sample.csv")) as f:
            assert len(list(csv.DictReader(f))) == 1
        aees.append(res["mean"]["AEE"])
    assert np.isfinite(aees).all()
    return aees


def test_hrem_cli_with_the_golden_at_a_reduced_sensor(tmp_path, monkeypatch):
    """The golden AEE (88.363472) takes 38 s at 720×1280 on one CPU thread
    (measured 88.362770) and is checked on the card by ``chip_smoke.py``;
    here the golden weights at a 96×160 sensor, whose host and device
    voxelize paths agree within 1e-5."""
    host, dev = run_hrem_small(tmp_path, monkeypatch, "gmflow", GOLDEN_CKPT, (96, 160))
    assert abs(host - dev) < 1e-5


def test_mvsec_cli_takes_gmflow(tmp_path):
    """``test_mvsec -model gmflow`` with the golden weights on a synthetic
    MVSEC sequence (260×346, cropped to 256): finite, and device voxelize
    within 1e-6 of the host path's AEE, relative (the golden's sharp
    matching carries the voxel grids' float32 rounding on: 7e-7 measured)."""
    from test_torch_mvsec import make_mvsec_fixture

    from eemflow_tpu_torch.tools.test_mvsec import main as mvsec_cli

    root = make_mvsec_fixture(str(tmp_path / "data"), ("indoor_flying1",), h=260, w=346, n_events=3000, seed=65,
                              first=3, last=14)
    aees = []
    for flags in ((), ("--device_voxelize",)):
        res = mvsec_cli(["-model", "gmflow", "-int", "dt1", "--sequence", "indoor_flying1", "--data_root", root,
                         "--checkpoint", GOLDEN_CKPT, "--save_dir", str(tmp_path / "out"), "--frames", "3", "5",
                         "--stride", "1", "--max_samples", "1", "--device", "cpu", *flags])
        assert res["n_samples"] == 1
        aees.append(res["AEE"])
    assert np.isfinite(aees).all() and abs(aees[0] - aees[1]) <= 1e-6 * aees[0]


def test_serve_pair_mode_matches_the_eval_path(tmp_path):
    """``serve -model gmflow`` (pair mode, the golden weights, 128×192)
    against ``Tester``'s flow on the same packed events, 1e-4."""
    from test_torch_serve import BINS, BUCKET, H, W, _serve, _stream_fixture

    from eemflow_tpu_torch import native
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.eval.runner import Tester

    root = str(tmp_path / "stream")
    names = _stream_fixture(root, n_windows=3)
    res, flows = _serve(root, tmp_path / "out", model="gmflow", ckpt=GOLDEN_CKPT)
    model = get_eval_model("gmflow")
    load_model_checkpoint(model, GOLDEN_CKPT, "gmflow")
    tester = Tester(model, torch.device("cpu"), preprocess=make_device_preprocess(BINS, H, W))
    for name in names:
        sample = {}
        for key, f in (("old", "events1.npz"), ("new", "events2.npz")):
            with np.load(os.path.join(root, name, f)) as npz:
                rows, nv, _ = native.decode_pack_npz(npz, BUCKET)
            sample[f"events_{key}"], sample[f"n_{key}"] = rows.copy(), np.int32(nv)
        np.testing.assert_allclose(flows[name], tester.run_sample(sample), rtol=0, atol=1e-4)
    assert res["frames"] == len(names) == 2


def test_registry_and_tools(tmp_path):
    """The registry builds both scales' configurations in eval mode with no
    fused modes; ``time_eval`` and ``profile_model`` take the model."""
    from eemflow_tpu_torch.tools.profile_model import main as profile_main
    from eemflow_tpu_torch.tools.time_eval import main as time_main

    model = get_eval_model("gmflow")
    assert isinstance(model, pgm.GMFlow) and not model.training and fast_eval_kwargs("gmflow") == {}
    assert model.upsampler[2].out_channels == 64 * 9 and not hasattr(model.backbone, "trident_conv")
    two = get_eval_model("gmflow", **TWO_SCALE)
    assert two.backbone.trident_conv.weight.shape == (128, 128, 3, 3) and two.upsampler[2].out_channels == 16 * 9
    res = time_main(["-model", "gmflow", "--device", "cpu", "--size", "32", "32", "-bs", "1", "--reps", "1"])
    assert res["model"] == "gmflow" and res["ms_per_img"] > 0
    prof = profile_main(["-model", "gmflow", "--device", "cpu", "--size", "32", "32", "--reps", "1",
                         "--logdir", str(tmp_path)])
    assert prof["model"] == "gmflow" and prof["device_busy_share"] is None
