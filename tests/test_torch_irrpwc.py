"""The port's IRR-PWC line (``models/irrpwc.py``, ``ops/warp.pwc_warp``)
against the JAX package's on the CPU: each part that carries a quirk alone
(``pwc_warp`` with its in-bounds mask, ``rescale_flow`` both ways,
``_unfold3x3``'s replicate edges, ``RefineKernel``'s softmax over 9 taps,
``OccUpsampleNetwork`` at a size that is not twice its input's); the whole
models ``irrpwc_occ``, ``pwcnet`` and ``pwcnet_occ_bi`` at 64×96 (every
level's size odd somewhere, so every resize branch runs) on JAX's own
initial weights carried across by ``irrpwc_state_dict_from_jax``, every
prediction and every occlusion map (``irrpwc`` and ``pwcnet_irr_occ_bi``
in ``tests/test_torch_train_irrpwc.py``, compiled with their train steps);
the other four variants' prediction counts and strict loads of JAX's
variables; both golden checkpoints loading strictly, and their MVSEC
golden AEEs through the port's ``test_mvsec``; the tools.

Limits: a part alone within 1e-5 of max(1, largest |output|) (float32, one
module); a model within 1e-4·max(1, largest |flow|), each occlusion map
within 1e-4·max(1, largest |map|) (PERF.md §2's zoo rows); the goldens
within 0.01."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eemflow_tpu.models.irrpwc as jirr
from eemflow_tpu.models import registry as jax_registry
from test_torch_gma import FIXTURES, GOLDEN_TOL, run_mvsec_golden
from test_torch_gma import golden_mvsec_root  # noqa: F401  (a fixture)

from eemflow_tpu_torch.compat.from_jax import irrpwc_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
from eemflow_tpu_torch.models import irrpwc as pirr
from eemflow_tpu_torch.models.registry import get_eval_model, get_model
from eemflow_tpu_torch.ops.warp import pwc_warp

FLOW_TOL = 1e-4
MODULE_TOL = 1e-5
LOW_OPT = {"xla_backend_optimization_level": 0}
SIZE = (64, 96)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|Δ| {err:.3e} of max(1, |out|) {scale:.3f}"
    return err


def jax_model(name):
    jax_registry._populate()
    return jax_registry.MODEL_REGISTRY[name]()


def seeded_variables(model, shape, seed, bias_std=0.01):
    """Variables of a JAX model of this line (shapes from ``eval_shape``)
    filled from a numpy seed: conv kernels normal with variance 2/fan_in
    (He, as flax's ``kaiming_in``), biases N(0, ``bias_std``²) so that a
    wrong mapping shows."""
    ev = jnp.zeros((1, *shape))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), ev, ev)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            kh, kw, cin, _ = s.shape
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / (kh * kw * cin))).astype(np.float32)
        return (rng.standard_normal(s.shape) * bias_std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def events(seed, h, w, batch=1, bins=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, h, w, bins)).astype(np.float32) for _ in range(2)]


def jax_init_and_outputs(model, ev1, ev2, seed):
    """The JAX model's own initial variables (flax's He-normal kernels, zero
    biases) and its (maps, preds) on them: ``init_with_output`` jitted at
    LLVM optimisation level 0, one trace where ``eval_shape`` and ``apply``
    would take two."""
    args = (jax.random.PRNGKey(seed), jnp.asarray(ev1), jnp.asarray(ev2))
    (maps, preds), variables = jax.jit(model.init_with_output).lower(*args).compile(compiler_options=LOW_OPT)(*args)
    return (jax.tree_util.tree_map(np.asarray, variables), jax.tree_util.tree_map(np.asarray, maps),
            np.stack([np.asarray(p) for p in preds]))


def port_outputs(model, ev1, ev2):
    with torch.no_grad():
        maps, preds = model(torch.from_numpy(ev1), torch.from_numpy(ev2))
    return [None if m is None else m.numpy() for m in maps], np.stack([p.numpy() for p in preds])


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# ------------------------------------------------------------------ parts


@pytest.mark.parametrize("grid", [(5, 7), (16, 24)], ids=["5x7", "16x24"])
def test_pwc_warp_and_rescale_match_jax(grid):
    """Flows of ±3 level pixels push samples past every edge, so the mask
    cuts; the scales are the level's against the 64×96 input's."""
    h, w = grid
    rng = np.random.default_rng(h)
    x = rng.standard_normal((2, h, w, 6)).astype(np.float32)
    flow = (rng.standard_normal((2, h, w, 2)) * 3 * 0.05 * SIZE[1] / w).astype(np.float32)
    want = np.asarray(jirr.pwc_warp(jnp.asarray(x), jnp.asarray(flow), *SIZE, 0.05))
    got = pwc_warp(torch.from_numpy(x), torch.from_numpy(flow), *SIZE, 0.05).numpy()
    assert (np.abs(want).sum(-1) == 0).mean() > 0.05  # the mask cuts
    close(got, want, MODULE_TOL)
    for to_local in (True, False):
        want = np.asarray(jirr.rescale_flow(jnp.asarray(flow), 0.05, SIZE[1], SIZE[0], to_local))
        got = pirr.rescale_flow(nchw(flow), 0.05, SIZE[1], SIZE[0], to_local).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)


def test_unfold3x3_replicates_the_edges_as_jax():
    x = np.random.default_rng(1).standard_normal((2, 4, 5, 1)).astype(np.float32)
    want = np.asarray(jirr._unfold3x3(jnp.asarray(x)))
    got = pirr.unfold3x3(nchw(x)).permute(0, 2, 3, 1, 4)[..., 0, :].numpy()
    np.testing.assert_array_equal(got, want)
    # the corner's neighbourhood repeats the edge pixels
    np.testing.assert_array_equal(got[0, 0, 0], x[0, [0, 0, 0, 0, 0, 0, 1, 1, 1], [0, 0, 1, 0, 0, 1, 0, 0, 1], 0])


def test_refine_kernel_matches_jax():
    rng = np.random.default_rng(2)
    target = rng.standard_normal((2, 9, 13, 2)).astype(np.float32)
    feat = rng.standard_normal((2, 9, 13, 7)).astype(np.float32)
    module = jirr.RefineKernel()
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(target), jnp.asarray(feat))
    variables = jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32), shapes)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(target), jnp.asarray(feat)))
    port = pirr.RefineKernel(7)
    port.load_state_dict(irrpwc_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(nchw(target), nchw(feat)).permute(0, 2, 3, 1).numpy()
    assert np.abs(want - target).max() > 0.1
    close(got, want, MODULE_TOL)


def test_occ_upsample_at_an_odd_size_matches_jax():
    """A 5×7 map guided at 11×13: nearest ×2 gives 10×14, then the bilinear
    (align_corners=False) branch resizes it."""
    rng = np.random.default_rng(3)
    occ = rng.standard_normal((2, 5, 7, 1)).astype(np.float32)
    x = rng.standard_normal((2, 11, 13, 10)).astype(np.float32)
    module = jirr.OccUpsampleNetwork()
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(occ), jnp.asarray(x))
    variables = jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(occ), jnp.asarray(x)))
    port = pirr.OccUpsampleNetwork(10)
    sd = irrpwc_state_dict_from_jax({"occ_shuffle_upsample": variables["params"]})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(nchw(occ), nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 11, 13, 1)
    close(got, want, MODULE_TOL)


# ---------------------------------------------------------- whole models

# irrpwc and pwcnet_irr_occ_bi: tests/test_torch_train_irrpwc.py, compiled with their train steps
PARITY = ("irrpwc_occ", "pwcnet", "pwcnet_occ_bi")


@pytest.mark.parametrize("name", PARITY)
def test_model_matches_jax(name):
    """Every prediction and every occlusion map at 64×96, B=1, on JAX's own
    initial weights (the biases' mapping is held by the golden AEEs and the
    parts' tests, whose biases are drawn nonzero)."""
    ev = events(80 + PARITY.index(name), *SIZE)
    variables, want_maps, want = jax_init_and_outputs(jax_model(name), *ev, seed=70 + PARITY.index(name))
    model = get_eval_model(name)
    model.load_state_dict(irrpwc_state_dict_from_jax(variables), strict=True)
    got_maps, got = port_outputs(model, *ev)
    assert want.shape[1:] == (1, *SIZE, 2) and np.abs(want).max() > 0.5
    assert got.shape == want.shape
    close(got, want, FLOW_TOL)
    for g, w in zip(got_maps, want_maps):
        assert (g is None) == (w is None)
        if w is not None:
            close(g, w, FLOW_TOL)


@pytest.mark.parametrize("name,n_preds,n_maps", [("pwcnet_bi", 5, 2), ("pwcnet_occ", 5, 1), ("pwcnet_irr_bi", 5, 2),
                                                 ("pwcnet_irr_occ", 5, 1)])
def test_flag_subsets_load_and_predict(name, n_preds, n_maps):
    """The other variants: JAX's variables convert and load strictly, and
    the forward gives the variant's predictions and maps."""
    variables = seeded_variables(jax_model(name), (*SIZE, 5), 60)
    model = get_eval_model(name)
    model.load_state_dict(irrpwc_state_dict_from_jax(variables), strict=True)
    maps, preds = port_outputs(model, *events(61, 32, 48))
    assert preds.shape == (n_preds, 1, 32, 48, 2) and np.isfinite(preds).all()
    occ = model.occ
    assert sum(m is not None for m in maps) == (n_maps if occ else 2)
    if occ:
        assert maps[0].shape == (1, 32, 48, 1)


# ------------------------------------------------- checkpoints and tools


@pytest.mark.parametrize("name", ["irrpwc", "pwcnet_irr_occ_bi"])
def test_golden_checkpoint_loads_strictly(name):
    model = get_eval_model(name)
    load_model_checkpoint(model, os.path.join(FIXTURES, f"{name}_mvsec_golden.pth.tar"), name)
    assert model.flow_estimators.conv1[0].in_channels == 81 + 32 + 2


@pytest.mark.parametrize("name", ["irrpwc", "pwcnet_irr_occ_bi"])
def test_mvsec_golden_aee(golden_mvsec_root, tmp_path, name):  # noqa: F811
    aee, want = run_mvsec_golden(golden_mvsec_root, tmp_path, name)
    assert abs(aee - want) < GOLDEN_TOL, f"{name} golden AEE {aee}, committed {want}"


def test_registry_presets_and_tools(tmp_path):
    """The presets bind their flags; ``time_eval`` and ``profile_model``
    take the line's names."""
    from eemflow_tpu_torch.tools.profile_model import main as profile_main
    from eemflow_tpu_torch.tools.time_eval import main as time_main

    m = get_model("pwcnet_irr_occ_bi")
    assert isinstance(m, pirr.PWCFamilyNet) and (m.irr, m.bi, m.occ) == (True, True, True)
    assert get_model("pwcnet_irr_occ_bi", n_first_channels=15).feature_pyramid_extractor.convs[0][0][0].in_channels == 15
    res = time_main(["-model", "irrpwc_occ", "--device", "cpu", "--size", "40", "56", "-bs", "1", "--reps", "1"])
    assert res["model"] == "irrpwc_occ" and res["ms_per_img"] > 0
    prof = profile_main(["-model", "irrpwc", "--device", "cpu", "--size", "40", "56", "--reps", "1",
                         "--logdir", str(tmp_path)])
    assert prof["model"] == "irrpwc" and prof["device_busy_share"] is None
