"""The port's FlowNet line (``models/flownet1s.py``, ``layers.Deconv``,
``ops/warp.flownet_warp``) against the JAX package's on the CPU: each part
that carries a quirk alone (``flownet_warp``'s ÷W scale without a mask,
the transposed conv's kernel layout, ``_adaptive_avg_pool`` against
torch's ``adaptive_avg_pool2d`` cells, ``_cat_as``'s lexicographic branch
choice); the whole models ``flownet1s`` and ``flownet1s_irr_occ_bi``
(``num_iters`` 2) at 64×96 (the decoder's 1×2 → 2×4 deconv pooled onto
conv5's 2×3 grid) on JAX's own initial weights carried across by
``flownet1s_state_dict_from_jax``, every prediction and every occlusion
map (``irr_flownet`` in ``tests/test_torch_train_irrpwc.py``, compiled
with its train step); the other three variants' prediction counts and
strict loads of JAX's variables; the tools.

Limits as ``tests/test_torch_irrpwc.py``'s: a part alone within 1e-5 of
max(1, largest |output|), a model within 1e-4·max(1, largest |flow|) and
each occlusion map within 1e-4·max(1, largest |map|).  No golden
checkpoint is committed for this line: the converter is held by the
parity and the strict loads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eemflow_tpu.models.flownet1s as jfn
from eemflow_tpu.models.layers import Deconv as JaxDeconv
from test_torch_irrpwc import FLOW_TOL, MODULE_TOL, SIZE, close, events, jax_init_and_outputs, jax_model, nchw
from test_torch_irrpwc import port_outputs, seeded_variables

from eemflow_tpu_torch.compat.from_jax import flownet1s_state_dict_from_jax
from eemflow_tpu_torch.models import flownet1s as pfn
from eemflow_tpu_torch.models.layers import Deconv
from eemflow_tpu_torch.models.registry import get_eval_model
from eemflow_tpu_torch.ops.warp import flownet_warp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ parts


def test_flownet_warp_matches_jax():
    """No mask: a sample past the edge reads zero padding, partly."""
    rng = np.random.default_rng(5)
    h, w = 8, 12
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    flow = (rng.standard_normal((2, h, w, 2)) * 2.5 * 0.05 * SIZE[1] / w).astype(np.float32)
    want = np.asarray(jfn.flownet_warp(jnp.asarray(x), jnp.asarray(flow), *SIZE, 0.05))
    got = flownet_warp(torch.from_numpy(x), torch.from_numpy(flow), *SIZE, 0.05).numpy()
    close(got, want, MODULE_TOL)


def test_deconv_matches_jax():
    """The JAX ``Deconv`` flips its [kh, kw, Cin, Cout] kernel in its apply;
    the converter's (2, 3, 0, 1) permutation gives torch's transposed conv
    the same function, exactly twice the input size."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)
    module = JaxDeconv(4)
    variables = {"params": {"kernel": rng.standard_normal((4, 4, 6, 4)).astype(np.float32),
                            "bias": rng.standard_normal(4).astype(np.float32)}}
    want = np.asarray(module.apply(variables, jnp.asarray(x)))
    port = Deconv(6, 4)
    sd = flownet1s_state_dict_from_jax({"conv1_0": {"kernel": np.zeros((7, 7, 5, 32), np.float32)},
                                        "flownets": {"flow_decoder": {"upsample_flow6_to_5": variables["params"]}}})
    prefix = "_flownets._upsample_flow6_to_5."
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 6, 10, 4)
    close(got, want, MODULE_TOL)


@pytest.mark.parametrize("src,dst", [((7, 9), (3, 4)), ((5, 8), (2, 3))])
def test_adaptive_avg_pool_matches_jax_and_torch(src, dst):
    """JAX's ``_adaptive_avg_pool`` and torch's ``adaptive_avg_pool2d``
    take the same cells [floor(i·H/oh), ceil((i+1)·H/oh))."""
    x = np.random.default_rng(7).standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jfn._adaptive_avg_pool(jnp.asarray(x), *dst))
    got = torch.nn.functional.adaptive_avg_pool2d(nchw(x), dst).permute(0, 2, 3, 1).numpy()
    close(got, want, MODULE_TOL)


def test_cat_as_takes_the_lexicographic_branch():
    """Target [2, 3] against a [2, 4] tensor: lexicographically smaller, so
    pooled (the decoder's case at 64×96); target [3, 2] against [2, 4]: not
    smaller, so bilinear — though its width shrinks."""
    rng = np.random.default_rng(8)
    t = rng.standard_normal((1, 2, 4, 3)).astype(np.float32)
    for ref_hw in ((2, 3), (3, 2)):
        ref = np.zeros((1, *ref_hw, 1), np.float32)
        want = np.asarray(jfn._cat_as((jnp.asarray(t), jnp.asarray(ref)), jnp.asarray(ref)))
        got = pfn._cat_as((nchw(t), nchw(ref)), nchw(ref)).permute(0, 2, 3, 1).numpy()
        close(got, want, MODULE_TOL)
    pooled = pfn._cat_as((nchw(t),), torch.zeros(1, 1, 2, 3))
    np.testing.assert_allclose(pooled.numpy(), torch.nn.functional.adaptive_avg_pool2d(nchw(t), (2, 3)).numpy())


# ---------------------------------------------------------- whole models

# irr_flownet: tests/test_torch_train_irrpwc.py, compiled with its train step
PARITY = {"flownet1s": {}, "flownet1s_irr_occ_bi": {"num_iters": 2}}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_model_matches_jax(name):
    """Every prediction and every occlusion map at 64×96, B=1, on JAX's own
    initial weights."""
    fields = PARITY[name]
    seed = 90 + sorted(PARITY).index(name)
    ev = events(seed, *SIZE)
    variables, want_maps, want = jax_init_and_outputs(jax_model(name).clone(**fields), *ev, seed=seed)
    model = get_eval_model(name, **fields)
    model.load_state_dict(flownet1s_state_dict_from_jax(variables), strict=True)
    got_maps, got = port_outputs(model, *ev)
    assert np.abs(want).max() > 0.5
    close(got, want, FLOW_TOL)
    for g, w in zip(got_maps, want_maps):
        assert (g is None) == (w is None)
        if w is not None:
            close(g, w, FLOW_TOL)


@pytest.mark.parametrize("name,n_maps", [("flownet1s_irr", 0), ("flownet1s_irr_bi", 0), ("flownet1s_irr_occ", 1)])
def test_flag_subsets_load_and_predict(name, n_maps):
    variables = seeded_variables(jax_model(name), (*SIZE, 5), 95)
    model = get_eval_model(name)
    model.load_state_dict(flownet1s_state_dict_from_jax(variables), strict=True)
    maps, preds = port_outputs(model, *events(96, *SIZE))
    assert preds.shape == (3, 1, *SIZE, 2) and np.isfinite(preds).all()
    if n_maps:
        assert maps[0].shape == (1, *SIZE, 1) and maps[1] is None
    else:
        assert maps[0].shape == (1, *SIZE, 5)


def test_tools_take_the_line():
    from eemflow_tpu_torch.tools.time_eval import main as time_main

    for name in ("flownet1s", "irr_flownet"):
        res = time_main(["-model", name, "--device", "cpu", "--size", "64", "64", "-bs", "1", "--reps", "1"])
        assert res["model"] == name and res["ms_per_img"] > 0
