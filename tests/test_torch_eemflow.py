"""EEMFlow forward of the port against the JAX forward on the same weights,
at 64×96 and at 96×128 (which pads to 128×128 inside): JAX params carried
across by ``compat.from_jax``, and the golden ``.pth.tar`` loaded with
``load_state_dict``.  Tolerance 1e-4 absolute on flow.  The fused eval
modes (``fast_pyramid``, ``fast_head``; on the CPU their twins) against
the JAX fused forward at 128×192, 1e-4; the bf16 pyramid within 0.05 of
the JAX standard forward, the JAX package's own serving budget."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eemflow_tpu.compat import torch_state_dict_to_flax
from eemflow_tpu.compat.torch_loader import eemflow_alias
from eemflow_tpu.models.eemflow import EEMFlow as JaxEEMFlow

from eemflow_tpu_torch.compat.from_jax import eemflow_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model, get_model

GOLDEN_CKPT = os.path.join(os.path.dirname(__file__), "fixtures", "eemflow_hrem_golden.pth.tar")
SIZES = [(64, 96), (96, 128)]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(JaxEEMFlow().apply)


@pytest.fixture(scope="module")
def jax_init_params():
    x = jnp.zeros((1, 64, 64, 5), jnp.float32)
    v = jax.jit(JaxEEMFlow().init)(jax.random.PRNGKey(0), x, x)
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module")
def golden_arrays():
    return load_torch_checkpoint(GOLDEN_CKPT)


def _inputs(hw, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2,) + hw + (5,)).astype(np.float32) for _ in range(2)]


def _port_flow(model, ev1, ev2):
    with torch.inference_mode():
        _, flows = model(torch.from_numpy(ev1), torch.from_numpy(ev2))
    return flows[-1].numpy()


@pytest.mark.parametrize("siamese", [False, True], ids=["two_pass", "siamese_stack"])
@pytest.mark.parametrize("hw", SIZES, ids=["64x96", "96x128"])
def test_forward_from_jax_params(jax_apply, jax_init_params, hw, siamese):
    ev1, ev2 = _inputs(hw, 0)
    want = np.asarray(jax_apply(jax_init_params, jnp.asarray(ev1), jnp.asarray(ev2))[1][-1])
    model = get_eval_model("eemflow", siamese_stack=siamese)
    model.load_state_dict(eemflow_state_dict_from_jax(jax_init_params))
    got = _port_flow(model, ev1, ev2)
    assert got.shape == (2,) + hw + (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("siamese", [False, True], ids=["two_pass", "siamese_stack"])
@pytest.mark.parametrize("hw", SIZES, ids=["64x96", "96x128"])
def test_forward_from_golden_checkpoint(jax_apply, golden_arrays, hw, siamese):
    ev1, ev2 = _inputs(hw, 1)
    jax_vars = torch_state_dict_to_flax(
        {k: v for k, v in golden_arrays.items() if k != "index"}, alias=eemflow_alias
    )
    want = np.asarray(jax_apply(jax_vars, jnp.asarray(ev1), jnp.asarray(ev2))[1][-1])
    model = get_eval_model("eemflow", siamese_stack=siamese)
    model.load_state_dict(to_state_dict(golden_arrays))  # strict: index buffer included
    got = _port_flow(model, ev1, ev2)
    assert np.abs(want).max() > 1e-2  # trained-scale weights give a real flow
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_from_jax_inverts_the_jax_converter(golden_arrays):
    jax_vars = torch_state_dict_to_flax(
        {k: v for k, v in golden_arrays.items() if k != "index"}, alias=eemflow_alias
    )
    sd = eemflow_state_dict_from_jax(jax_vars)
    assert set(sd) == set(golden_arrays)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), golden_arrays[k])


def test_registry():
    assert fast_eval_kwargs("eemflow") == {"fast_head": True, "fast_pyramid": True}
    assert fast_eval_kwargs("EEMFlow") == {"fast_head": True, "fast_pyramid": True}
    assert not get_eval_model("EEMFlow").training
    assert get_model("eemflow", groups=1).decoder_1.groups == 1
    assert get_eval_model("eemflow", fast_head=True, fast_pyramid=True).fast_pyramid
    with pytest.raises(ValueError, match="does not support"):
        get_eval_model("eemflow", fast_decoders=True)
    with pytest.raises(KeyError):
        get_model("gmflownet")  # not ported yet


FAST_MODES = {
    "both": dict(fast_pyramid=True, fast_head=True),
    "pyramid": dict(fast_pyramid=True),
    "head": dict(fast_head=True),
}


@pytest.fixture(scope="module")
def fast_inputs():
    rng = np.random.default_rng(9)
    return [rng.standard_normal((1, 128, 192, 5)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_fused_flow(jax_init_params, fast_inputs):
    """The JAX forward with both fused modes (its Pallas pyramid in
    interpret mode, its head's jnp twin)."""
    m = JaxEEMFlow(fast_pyramid=True, fast_head=True, fast_head_impl="xla")
    ev1, ev2 = (jnp.asarray(e) for e in fast_inputs)
    return np.asarray(jax.jit(m.apply)(jax_init_params, ev1, ev2)[1][-1])


@pytest.mark.parametrize("mode", sorted(FAST_MODES))
def test_fused_modes_match_jax(jax_init_params, jax_fused_flow, fast_inputs, mode):
    model = get_eval_model("eemflow", **FAST_MODES[mode])
    model.load_state_dict(eemflow_state_dict_from_jax(jax_init_params))
    got = _port_flow(model, *fast_inputs)
    assert got.shape == (1, 128, 192, 2)
    np.testing.assert_allclose(got, jax_fused_flow, rtol=0, atol=TOL)


def test_fused_pyramid_bf16_near_jax_standard(jax_apply, jax_init_params, fast_inputs):
    ev1, ev2 = fast_inputs
    want = np.asarray(jax_apply(jax_init_params, jnp.asarray(ev1), jnp.asarray(ev2))[1][-1])
    model = get_eval_model("eemflow", fast_pyramid=True, fast_pyramid_dtype="bf16", fast_head=True)
    model.load_state_dict(eemflow_state_dict_from_jax(jax_init_params))
    got = _port_flow(model, ev1, ev2)
    assert np.isfinite(got).all() and np.abs(got - want).max() < 0.05


def test_fused_weights_follow_the_state_dict(jax_init_params, golden_arrays, fast_inputs):
    """The packed weights of the fused modes are dropped when a state dict
    is loaded again: the same model object follows each checkpoint."""
    fused = get_eval_model("eemflow", fast_pyramid=True, fast_head=True)
    std = get_eval_model("eemflow")
    for sd in (eemflow_state_dict_from_jax(jax_init_params), to_state_dict(golden_arrays)):
        fused.load_state_dict(sd)
        std.load_state_dict(sd)
        np.testing.assert_allclose(
            _port_flow(fused, *fast_inputs), _port_flow(std, *fast_inputs), rtol=0, atol=TOL
        )
        assert "head" in fused._fast_cache
    with pytest.raises(ValueError):
        get_eval_model("eemflow", fast_head_impl="pallas")
    with pytest.raises(ValueError):
        get_eval_model("eemflow", fast_pyramid_dtype="float16")
