"""The port's KPAFlow (``models/kpaflow.py``) against the JAX package's on
the CPU: the patch helpers, the kernel-patch attention with and without
the focus kernel at grids that are a multiple of the patch size, that are
not, and that are smaller than it (the neighbour windows, the extra empty
patch that ``sc - dim % sc`` adds even at a multiple, and windows that are
mostly padding); the whole model at 64×96 and 256×256 (3 iterations,
every iteration's ``upflow8`` prediction) on numpy-seeded weights carried
across by ``kpaflow_state_dict_from_jax`` with both gates and ``w_prelu``
drawn nonzero; the golden checkpoint loads strictly once its ``zero``
buffer is dropped; its MVSEC golden AEE through the port's ``test_mvsec``
(12 iterations).  Tolerances are ``tests/test_torch_gma.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eemflow_tpu.models.kpaflow as jax_kpa
from test_torch_gma import (FIXTURES, GOLDEN_TOL, MODULE_TOL, assert_flows_close, events, jax_flows,
                            port_flows, run_mvsec_golden, seeded_variables)
from test_torch_gma import golden_mvsec_root  # noqa: F401  (a fixture)

from eemflow_tpu_torch.compat.from_jax import kpaflow_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import drop_prefixes, load_model_checkpoint
from eemflow_tpu_torch.models import kpaflow as port_kpa
from eemflow_tpu_torch.models.registry import get_eval_model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sc", [4, 13])
def test_patch_helpers_match_jax(sc):
    rng = np.random.default_rng(sc)
    hs, ws = 3, 2
    x = rng.standard_normal((2, hs * sc, ws * sc, 3)).astype(np.float32)
    want = np.asarray(jax_kpa._patchify(jnp.asarray(x), sc))
    got = port_kpa._patchify(torch.from_numpy(x), sc)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_kpa._unpatchify(got, sc, hs, ws).numpy(), x)
    xp = rng.standard_normal((2, (hs + 2) * sc, (ws + 2) * sc, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_kpa._window_keys(torch.from_numpy(xp), sc).numpy(),
                                  np.asarray(jax_kpa._window_keys(jnp.asarray(xp), sc)))
    np.testing.assert_array_equal(port_kpa._window_offsets(sc), np.asarray(jax_kpa._window_offsets(sc)))


# (grid, sc): a multiple of sc on both axes (one whole empty patch added on
# each), on neither, and a grid smaller than sc (one patch, its windows
# mostly padding); MVSEC's 32x32 grid at the encoder's and the decoder's sc
GRIDS = [((8, 12), 4), ((9, 13), 4), ((3, 5), 7), ((32, 32), 13), ((32, 32), 19)]


@pytest.mark.parametrize("use_focus", [False, True], ids=["plain", "focus"])
@pytest.mark.parametrize("grid,sc", GRIDS, ids=[f"{g[0]}x{g[1]}_sc{s}" for g, s in GRIDS])
def test_patch_window_attention_matches_jax(grid, sc, use_focus):
    h, w = grid
    c_qk, c_v, ch = 24, 16, 16
    rng = np.random.default_rng(h * w + sc)
    fq = rng.standard_normal((2, h, w, c_qk)).astype(np.float32)
    fv = rng.standard_normal((2, h, w, c_v)).astype(np.float32)
    params = {"to_qk": {"kernel": (rng.standard_normal((1, 1, c_qk, 2 * ch)) * 0.5).astype(np.float32)},
              "to_v": {"kernel": (rng.standard_normal((1, 1, c_v, ch)) * 0.3).astype(np.float32)},
              "gamma": np.array([1.3], np.float32)}
    if use_focus:
        # a steeper slope than the init's, so that the kernel's rise inside
        # 2sc weighs as much as its cut beyond
        params["w_prelu"] = np.array([2.5 / ((3 * sc - 1) / 2)], np.float32)
    module = jax_kpa.PatchWindowAttention(ch, sc, use_focus=use_focus)
    want = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(fq), jnp.asarray(fv)))
    port = port_kpa.PatchWindowAttention(c_qk, c_v, ch, sc, use_focus)
    port.load_state_dict(kpaflow_state_dict_from_jax({"params": params}), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(fq).permute(0, 3, 1, 2), torch.from_numpy(fv).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, h, w, ch) and np.abs(want - fv).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=MODULE_TOL * max(1.0, np.abs(want).max()))


def test_padding_adds_a_whole_patch_at_a_multiple():
    """The out-of-frame mask at an 8×12 grid with sc 4: 3×4 patches, the
    last row and column of patches wholly outside the frame."""
    am, dy, dx = port_kpa._consts(8, 12, 4, torch.device("cpu"))
    assert tuple(am.shape) == (1, 12, 16, 9 * 16)
    assert tuple(dy.shape) == tuple(dx.shape) == (16, 9 * 16)
    # the last patch (row 2, column 3) lies wholly outside: every score masked
    assert bool((am[0, 11] == -99.0).all()) and bool((am[0, 0, :, 4 * 16:5 * 16] == 0.0).all())


@pytest.fixture(scope="module")
def kpa_variables():
    return seeded_variables(jax_kpa.KPAFlow(iters=1), (64, 96, 5), 33)


@pytest.mark.parametrize("size", [(64, 96), (256, 256)], ids=["64x96", "256x256"])
def test_model_matches_jax(kpa_variables, size):
    """3 iterations, every iteration's prediction, both gates and
    ``w_prelu`` drawn nonzero: at 64×96 the 8×12 grid is smaller than both
    patch sizes; at 256×256 (MVSEC's crop) 3×3 patches of 13 and 2×2 of 19."""
    ev = events(60 + size[0], *size)
    want = jax_flows(jax_kpa.KPAFlow(iters=3), kpa_variables, *ev)
    model = port_kpa.KPAFlow(iters=3).eval()
    model.load_state_dict(kpaflow_state_dict_from_jax(kpa_variables), strict=True)
    for gate in (model.trans.gamma, model.update_block.kpa.gamma, model.update_block.kpa.w_prelu):
        assert float(gate.detach()) != 0
    got = port_flows(model, *ev)
    assert want.shape == (3, 1, *size, 2) and np.abs(want).max() > 0.1
    assert_flows_close(got, want)


def test_golden_checkpoint_loads_strictly():
    model = get_eval_model("kpaflow")
    assert not hasattr(model, "upsample_all") and drop_prefixes("kpaflow") == ("zero",)
    load_model_checkpoint(model, f"{FIXTURES}/kpaflow_mvsec_golden.pth.tar", "kpaflow")
    assert float(model.trans.gamma.detach()) == float(model.update_block.kpa.gamma.detach()) == 0.0


def test_kpaflow_mvsec_golden_aee(golden_mvsec_root, tmp_path):  # noqa: F811
    aee, want = run_mvsec_golden(golden_mvsec_root, tmp_path, "kpaflow")
    assert abs(aee - want) < GOLDEN_TOL, f"KPAFlow golden AEE {aee}, committed {want}"

