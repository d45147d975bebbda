"""The port's RAFT-lineage pieces against the JAX package on the same
numpy-seeded inputs and weights: the encoders and the update block
(``models/raft_core.py``), the all-pairs correlation pyramid and its
lookup (``ops/corr_block.py``), the convex upsampler, and the plain
version of kernel K5 (``ops/update_block.py``) against the JAX
``make_fused_update`` (its Pallas kernels in interpret mode on the CPU,
float32; the bf16 mode is held against the kernel on the card)
and against the JAX ``BasicUpdateBlock`` at a grid height the JAX
kernels' row tiling refuses.

Tolerances: float32 sides differ in summation order only (2e-5 on
outputs of order 1, 1e-4 on encoder features of order 10); bf16 sides
round the same operands, but an intermediate whose float32 value differs
in its last bit can round to the neighbouring bf16 value (one bf16 step
is 2^-8 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eemflow_tpu.models import raft_core as jax_raft
from eemflow_tpu.ops import corr_block as jax_corr
from eemflow_tpu.ops.pallas.update_block import make_fused_update as jax_make_fused_update
from eemflow_tpu.ops.pallas.update_block import tiles_ok
from eemflow_tpu.ops.upsample import convex_upsample_flow as jax_convex_upsample

from eemflow_tpu_torch.compat.from_jax import eraft_state_dict_from_jax
from eemflow_tpu_torch.kernels import launch_counts
from eemflow_tpu_torch.models.raft_core import BasicEncoder, BasicUpdateBlock
from eemflow_tpu_torch.ops.corr_block import build_corr_pyramid, lookup_corr_pyramid
from eemflow_tpu_torch.ops.update_block import (
    gru_flowhead_plain, make_fused_update, motion_encoder_plain,
    pack_gru_flowhead_weights, pack_motion_weights,
)
from eemflow_tpu_torch.ops.upsample import convex_upsample_flow


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5
BF16_TOL = 1e-2


def seeded_variables(module, *inputs, seed=0, **kwargs):
    """The JAX module's variables with numpy-seeded values: He-scaled conv
    kernels, small biases, BatchNorm scales near 1 and running variances
    in [0.5, 1.5] (shapes from ``eval_shape``, no JAX init run)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs, **kwargs)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_basic_encoder_matches_jax(norm_fn):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 48, 5)).astype(np.float32)
    jm = jax_raft.BasicEncoder(output_dim=64, norm_fn=norm_fn, n_first_channels=5)
    v = seeded_variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    sd = eraft_state_dict_from_jax({k: {"enc": t} for k, t in v.items()})
    model = BasicEncoder(64, norm_fn, 5).eval()
    model.load_state_dict({k[len("enc."):]: t for k, t in sd.items()}, strict=True)
    if norm_fn == "batch":
        assert "enc.layer2.0.norm3.running_var" in sd and "enc.layer2.0.downsample.1.running_var" in sd
    with torch.no_grad():
        got = model(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 4, 6, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def update_block():
    """(JAX BasicUpdateBlock, its seeded variables, the port's block with
    the same weights)."""
    jm = jax_raft.BasicUpdateBlock()
    dummy = [jnp.zeros((1, 4, 4, c)) for c in (128, 128, 324, 2)]
    v = seeded_variables(jm, *dummy, seed=2)
    sd = eraft_state_dict_from_jax({"params": {"update_block": v["params"]}})
    block = BasicUpdateBlock().eval()
    block.load_state_dict({k[len("update_block."):]: t for k, t in sd.items()}, strict=True)
    return jm, v, block


def _update_inputs(seed, H, W):
    rng = np.random.default_rng(seed)
    return (
        np.tanh(rng.standard_normal((1, H, W, 128))).astype(np.float32),
        np.maximum(rng.standard_normal((1, H, W, 128)), 0).astype(np.float32),
        rng.standard_normal((1, H, W, 324)).astype(np.float32),
        rng.standard_normal((1, H, W, 2)).astype(np.float32),
    )


def test_update_block_module_matches_jax(update_block):
    jm, v, block = update_block
    net, inp, corr, flow = _update_inputs(3, 8, 12)
    jn, jmask, jd = jm.apply(v, *(jnp.asarray(a) for a in (net, inp, corr, flow)))
    with torch.no_grad():
        pn, pmask, pd = block(_nchw(net), _nchw(inp), _nchw(corr), _nchw(flow))
    for got, want in ((pn, jn), (pmask, jmask), (pd, jd)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()))


def test_k5_plain_matches_jax_fused_update(update_block):
    """K5's plain version against the two JAX Pallas kernels (interpret
    mode) at a 16×20 grid, float32."""
    _, v, block = update_block
    net, inp, corr, flow = _update_inputs(4, 16, 20)
    jn, jd = jax_make_fused_update(v["params"])(*(jnp.asarray(a) for a in (net, inp, corr, flow)))
    before = launch_counts["update_block"]
    with torch.no_grad():
        pn, pd = make_fused_update(block)(*(torch.from_numpy(a) for a in (net, inp, corr, flow)))
    assert launch_counts["update_block"] == before  # the CPU runs the plain version
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=0, atol=TOL)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=TOL * max(1.0, np.abs(np.asarray(jd)).max()))


def test_k5_plain_takes_any_grid_height(update_block):
    """At a 28-row grid the JAX kernels have no row tiling (``tiles_ok``
    False, so the JAX model falls back to its module path); K5's plain
    version, the port's twin of the kernel, matches that module path."""
    jm, v, block = update_block
    assert not tiles_ok(28)
    net, inp, corr, flow = _update_inputs(5, 28, 12)
    jn, _, jd = jm.apply(v, *(jnp.asarray(a) for a in (net, inp, corr, flow)), compute_mask=False)
    with torch.no_grad():
        mot = motion_encoder_plain(*(torch.from_numpy(a) for a in (corr, flow)), pack_motion_weights(block.encoder))
        pn, pd = gru_flowhead_plain(torch.from_numpy(net), torch.from_numpy(inp), mot,
                                    pack_gru_flowhead_weights(block.gru, block.flow_head))
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=0, atol=TOL)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=TOL * max(1.0, np.abs(np.asarray(jd)).max()))


def _corr_inputs(seed, B=2, H=8, W=12, C=32):
    """Feature maps of a 64×96 input's 1/8 grid (its 4th level is 1×1) and
    coordinates jittered around the grid, some outside it."""
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(2))
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1)
    coords = (grid[None] + 3 * rng.standard_normal((B, H, W, 2))).astype(np.float32)
    return f1, f2, coords


@pytest.mark.parametrize("levels", [4, 5], ids=["levels4", "levels5_repeats_1x1"])
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_corr_pyramid_and_lookup_match_jax(fast, levels):
    f1, f2, coords = _corr_inputs(6)
    jp = jax_corr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels, fast=fast)
    pp = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), levels, fast=fast)
    assert [tuple(a.shape) for a in jp] == [tuple(b.shape) for b in pp]
    assert tuple(pp[3].shape[1:3]) == (1, 1)  # the size-1 axes quirk is reached
    scale = max(1.0, float(np.abs(np.asarray(jp[0], np.float32)).max()))
    # fast: the float32 sums round to bf16 and may land one bf16 step apart
    tol = BF16_TOL if fast else TOL
    for a, b in zip(jp, pp):
        assert b.dtype == (torch.bfloat16 if fast else torch.float32)
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=0, atol=tol * scale)
    want = np.asarray(jax_corr.lookup_corr_pyramid(jp, jnp.asarray(coords), 4))
    got = lookup_corr_pyramid(pp, torch.from_numpy(coords), 4).numpy()
    assert got.shape == want.shape == (2, 8, 12, levels * 81)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def test_convex_upsample_matches_jax():
    rng = np.random.default_rng(7)
    flow = rng.standard_normal((2, 5, 7, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 576)).astype(np.float32)
    want = np.asarray(jax_convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = convex_upsample_flow(torch.from_numpy(flow), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
