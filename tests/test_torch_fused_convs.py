"""The port's ``fused_convs_pool`` (K3's public NHWC function; on CPU
tensors its plain twin) against the JAX package's ``fused_convs_pool``,
which runs its Pallas kernel in interpret mode on the CPU.  Same inputs
from a seeded numpy RNG; HWIO kernels for JAX, OIHW for the port.

Tolerances: float32 rtol 1e-5 and atol 1e-5 (summation order only).
bf16 operands: both sides round the same operands, and a product of two
bf16 values is exact in float32, but an intermediate that differs in its
last float32 bit can round to the neighbouring bf16 value: atol 1e-3.
Also the kernel's launch planning (shared memory, tiles, the split of a
chain that does not fit), which runs without a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eemflow_tpu.ops.pallas.fused_convs import fused_convs_pool as jax_fused_convs_pool

from eemflow_tpu_torch.kernels import fused_convs as k3
from eemflow_tpu_torch.ops.fused_convs import fused_convs_pool

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0, atol=1e-3)


def _chain(rng, cin, widths, concat=None):
    """HWIO kernels (scaled so activations stay O(1)) and biases of a chain."""
    concat = concat or (False,) * len(widths)
    ks, bs = [], []
    for f, cat in zip(widths, concat):
        ks.append((rng.standard_normal((3, 3, cin, f)) * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
        bs.append((rng.standard_normal(f) * 0.3).astype(np.float32))
        cin = f + (cin if cat else 0)
    return ks, bs


def _both(x, ks, bs, pool, dtype=torch.float32, **kw):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_fused_convs_pool(
        jnp.asarray(x), [jnp.asarray(k) for k in ks], [jnp.asarray(b) for b in bs],
        pool=pool, compute_dtype=jdt, **kw,
    )
    got = fused_convs_pool(
        torch.from_numpy(x), [torch.from_numpy(k).permute(3, 2, 0, 1) for k in ks],
        [torch.from_numpy(b) for b in bs], pool, compute_dtype=dtype, **kw,
    )
    return want, got


def _close(want, got, tol):
    assert (want is None) == (got is None)
    if want is not None:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **tol)


# (conv widths, pool, emit_full)
CASES = {
    "one_conv_pool8": ((8,), 8, True),
    "two_convs_pool16": ((8, 8), 16, True),
    "two_convs_no_pool": ((8, 8), None, True),
    "pooled_only": ((8, 8), 16, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_convs_pool_matches_jax(case):
    widths, pool, emit_full = CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 64, 8)).astype(np.float32)
    ks, bs = _chain(rng, 8, widths)
    (wf, wp), (gf, gp) = _both(x, ks, bs, pool, emit_full=emit_full)
    _close(wf, gf, F32_TOL)
    _close(wp, gp, F32_TOL)


def test_fused_convs_dense_concat_chain_matches_jax():
    """The FlowEstimatorDense pattern of the JAX package's own test: each
    conv's output prepended to its input, the last conv linear."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 24, 40, 16)).astype(np.float32)
    ks, bs = _chain(rng, 16, (8, 8, 4, 3), concat=(True, True, True, False))
    flags = dict(relus=(True,) * 3 + (False,), concat=(True,) * 3 + (False,))
    (wf, wp), (gf, gp) = _both(x, ks, bs, None, **flags)
    assert gp is None and wp is None
    _close(wf, gf, F32_TOL)


def test_fused_convs_bf16_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 64, 8)).astype(np.float32)
    ks, bs = _chain(rng, 8, (8, 8))
    (wf, wp), (gf, gp) = _both(x, ks, bs, 16, dtype=torch.bfloat16)
    _close(wf, gf, BF16_TOL)
    _close(wp, gp, BF16_TOL)
    # the rounding is real: float32 operands give another result
    (_, _), (ff, _) = _both(x, ks, bs, 16)
    assert float((ff - gf).abs().max()) > 1e-4


def test_fused_convs_checks_match_jax():
    x = torch.zeros(1, 32, 64, 8)
    w = [torch.zeros(8, 8, 3, 3)]
    b = [torch.zeros(8)]
    with pytest.raises(ValueError, match="must be"):  # chained channels
        fused_convs_pool(x, [torch.zeros(8, 4, 3, 3)], b, 8)
    with pytest.raises(ValueError, match="nothing to return"):
        fused_convs_pool(x, w, b, None, emit_full=False)
    with pytest.raises(ValueError, match="multiples of pool"):
        fused_convs_pool(x, w, b, 24)
    with pytest.raises(ValueError, match="flags"):
        fused_convs_pool(x, w, b, 8, relus=(True, False))


def test_kernel_plan_at_eemflow_levels():
    """The 720x1280 levels each fit one launch (tile = the pool window);
    the shared memory of each matches the reckoning in the kernel's note."""
    plans = {
        "level1": ([16, 16], 32, 74_048),
        "level2": ([32, 32, 32], 16, 92_800),
        "level3": ([64, 64, 64], 8, 62_720),
    }
    for name, (chain, pool, nbytes) in plans.items():
        assert k3._plan_tile(chain, pool) == (pool, pool), name
        assert k3.smem_bytes(chain, (pool, pool), True)[0] == nbytes, name
    # a chain too wide for one launch is split; one conv that cannot fit raises
    assert k3._plan_tile([32, 32, 32], 32) is None
    assert k3._plan_tile([32, 32], 32) == (32, 32)
    assert k3._plan_tile([16, 16, 16], None) == (k3.FIXED_TILE, k3.FIXED_TILE)


def test_kernel_weight_packing():
    """[Cin][9][Cout padded to 8]: element (ci, ky*3+kx, co) is OIHW
    w[co, ci, ky, kx]; bf16 packing rounds the values."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((5, 3, 3, 3)).astype(np.float32))
    p = k3.pack_weight(w, bf16=False)
    assert tuple(p.shape) == (3, 9, 8)
    for co, ci, ky, kx in ((0, 0, 0, 0), (4, 2, 1, 2), (3, 1, 2, 0)):
        assert p[ci, ky * 3 + kx, co] == w[co, ci, ky, kx]
    assert float(p[:, :, 5:].abs().max()) == 0.0
    pb = k3.pack_weight(w, bf16=True)
    assert torch.equal(pb, p.to(torch.bfloat16).float())
    assert tuple(k3.pack_bias(torch.ones(5)).shape) == (8,)
