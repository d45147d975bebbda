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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """The 720x1280 levels each fit one tensor-core launch, with the tiles
    and shared memory the kernel's note gives, at any batch size; chains the tensor-core kernel
    does not take keep the SIMT plan (tile = the pool window); a chain too
    wide for one launch is split, and one conv that cannot fit raises."""
    plans = {
        "level1": ([16, 16], 32, (32, 32), 1, 113_152),
        "level2": ([32, 32, 32], 16, (16, 16), 3, 227_456),
        "level3": ([64, 64, 64], 8, (8, 16), 3, 213_248),
    }
    for name, (chain, pool, tile, ring, nbytes) in plans.items():
        assert k3.tc_eligible(chain, (False,) * (len(chain) - 1)), name
        plan = k3.plan_tc(chain, pool, False)
        assert (plan["tile"], plan["ring"], plan["smem_bytes"]) == (tile, ring, nbytes), name
        assert k3.plan_tc(chain, pool, True)["tile"] == tile, name
        assert k3._plan_tile(chain, pool) == (pool, pool), name
    # pool windows that divide 8 take 8x16 tiles, then 8x8; other windows
    # the window itself; without a pool 16x16 first
    assert k3.plan_tc([32, 32], 4, bf16=False)["tile"] == (8, 16)
    assert k3.plan_tc([16, 16], 12, bf16=True)["tile"] == (12, 12)
    assert k3.plan_tc([32, 32], None, bf16=False)["tile"] == (16, 16)
    assert k3.plan_tc([32, 32, 32], 32, bf16=False) is None
    assert k3.plan_tc([32, 32], 32, bf16=False)["tile"] == (32, 32)
    assert k3._plan_tile([32, 32, 32], 32) is None
    assert k3._plan_tile([16, 16, 16], None) == (k3.FIXED_TILE, k3.FIXED_TILE)
    assert not k3.tc_eligible([16, 24, 32], (True, True))  # a concat chain stays SIMT
    assert not k3.tc_eligible([8, 8], (False,))


def test_kernel_weight_packing():
    """The tensor-core layout (K5's k_order + fragment_order) holds every
    OIHW weight once, in two TF32 planes that add up to it (float32) or
    rounded to bf16; the SIMT layout is [Cin][9][Cout padded to 8]; and
    pack_chain picks the layout by the chain's shape."""
    from eemflow_tpu_torch.kernels.update_block import tf32_round

    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((16, 32, 3, 3)).astype(np.float32))
    p = k3.pack_tc(w, bf16=False)
    # [steps, n8, kk, plane, g, t, h]: K row 8kk + 4h + t of the step, column 8j + g
    assert tuple(p.shape) == (9, 2, 4, 2, 8, 4, 2)
    big, small = p[:, :, :, 0], p[:, :, :, 1]
    assert torch.equal(tf32_round(big), big) and torch.equal(tf32_round(small), small)
    s_, j, kk, g, t, h = 4, 1, 2, 3, 1, 1
    k = 32 * s_ + 8 * kk + 4 * h + t          # K = tap * Cin + channel
    tap, ci = divmod(k, 32)
    assert float(big[s_, j, kk, g, t, h] + small[s_, j, kk, g, t, h]) == pytest.approx(
        float(w[8 * j + g, ci, tap // 3, tap % 3]), rel=2e-7, abs=1e-12)
    total = (big + small).double().sum()
    assert float(total) == pytest.approx(float(w.double().sum()), rel=1e-6)
    pb = k3.pack_tc(w, bf16=True)
    assert pb.dtype == torch.bfloat16 and pb.numel() == w.numel()
    assert torch.equal(torch.sort(pb.float().flatten())[0], torch.sort(w.to(torch.bfloat16).float().flatten())[0])

    ps = k3.pack_weight(torch.from_numpy(rng.standard_normal((5, 3, 3, 3)).astype(np.float32)), bf16=False)
    assert tuple(ps.shape) == (3, 9, 8) and float(ps[:, :, 5:].abs().max()) == 0.0
    assert tuple(k3.pack_bias(torch.ones(5)).shape) == (8,)
    kinds = {k for *_, k in k3.pack_chain([w, w[:, :16]], [torch.zeros(16)] * 2, False, "cpu")}
    assert kinds == {"tc"}
    ws = [torch.zeros(8, 16, 3, 3), torch.zeros(8, 24, 3, 3)]
    kinds = {k for *_, k in k3.pack_chain(ws, [torch.zeros(8)] * 2, False, "cpu", concat=(True, False))}
    assert kinds == {"simt"}
