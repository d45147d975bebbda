"""The port's ``fused_convs_pool`` (K3's public NHWC function; on CPU
tensors its plain twin) against the JAX package's ``fused_convs_pool``,
which runs its Pallas kernel in interpret mode on the CPU.  Same inputs
from a seeded numpy RNG; HWIO kernels for JAX, OIHW for the port.

Tolerances: float32 rtol 1e-5 and atol 1e-5 (summation order only).
bf16 operands: both sides round the same operands, and a product of two
bf16 values is exact in float32, but an intermediate that differs in its
last float32 bit can round to the neighbouring bf16 value: atol 1e-3.
Also the kernel's launch planning (shared memory, tiles, the split of a
chain that does not fit) and weight packing, which run without a card, and
the port's own ``groups``/``shuffle`` arguments (EEMFlow+'s grouped
decoders, which the JAX function takes as dense kernels)."""

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
    and shared memory the kernel's note gives, at any batch size; the
    route takes concat chains and channel counts off multiples of 16; a
    chain too wide for one launch is split, and one conv that cannot fit
    raises."""
    plans = {
        "level1": ([16, 16], 32, (32, 32), 1, 113_152),
        "level2": ([32, 32, 32], 16, (16, 16), 3, 227_456),
        "level3": ([64, 64, 64], 8, (8, 16), 2, 213_248),  # 2 stages of 3 K steps: fewer ring uses than 3 of 2
    }
    for name, (chain, pool, tile, ring, nbytes) in plans.items():
        plan = k3.plan_tc(chain, pool, False)
        assert (plan["tile"], plan["ring"], plan["smem_bytes"]) == (tile, ring, nbytes), name
        assert k3.plan_tc(chain, pool, True)["tile"] == tile, name
        launches = k3.plan_chain(k3.chain_spec(chain[0], chain[1:]), pool, False)
        assert [(lo, hi) for lo, hi, _ in launches] == [(0, len(chain) - 1)], name
    # pool windows that divide 8 take 8x16 tiles, then 8x8; other windows
    # the window itself; without a pool 16x16 first
    assert k3.plan_tc([32, 32], 4, bf16=False)["tile"] == (8, 16)
    assert k3.plan_tc([16, 16], 12, bf16=True)["tile"] == (12, 12)
    assert k3.plan_tc([32, 32], None, bf16=False)["tile"] == (16, 16)
    assert k3.plan_tc([32, 32, 32], 32, bf16=False) is None
    assert k3.plan_tc([32, 32], 32, bf16=False)["tile"] == (32, 32)
    split = k3.plan_chain(k3.chain_spec(32, (32, 32)), 32, False)
    assert [(lo, hi, p["tile"]) for lo, hi, p in split] == [(0, 1, (16, 16)), (1, 2, (32, 32))]
    assert k3.plan_tc([16, 16, 16], None, bf16=False)["tile"] == (16, 16)
    # a concat chain and ragged channels: padded to whole K chunks
    assert k3.plan_tc([16, 24, 32], None, bf16=False, concat=(True, True))["tile"] == (16, 16)
    assert k3.plan_tc([8, 8], None, bf16=False)["convs"][0]["kw"] == 8
    assert k3.plan_tc([3, 5], None, bf16=True)["convs"][0]["kw"] == 16
    with pytest.raises(ValueError, match="does not fit"):
        k3.plan_chain(k3.chain_spec(2048, (2048,)), None, False)


def test_kernel_weight_packing():
    """The tensor-core layout (K5's fragment_order, K = tap then channel)
    holds every OIHW weight once, in two TF32 planes that add up to it
    (float32) or rounded to bf16; a conv whose channels are no multiple of
    the K chunk gets zero rows inside each tap and zero columns past its
    outputs; and pack_chain plans and packs a concat chain as one launch
    with its biases padded to whole n8 tiles."""
    from eemflow_tpu_torch.kernels.update_block import tf32_round

    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((16, 32, 3, 3)).astype(np.float32))
    p = k3.pack_conv(w, k3.plan_tc([32, 16], None, False), 0, bf16=False)
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
    pb = k3.pack_conv(w, k3.plan_tc([32, 16], None, True), 0, bf16=True)
    assert pb.dtype == torch.bfloat16 and pb.numel() == w.numel()
    assert torch.equal(torch.sort(pb.float().flatten())[0], torch.sort(w.to(torch.bfloat16).float().flatten())[0])

    # 3 -> 5 channels: K = 9 taps x 8 (3 real, 5 zero) padded to 3 steps, N one n8 tile
    w5 = torch.from_numpy(rng.standard_normal((5, 3, 3, 3)).astype(np.float32))
    plan = k3.plan_tc([3, 5], None, False)
    kmat = k3._window_matrix(w5, plan, 0).reshape(9, 8, 8)
    assert torch.equal(kmat[:, :3, :5], w5.permute(2, 3, 1, 0).reshape(9, 3, 5))
    assert float(kmat[:, 3:].abs().sum() + kmat[:, :, 5:].abs().sum()) == 0.0
    assert tuple(k3.pack_conv(w5, plan, 0, False).shape) == (3, 1, 4, 2, 8, 4, 2)
    ws = [torch.zeros(8, 16, 3, 3), torch.zeros(3, 24, 3, 3)]
    packed = k3.pack_chain(ws, [torch.ones(8), torch.ones(3)], False, "cpu", concat=(True, False))
    (launch,) = packed.launches
    assert (launch.lo, launch.hi) == (0, 2) and [tuple(b.shape) for b in launch.biases] == [(8,), (8,)]
    assert float(launch.biases[1][3:].abs().sum()) == 0.0


def _decoder(rng, cin: int, groups: int, mid: int):
    """A decoder (``models/eemflow.Decoder``) with He-scaled random weights."""
    from eemflow_tpu_torch.models.eemflow import Decoder

    dec = Decoder(cin, groups, mid)
    with torch.no_grad():
        for name, t in dec.named_parameters():
            fan_in = t[0].numel() if t.dim() == 4 else 1
            t.copy_(torch.from_numpy((rng.standard_normal(t.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)))
    return dec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_grouped_shuffled_chain_matches_jax_dense(dtype):
    """EEMFlow+'s decoder through the port's plain twin with its convs 2-4
    grouped and shuffled (``groups``, ``shuffle``: what the kernel runs)
    equals the JAX ``fused_convs_pool`` on the decoder's dense expansion
    with the shuffles folded into the next conv's inputs
    (``decoder_dense_kernels``); and equals the decoder module itself."""
    from eemflow_tpu_torch.ops.coarse_head import decoder_dense_kernels

    rng = np.random.default_rng(7)
    dec = _decoder(rng, 13, 3, 12)
    x = rng.standard_normal((1, 16, 16, 13)).astype(np.float32)
    sd = {f"d.{k}": v for k, v in dec.state_dict().items()}
    ks, bs, relus = decoder_dense_kernels(sd, "d", 3)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want, _ = jax_fused_convs_pool(jnp.asarray(x), [jnp.asarray(k.numpy()) for k in ks],
                                   [jnp.asarray(b.numpy()) for b in bs], pool=None, compute_dtype=jdt, relus=relus)
    convs = [dec.conv1, dec.conv2, dec.conv3, dec.conv4, dec.conv5, dec.conv6]
    ws = [c[0].weight.detach() for c in convs] + [dec.conv7.weight.detach()]
    b_ = [c[0].bias.detach() for c in convs] + [dec.conv7.bias.detach()]
    g = (1, 3, 3, 3, 1, 1, 1)
    got, _ = fused_convs_pool(torch.from_numpy(x), ws, b_, None, compute_dtype=dtype, relus=relus, groups=g,
                              shuffle=g)
    _close(want, got, BF16_TOL if dtype == torch.bfloat16 else F32_TOL)
    if dtype == torch.float32:
        with torch.no_grad():
            ref = dec(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32_TOL)
    with pytest.raises(ValueError, match="shuffled"):
        fused_convs_pool(torch.from_numpy(x), ws, b_, None, relus=relus, groups=g, shuffle=(1, 5, 3, 3, 1, 1, 1))
