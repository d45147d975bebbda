"""What surrounds the redesigned K3 (the pyramid's conv chains on the
tensor cores) and K4 (the coarse head, one thread-block cluster per
level), on the CPU: the split-TF32 arithmetic of K3's float32 mode at its
GEMM depths, K3's packed weights, K4's rank plan and channel shuffle, and
both planners' shared memory.  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``); no JAX model is built here."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from eemflow_tpu.models.layers import channel_shuffle as jax_channel_shuffle

from eemflow_tpu_torch.kernels import coarse_head as k4
from eemflow_tpu_torch.kernels import fused_convs as k3
from eemflow_tpu_torch.kernels.update_block import BK, k_order, tf32_round, tf32_split

# K3's float32 tolerance, relative to max(1, largest |reference|)
K3_F32_TOL = 2e-5
# EEMFlow's pyramid levels: (chain, pool) of each K3 call
LEVELS = {"level1": ([16, 16], 32), "level2": ([32, 32, 32], 16), "level3": ([64, 64, 64], 8)}
# K4's decoder (Cout, groups, COT) per conv: rconv, conv1 .. conv7
HEAD_META = {
    g: [(16, 1, 4), (100, 1, 4), (100, g, 4), (100, g, 4), (100, g, 4), (64, 1, 4), (32, 1, 4), (2, 1, 2)]
    for g in (5, 1)
}
K_CORR = 53


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """NCHW [1, C, H, W] → [H·W, 9·C], K = tap (ky, kx) then channel: the
    order the kernel walks K and ``k_order`` packs the weights."""
    c = x.shape[1]
    cols = F.unfold(x, 3, padding=1)  # [1, C·9, HW], channel-major
    return cols.reshape(c, 9, -1).permute(2, 1, 0).reshape(-1, 9 * c)


def _emulated_conv(a: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] as K3's float32 mode runs it: operands split into
    two TF32 planes, each k8 chunk's three products small·big + big·small
    + big·big summed into a fresh partial sum, the chunks added in
    float32."""
    m, k = a.shape
    a = a.reshape(m, k // 8, 8)
    w = kmat[:k].reshape(k // 8, 8, -1)
    ab, as_ = tf32_split(a)
    wb, ws = tf32_split(w)
    prod = lambda x, y: torch.einsum("mbk,bkn->mbn", x, y)
    parts = prod(as_, wb) + prod(ab, ws) + prod(ab, wb)
    out = torch.zeros(m, w.shape[-1])
    for i in range(parts.shape[1]):  # in order, in float32, as the accumulator does
        out = out + parts[:, i]
    return out


@pytest.mark.parametrize("cin", [16, 32, 64], ids=["K144", "K288", "K576"])
def test_split_tf32_conv_keeps_the_float32_tolerance(cin):
    """One conv of each level (K = 9·Cin = 144, 288, 576) through the
    emulated split-TF32 MMAs, with the weights in K5's K order, stays within
    2e-5 of max(1, |ref|) of a float64 convolution."""
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((1, cin, 12, 16)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cin, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
    ref = F.conv2d(x.double(), w.double(), padding=1)[0].reshape(cin, -1).t()
    got = _emulated_conv(_im2col(x), k_order(w, None))
    err = float((got.double() - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    assert err <= K3_F32_TOL


def _unpack_tc(p: torch.Tensor, cout: int, bf16: bool) -> torch.Tensor:
    """Invert ``pack_tc``'s fragment order: the blocks → the [K, Cout]
    matrix, K padded to whole steps (float32 mode: the two TF32 planes
    added)."""
    if bf16:  # [s, j, kk, g, t, q, h]: K row 16kk + 8q + 4h + t, column 8j + g
        k = p.float().permute(0, 2, 5, 6, 4, 1, 3)
    else:  # [s, j, kk, plane, g, t, h]: K row 8kk + 4h + t
        k = (p[:, :, :, 0].double() + p[:, :, :, 1].double()).permute(0, 2, 5, 4, 1, 3)
    return k.reshape(p.shape[0] * BK, cout)


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_tc_packing_rebuilds_the_weights(level, bf16):
    """K3's packed weights at each level's widths give back the OIHW
    weights (K = tap, then channel): the two TF32 planes add up to them
    (each plane TF32), the bf16 pack is them rounded to nearest even, and
    the rows that pad K to whole steps are zero."""
    chain, _ = LEVELS[level]
    cin, cout = chain[0], chain[1]
    rng = np.random.default_rng(len(chain) + cin)
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3)).astype(np.float32))
    p = k3.pack_tc(w, bf16)
    assert p.shape[0] == -(-9 * cin // BK) and p.shape[1] == cout // 8
    kmat = _unpack_tc(p, cout, bf16)
    back = kmat[: 9 * cin].reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    assert float(kmat[9 * cin:].abs().sum()) == 0.0
    if bf16:
        assert torch.equal(back, w.to(torch.bfloat16).float())
    else:
        assert torch.equal(tf32_round(p[:, :, :, 0]), p[:, :, :, 0])
        assert torch.equal(tf32_round(p[:, :, :, 1]), p[:, :, :, 1])
        np.testing.assert_allclose(back.numpy(), w.double().numpy(), rtol=2 ** -21, atol=0)


@pytest.mark.parametrize("groups", [5, 1])
@pytest.mark.parametrize("R", [8, 16])
def test_rank_plan_covers_every_channel_once(R, groups):
    """Each step's bounds split its output channels into R contiguous
    slices that cover every channel exactly once, in whole COT units that
    never straddle a group; the K-split keeps the busiest rank within the
    CTA's threads and each conv's channels."""
    meta = HEAD_META[groups]
    for h, w in ((12, 20), (8, 15), (16, 24)):
        bounds, ks = k4.rank_plan(K_CORR, meta, R, h, w)
        assert len(bounds) == len(ks) == k4.NSTAGE
        widths = [(K_CORR, 1, 1)] + [(cout, cot, g) for cout, g, cot in meta]
        cins = [None] + k4.conv_inputs(K_CORR, meta, 16)
        for (width, unit, g), b, split, cin in zip(widths, bounds, ks, cins):
            assert len(b) == R + 1 and b[0] == 0 and b[-1] == width
            owner = np.zeros(width, int)
            for r in range(R):
                assert b[r] <= b[r + 1] and b[r] % unit == 0
                owner[b[r]:b[r + 1]] += 1
            assert (owner == 1).all()
            assert (width // g) % unit == 0  # a unit never straddles a group
            busiest = max(b[r + 1] - b[r] for r in range(R)) // unit
            assert split & (split - 1) == 0 and split <= 32
            if cin is not None:
                assert split <= cin // g
                assert busiest * h * -(-w // k4.PIX) * split <= k4.THREADS or split == 1


@pytest.mark.parametrize("groups", [5, 4, 2])
def test_shuffle_destination_is_the_jax_channel_shuffle(groups):
    """conv2-4 store output channel co at shuffle_destination(co): where the
    JAX ``channel_shuffle`` puts it."""
    c = 100 if 100 % groups == 0 else 96
    shuffled = np.asarray(jax_channel_shuffle(jnp.arange(c, dtype=jnp.float32).reshape(1, 1, 1, c), groups))[0, 0, 0]
    for co in range(c):
        assert shuffled[k4.shuffle_destination(co, c, groups)] == co


def test_kernel_layout_units_are_contiguous():
    """A rank's slice of a conv is one contiguous run of the packed tensor:
    unit u holds channels [u·COT, (u + 1)·COT)."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.standard_normal((100, 20, 3, 3)).astype(np.float32))
    p = k4.pack_conv(w, 4)
    assert tuple(p.shape) == (25, 20, 9, 4) and p.is_contiguous()
    for u, ci, tap, c in ((0, 0, 0, 0), (24, 19, 8, 3), (10, 7, 5, 2)):
        assert p[u, ci, tap, c] == w[u * 4 + c, ci, tap // 3, tap % 3]


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_k3_plan_fits_shared_memory(level, bf16):
    """K3's tensor-core plan at each level: within the 232,448 B a block may
    hold, its regions laid out without overlap and aligned for the bulk
    copies, each conv's items over whole passes of the CTA's warps."""
    chain, pool = LEVELS[level]
    plan = k3.plan_tc(chain, pool, bf16)
    assert plan is not None and plan["smem_bytes"] <= k3.MAX_SMEM
    th, tw = plan["tile"]
    assert th % pool == 0 and tw % pool == 0
    n = len(chain) - 1
    regions = [(chain[j] + 4) * (th + 2 * (n - j)) * (tw + 2 * (n - j)) * 4 for j in range(n)]
    assert plan["buf_off"][1] >= max(regions[0::2])
    assert plan["pool_off"] >= plan["buf_off"][1] + max(regions[1::2] or [0])
    assert plan["bar_off"] >= plan["pool_off"] + (th // pool) * (tw // pool) * chain[-1] * 4
    assert plan["ring_off"] >= plan["bar_off"] + 8 * plan["ring"]
    assert plan["ring_off"] % 16 == 0 and plan["stage_bytes"] % 16 == 0
    block = 8 * BK * (2 if bf16 else 8)
    for j in range(n):
        assert plan["spst"][j] * chain[j + 1] // 8 * block <= plan["stage_bytes"]
        ext = n - 1 - j
        m16 = -(-(th + 2 * ext) * (tw + 2 * ext) // 16)
        ngroups = -(-chain[j + 1] // 8 // plan["nt"])
        assert 1 <= plan["mb"][j] <= k3.TC_MT
        assert -(-m16 // plan["mb"][j]) * ngroups <= plan["warps"] * plan["passes"][j]


@pytest.mark.parametrize("grid", [(12, 20), (8, 15), (16, 24)], ids=["12x20", "8x15", "16x24"])
def test_k4_buffers_fit_or_take_the_scratch(grid):
    """K4's ping-pong buffers at EEMFlow's 12×20 grids and at 8×15 sit in
    shared memory within 232,448 B; at 16×24 they do not, and the launch
    takes a device-memory scratch with no dynamic shared memory."""
    h, w = grid
    smem, scratch = k4.plan_buffers(K_CORR, HEAD_META[5], h, w)
    need = 2 * 100 * h * w * 4
    if need <= k4.MAX_SMEM:
        assert (smem, scratch) == (need, 0)
    else:
        assert (smem, scratch) == (0, need // 4)
    assert grid != (16, 24) or scratch > 0
