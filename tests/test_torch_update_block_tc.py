"""What surrounds K5's tensor-core kernel, on the CPU: the split-TF32
arithmetic that lets float32 mode keep its 1e-5 tolerance, the weight
packers (TF32 planes, bf16, fragment order) and the wrapper's relayout
rule.  The kernel itself runs only on the card (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from eemflow_tpu_torch.kernels.update_block import (
    BK, conv_sources, needs_relayout, pack_conv, pack_update_weights, tf32_round, tf32_split,
)

# K5's float32 tolerance, relative to max(1, largest |reference|)
K5_F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emulated_mma(a: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
    """[M, K] @ [K, N] as the kernel's TF32 MMAs: operands rounded by
    cvt.rna, products summed in float32 per k8 step, the steps summed in
    float32; split: big·big + big·small + small·big."""
    m, k = a.shape
    a = torch.nn.functional.pad(a, (0, -k % 8)).reshape(m, -1, 8)
    w = torch.nn.functional.pad(w, (0, 0, 0, -k % 8)).reshape(-1, 8, w.shape[1])
    prod = lambda x, y: torch.einsum("mbk,bkn->mbn", x, y)
    if split:
        ab, as_ = tf32_split(a)
        wb, ws = tf32_split(w)
        steps = prod(as_, wb) + prod(ab, ws) + prod(ab, wb)
    else:
        steps = prod(tf32_round(a), tf32_round(w))
    return steps.sum(dim=1)


@pytest.mark.parametrize("k", [324, 1152, 1920, 2304])
def test_split_tf32_keeps_the_float32_tolerance(k):
    """At K5's GEMM depths with He-scaled weights, split TF32 stays within
    1e-5 of max(1, |ref|) against float64; one TF32 product does not, which
    is why float32 mode splits and the tolerance is unchanged."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((128, k)).astype(np.float32)
    w = (rng.standard_normal((k, 64)) * np.sqrt(2.0 / k)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    split = float(np.abs(_emulated_mma(at, wt, True).double().numpy() - ref).max()) / scale
    single = float(np.abs(_emulated_mma(at, wt, False).double().numpy() - ref).max()) / scale
    assert split <= K5_F32_TOL
    assert single > K5_F32_TOL


def test_tf32_round_is_cvt_rna():
    """Nearest with ties away from zero, 10 mantissa bits kept."""
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11), one + 2.0 ** -12, one + 3 * 2.0 ** -11, 0.0,
                      one - 2.0 ** -12], dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, -(one + 2.0 ** -10), one, one + 2.0 ** -9, 0.0, one],
                        dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)


def _unpack(packed: torch.Tensor, sources, kh: int, kw: int, cin: int, cout: int, bf16: bool):
    """The OIHW weight each packed element holds (0 where it is padding),
    from the layout as documented: lane 4g + t, column 8j + g; K row of the
    step 8kk + 4h + t (float32) or 16kk + 8q + 4h + t (bf16); the step's
    rows are (tap, source, channel) or, for the flow gather, (tap, channel).
    Returns (the packed values as float64, the flat OIHW index each holds or
    -1), both in the packed shape."""
    p = packed.float().numpy().astype(np.float64)
    if bf16:
        S, J, KK, G, T, Q, Hh = p.shape
        s, j, kk, g, t, q, h = np.indices(p.shape)
        k_local = 16 * kk + 8 * q + 4 * h + t
    else:
        S, J, KK, P, G, T, Hh = p.shape
        s, j, kk, _, g, t, h = np.indices(p.shape)
        k_local = 8 * kk + 4 * h + t
    n = 8 * j + g
    if sources is None:
        k = s * BK + k_local
        tap, c = k // cin, k % cin
        valid = tap < kh * kw
    else:
        nch = [-(-c // BK) for c in sources]
        spt = sum(nch)
        tap, r = s // spt, s % spt
        c = np.full(p.shape, -1)
        cbase = 0
        first = 0
        for cs, nc in zip(sources, nch):
            inside = (r >= first) & (r < first + nc)
            ch = (r - first) * BK + k_local
            c = np.where(inside & (ch < cs), cbase + ch, c)
            cbase += cs
            first += nc
        valid = c >= 0
    valid &= n < cout
    flat = np.where(valid, ((n * cin + c) * kh + tap // kw) * kw + tap % kw, -1)
    return p, flat


@pytest.mark.parametrize("sources,kh,kw", [([36, 8], 3, 3), (None, 7, 7), ([12, 8, 4], 1, 5)],
                         ids=["two-sources-3x3", "flow-gather-7x7", "three-sources-1x5"])
def test_packed_planes_rebuild_the_oihw_weights(sources, kh, kw):
    """float32 mode: each packed element is an OIHW weight split in two TF32
    planes, big + small within 2^-21·|w| of it, both with their low 13
    mantissa bits zero; padding is zero; bf16 mode: the same elements, equal
    to w.to(bfloat16)."""
    rng = np.random.default_rng(3)
    cin = 2 if sources is None else sum(sources)
    cout = 10
    w = torch.from_numpy(rng.standard_normal((cout, cin, kh, kw)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    flat_w = w.numpy().reshape(-1).astype(np.float64)

    packed, bias = pack_conv([w], [b], sources, False, "cpu")
    assert packed.dtype == torch.float32 and bias.shape == (64,)
    assert torch.equal(bias[:cout], b) and not bias[cout:].any()
    assert not (packed.view(torch.int32) & 0x1FFF).any()
    p, idx = _unpack(packed, sources, kh, kw, cin, cout, False)
    big, small = p[:, :, :, 0], p[:, :, :, 1]
    idx = idx[:, :, :, 0]
    want = np.where(idx >= 0, flat_w[np.maximum(idx, 0)], 0.0)
    assert np.all(np.abs(big + small - want) <= 2.0 ** -21 * np.abs(want))
    assert not big[idx < 0].any() and not small[idx < 0].any()
    # every OIHW weight appears exactly once
    assert sorted(idx[idx >= 0].tolist()) == list(range(flat_w.size))

    packed16, _ = pack_conv([w], [b], sources, True, "cpu")
    assert packed16.dtype == torch.bfloat16
    p16, idx16 = _unpack(packed16, sources, kh, kw, cin, cout, True)
    want16 = w.to(torch.bfloat16).double().numpy().reshape(-1)
    assert np.array_equal(p16, np.where(idx16 >= 0, want16[np.maximum(idx16, 0)], 0.0))
    assert sorted(idx16[idx16 >= 0].tolist()) == list(range(flat_w.size))


def test_pack_update_weights_lays_out_every_conv():
    """ERAFT's update block on the CPU: eleven convs, z and r stacked, N
    padded to 64 (the flow head's 2 channels to 8), K steps as the entry
    points walk them, every weight where the layout says."""
    from eemflow_tpu_torch.models.raft_core import BasicUpdateBlock
    from eemflow_tpu_torch.ops.update_block import make_fused_update

    torch.manual_seed(0)
    fused = make_fused_update(BasicUpdateBlock())
    packed = pack_update_weights(fused.motion, fused.gru, False, "cpu")
    assert (packed["corr_c"], packed["hidden"], packed["context"]) == (324, 128, 128)
    srcs = conv_sources(324, 128, 128)
    groups = [[wb] for wb in fused.motion] + [
        [fused.gru[0], fused.gru[1]], [fused.gru[2]], [fused.gru[3], fused.gru[4]], [fused.gru[5]],
        [fused.gru[6]], [fused.gru[7]]]
    n_pad = [256, 192, 128, 64, 128, 256, 128, 256, 128, 256, 8]
    steps = [11, 72, 4, 36, 72, 60, 60, 60, 60, 36, 72]
    assert len(packed["convs"]) == 11
    for (wp, bp), group, src, n, st in zip(packed["convs"], groups, srcs, n_pad, steps):
        w = torch.cat([g[0].detach() for g in group])
        cout, cin, kh, kw = w.shape
        assert bp.shape == (n,) and wp.shape == (st, n // 8, 4, 2, 8, 4, 2)
        p, idx = _unpack(wp, src, kh, kw, cin, cout, False)
        flat_w = w.numpy().reshape(-1).astype(np.float64)
        want = np.where(idx[:, :, :, 0] >= 0, flat_w[np.maximum(idx[:, :, :, 0], 0)], 0.0)
        assert np.all(np.abs(p[:, :, :, 0] + p[:, :, :, 1] - want) <= 2.0 ** -21 * np.abs(want))


def test_relayout_rule():
    """Contiguous NHWC, ERAFT's torch.cat correlation features and a channel
    slice with an aligned pixel stride are read where they lie; an NHWC view
    of an NCHW tensor, a misaligned start and a crop are copied first."""
    net = torch.randn(2, 6, 7, 128)
    assert not needs_relayout(net)
    corr = torch.cat([torch.randn(1, 6, 7, 81) for _ in range(4)], dim=-1)
    assert corr.shape[-1] == 324 and not needs_relayout(corr)
    assert not needs_relayout(torch.cat([corr, corr[..., :4]], dim=-1)[..., :324])
    assert needs_relayout(net.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    assert needs_relayout(torch.randn(net.numel() + 1)[1:].view(net.shape))
    assert needs_relayout(net[:, 1:5, 1:6])
    flow = torch.randn(2, 6, 7, 2)
    assert not needs_relayout(flow, align=2)
    assert needs_relayout(flow.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), align=2)
    # size-1 dimensions may carry any stride
    assert not needs_relayout(torch.randn(1, 4, 1, 128).as_strided((1, 4, 1, 128), (7, 128, 128, 1)))
