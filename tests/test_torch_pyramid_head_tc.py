"""What surrounds the redesigned K3 (every conv chain on the tensor cores:
EEMFlow's pyramid, EEMFlow+'s SGU concat chains and grouped decoders) and
K4 (the coarse head, one thread-block cluster per level), on the CPU: the
split-TF32 arithmetic of K3's float32 mode at its GEMM depths, K3's packed
weights (padded, concat and grouped), K3's launch plans and their layout
run as the kernel addresses it (``_emulate``), K4's rank plan and channel
shuffle, and both planners' shared memory.  The kernels themselves run
only on the card (``tests/test_torch_gpu.py``); no JAX model is built
here."""

import itertools

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
    p = k3.pack_conv(w, k3.plan_tc(chain, LEVELS[level][1], bf16), 0, bf16)
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


@pytest.mark.parametrize("groups", [5, 4, 3, 2])
def test_shuffle_destination_is_the_jax_channel_shuffle(groups):
    """K4's conv2-4 and K3's shuffled convs (EEMFlow+'s decoders: 96
    channels, 3 groups) store output channel co at shuffle_destination(co):
    where the JAX ``channel_shuffle`` puts it."""
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


# EEMFlow+'s K3 chains at 720x1280 (padded 768x1280): (input channels, conv
# widths, flags, the levels' grids, the launches' conv ranges), and a
# ragged concat chain whose widths are no multiple of 8
_DEC_G = (1, 3, 3, 3, 1, 1, 1)
PLUS_CHAINS = {
    "sgu": (64, (32, 32, 32, 16, 8, 3), dict(concat=(True,) * 5 + (False,), relus=(True,) * 5 + (False,)),
            ((24, 40), (48, 80), (96, 160), (192, 320)),
            [(j, j + 1) for j in range(6)]),
    "decoder": (87, (96, 96, 96, 96, 64, 32, 2), dict(groups=_DEC_G, shuffle=_DEC_G, relus=(True,) * 6 + (False,)),
                ((12, 20), (24, 40), (48, 80), (96, 160), (192, 320)),
                [(j, j + 1) for j in range(7)]),
}
EMULATED = {
    **{k: v[:3] for k, v in PLUS_CHAINS.items()},
    "ragged_concat": (13, (6, 5, 3), dict(concat=(True, True, False), relus=(True, True, False))),
    # a decoder narrow enough for one launch: grouped, shuffled convs in
    # one CTA's buffers
    "grouped_chain": (13, (48, 48, 48, 48, 16, 8, 2), dict(groups=_DEC_G, shuffle=_DEC_G, relus=(True,) * 6 + (False,))),
    "level3_pool": (64, (64, 64), dict(pool=2)),
}


def _spec(cin, widths, flags):
    return k3.chain_spec(cin, widths, flags.get("concat"), flags.get("groups"), flags.get("shuffle"))


def _weights(rng, cin, widths, flags):
    """He-scaled OIHW weights ([Cout, Cin/g, 3, 3] for a grouped conv) and
    biases of a chain."""
    n = len(widths)
    concat, groups = flags.get("concat") or (False,) * n, flags.get("groups") or (1,) * n
    ws, bs = [], []
    for f, cat, g in zip(widths, concat, groups):
        ws.append(torch.from_numpy((rng.standard_normal((f, cin // g, 3, 3)) * np.sqrt(2 / (9 * cin / g)))
                                   .astype(np.float32)))
        bs.append(torch.from_numpy((rng.standard_normal(f) * 0.3).astype(np.float32)))
        cin = f + (cin if cat else 0)
    return ws, bs


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("chain", sorted(PLUS_CHAINS))
def test_k3_plans_of_eemflow_plus_chains(chain, bf16):
    """EEMFlow+'s nine chains at their 720x1280 levels: neither fits one
    launch, so each runs one conv a launch; every launch at each tile the
    wrapper may pick (all at least 8x8) within the shared memory a block
    may hold, the decoders' grouped convs walking K over their own group's
    32 inputs (the function's work, not the dense expansion's), and each
    level's grid covered by whole CTAs."""
    cin, widths, flags, grids, ranges = PLUS_CHAINS[chain]
    spec = _spec(cin, widths, flags)
    assert k3._plan_launch(spec, None, bf16) is None
    launches = k3.plan_chain(spec, None, bf16)
    assert [(lo, hi) for lo, hi, _ in launches] == ranges
    for lo, hi, plan in launches:
        for p in k3._tile_plans(plan["spec"], None, bf16):
            th, tw = p["tile"]
            assert th >= 8 and tw >= 8 and p["smem_bytes"] <= k3.MAX_SMEM
            for h, w in grids:
                assert -(-h // th) * th >= h and -(-w // tw) * tw >= w
        for j, c in enumerate(plan["convs"], start=lo):
            if flags.get("groups", (1,) * len(widths))[j] > 1:
                assert (c["kw"], c["gstride"], c["n8"], c["n8pg"]) == (32, 32, 12, 4)
    # the MMA work per output pixel: the function's MACs, plus only the
    # padding of K to whole chunks and of N to whole n8 tiles (the SGU's
    # last conv writes 3 channels of an n8 tile; in bf16 its 8-channel conv
    # a k16 chunk)
    work = sum(9 * c["kw"] * 8 * c["n8"] for *_, p in launches for c in p["convs"])
    macs = sum(9 * w.shape[1] * w.shape[0] for w in _weights(np.random.default_rng(0), cin, widths, flags)[0])
    assert macs <= work <= 1.2 * macs


def _window_weights(packed: k3.PackedChain, bf16: bool):
    """Each conv's packed weights unpacked to [9, kw, N] (float64)."""
    out = []
    for launch in packed.launches:
        for j, p in enumerate(launch.weights):
            c = launch.plan["convs"][j]
            kmat = _unpack_tc(p, c["n8"] * 8, bf16).double()
            assert float(kmat[9 * c["kw"]:].abs().sum()) == 0.0  # K padded to whole steps with zeros
            out.append((launch, j, kmat[: 9 * c["kw"]].reshape(9, c["kw"], -1)))
    return out


@pytest.mark.parametrize("chain", ["decoder", "ragged_concat", "sgu"])
def test_k3_packing_rebuilds_padded_concat_grouped_weights(chain):
    """Every conv's packed weights, read back through its input window (the
    concat carry's segments, a group's own inputs), give the OIHW weights
    exactly (float32: the two TF32 planes add up to them; bf16: rounded to
    nearest even), and every padded channel and output is zero."""
    cin, widths, flags = EMULATED[chain]
    for bf16 in (False, True):
        ws, bs = _weights(np.random.default_rng(5), cin, widths, flags)
        packed = k3.pack_chain(ws, bs, bf16, "cpu", None, flags.get("concat"), flags.get("groups"),
                               flags.get("shuffle"))
        for (launch, j, k), w in zip(_window_weights(packed, bf16), ws):
            lay = launch.plan["layout"]
            c = launch.plan["convs"][j]
            back = torch.zeros_like(k)
            taps = w.double().permute(2, 3, 1, 0).reshape(9, w.shape[1], -1)
            if c["gstride"]:
                back[:, : w.shape[1], : w.shape[0]] = taps
            else:
                for r, s_, cnt in lay["segs"][j]:
                    back[:, r: r + cnt, : w.shape[0]] = taps[:, s_: s_ + cnt]
            want = back if not bf16 else back.float().to(torch.bfloat16).double()
            tol = 2 ** -21 * float(want.abs().max()) if not bf16 else 0.0
            assert float((k - want).abs().max()) <= tol, (chain, bf16, launch.lo + j)
            assert float(k[back == 0].abs().sum()) == 0.0  # padding: zero weights
            assert float(launch.biases[j][w.shape[0]:].abs().sum()) == 0.0  # padded outputs: zero bias


def _emulate(x: torch.Tensor, packed: k3.PackedChain, relus, variant: int = 0) -> torch.Tensor:
    """K3's launches as the kernel addresses them, from each plan's
    argument struct (``plan["args"]``; plan ``variant`` of a launch's
    ``tiles``, its last where it has fewer), in float64 on the CPU: the
    input staged into buffer 0, each conv's items (n-blocks of ``ntc``
    tiles; a split last conv's parts one after another) read through their
    group's window of the input buffer and written to their output region
    (shuffled, zero outside the image) or to the output, the carry copied
    out where the last conv concatenates.  Shared memory starts as NaN, so
    a read of anything no staging or conv wrote shows in the result."""
    from eemflow_tpu_torch.kernels.coarse_head import shuffle_destination

    B, _, H, W = x.shape
    x = x.double()
    for launch in packed.launches:
        plan = launch.tiles[min(variant, len(launch.tiles) - 1)][0]
        a = plan["args"]
        n, (th, tw) = launch.hi - launch.lo, plan["tile"]
        full = torch.full((B, a["cout"], H, W), float("nan"), dtype=torch.float64)
        kmats = [k for _, _, k in _window_weights(packed._replace(launches=[launch]), packed.bf16)]
        for b, ty, tx in itertools.product(range(B), range(-(-H // th)), range(-(-W // tw))):
            y0, x0 = ty * th, tx * tw
            bufs = [torch.full((plan["buf_off"][1] // 4,), float("nan"), dtype=torch.float64),
                    torch.full(((plan["pool_off"] - plan["buf_off"][1]) // 4,), float("nan"), dtype=torch.float64)]
            rh, rw = th + 2 * n, tw + 2 * n
            gy, gx = torch.meshgrid(torch.arange(rh) + y0 - n, torch.arange(rw) + x0 - n, indexing="ij")
            ok = ((gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)).reshape(-1)
            staged = torch.zeros(rh * rw, a["x_cw"], dtype=torch.float64)
            staged[ok, : a["cin"]] = x[b][:, gy.reshape(-1)[ok], gx.reshape(-1)[ok]].t()
            bufs[0][torch.arange(rh * rw)[:, None] * a["x_ps"] + a["x_ch"] + torch.arange(a["x_cw"])] = staged
            for j in range(n):
                ext = n - 1 - j
                oh, ow = th + 2 * ext, tw + 2 * ext
                oy, ox = (t.reshape(-1) for t in torch.meshgrid(torch.arange(oh), torch.arange(ow), indexing="ij"))
                kw, n8, n8pg = a["kw"][j], a["n8"][j], a["n8pg"][j]
                out = torch.zeros(oh * ow, n8 * 8, dtype=torch.float64)
                taps = torch.stack([a["in_org"][j] + (oy + ky) * a["in_w"][j] + ox + kx
                                    for ky in range(3) for kx in range(3)], dim=1)
                parts, ntc = (a["nsplit"] if j == n - 1 else 1), a["ntc"][j]
                for part, ng in itertools.product(range(parts), range(n8 // parts // ntc)):
                    c0 = part * (n8 // parts) + ng * ntc  # the item's first n8 tile
                    g = c0 // n8pg
                    idx = taps[..., None] * a["in_ps"][j] + a["in_ch"][j] + g * a["gstride"][j] + torch.arange(kw)
                    act = bufs[a["in_buf"][j]][idx]
                    if packed.bf16:
                        act = act.float().to(torch.bfloat16).double()
                    cols = slice(c0 * 8, (c0 + ntc) * 8)
                    out[:, cols] = act.reshape(len(oy), -1) @ kmats[j][..., cols].reshape(9 * kw, -1)
                out = out + launch.biases[j].double()
                if relus[launch.lo + j]:
                    out = torch.where(out > 0, out, 0.1 * out)
                sh = a["shuffle"][j]
                dest = torch.arange(n8 * 8) if sh == 1 else shuffle_destination(torch.arange(n8 * 8), n8 * 8, sh)
                py, px = y0 - ext + oy, x0 - ext + ox
                inside = (py >= 0) & (py < H) & (px >= 0) & (px < W)
                if j < n - 1:
                    out[~inside] = 0.0
                    pix = a["out_org"][j] + oy * a["out_w"][j] + ox
                    bufs[a["out_buf"][j]][pix[:, None] * a["out_ps"][j] + a["out_ch"][j] + dest] = out
                else:
                    keep = dest < a["fout"]
                    full[b][dest[keep][:, None], py[inside], px[inside]] = out[inside][:, keep].t()
            if a["copy_out"]:  # the last conv's carry, behind its own channels
                ch = torch.cat([c0 + torch.arange(c) for c0, c in zip(a["seg_ch"][: a["nseg"]], a["seg_c"])])
                oy, ox = (t.reshape(-1) for t in torch.meshgrid(torch.arange(th), torch.arange(tw), indexing="ij"))
                inside = (y0 + oy < H) & (x0 + ox < W)
                pix = (a["cp_org"] + oy * a["cp_w"] + ox)[inside]
                full[b][a["fout"]:, (y0 + oy)[inside], (x0 + ox)[inside]] = bufs[a["cp_buf"]][
                    pix[None] * a["cp_ps"] + ch[:, None]]
        x = full
    return x


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("chain", sorted(EMULATED))
def test_k3_plan_emulated_matches_plain(chain, bf16):
    """Each chain's launches, run as the kernel addresses its buffers
    (``_emulate``: the plan's offsets, pixel strides, region origins, group
    windows, shuffle destinations, output splits and copy-out), at the
    first and the last tile plan of each launch, give the plain twin's
    output on a 2-sample 20x28 input whose tiles are ragged at the image's
    edge: float32 within K3's 2e-5, bf16 within its 5e-3 (relative to
    max(1, |plain|)), and nothing read from shared memory that no staging
    or conv wrote (NaN)."""
    cin, widths, flags = EMULATED[chain]
    flags = dict(flags)
    pool = flags.pop("pool", None)
    relus = flags.pop("relus", (True,) * len(widths))
    rng = np.random.default_rng(11)
    ws, bs = _weights(rng, cin, widths, flags)
    x = torch.from_numpy(rng.standard_normal((2, cin, 20, 28)).astype(np.float32))
    packed = k3.pack_chain(ws, bs, bf16, "cpu", pool, flags.get("concat"), flags.get("groups"), flags.get("shuffle"))
    dtype = torch.bfloat16 if bf16 else torch.float32
    ref, _ = k3.plain(x, ws, bs, pool, dtype, True, relus, **flags)
    for variant in (0, max(len(L.tiles) for L in packed.launches) - 1):
        got = _emulate(x, packed, relus, variant)
        assert not bool(torch.isnan(got).any())
        err = float((got - ref.double()).abs().max()) / max(1.0, float(ref.abs().max()))
        assert err <= (5e-3 if bf16 else K3_F32_TOL), variant
