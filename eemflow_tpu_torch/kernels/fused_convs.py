"""K3 wrapper: a fused 3×3 conv chain + average pool on the card, its
plain twin on the CPU.

Replaces ``eemflow_tpu/ops/pallas/fused_convs.py`` ``fused_convs_pool``.
Two kernels, chosen by the chain's shape (``tc_eligible``), never because
one of them failed:

  * ``csrc/fused_convs_tc.cu`` on the tensor cores (split TF32 for float32,
    bf16 ``mma``) for chains without concat whose convs read and write
    multiples of 16 channels — EEMFlow's pyramid; its launches count in
    ``launch_counts["fused_convs_pool"]``;
  * ``csrc/fused_convs.cu``, SIMT float32 FMAs, for the rest (concat
    chains, other channel counts), counted in
    ``launch_counts["fused_convs_pool_simt"]``.

Both read their input through strides (the model's NCHW, or an NHWC view)
and write NCHW outputs.  ``plan_tc`` / ``_plan_tile`` choose each launch's
tile and shared memory; a chain whose tiles do not fit is split into two
launches at its midpoint, as the JAX function splits one that does not fit
in VMEM; where even one conv does not fit, the wrapper raises.  The
tensor-core weights are K5's packing (``kernels/update_block.py``
``k_order``, ``fragment_order``): K = tap then channel, two TF32 planes or
bf16, in ``mma`` fragment order.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from eemflow_tpu_torch.kernels import build, launch_counts, refuse_grad
from eemflow_tpu_torch.kernels.update_block import BK, fragment_order, k_order
from eemflow_tpu_torch.ops.fused_convs import chain_channels, check_args, fused_convs_pool_plain

plain = fused_convs_pool_plain

MAX_CONVS = 8
COT = 8  # output channels per thread (csrc/fused_convs.cu)
MAX_SMEM = 232_448  # shared memory one block may opt into on sm_90 (227 KB)
FIXED_TILE = 16  # tile edge when there is no pool
# the tensor-core kernel (csrc/fused_convs_tc.cu): m16 tiles of a warp's
# item at most, ring depths tried; the tiles tried without a pool, and
# with a pool window that divides 8 (level 3's 8x8: the 8x16 tile that
# chip_smoke.py times there)
TC_MT, TC_RINGS = 2, (3, 2)
TC_FREE_TILES = ((16, 16), (8, 16), (8, 8))
TC_POOL_TILES = ((8, 16), (8, 8))
TC_INFO = ("threads", "registers", "local_bytes", "ctas_per_sm")


class _Args(ctypes.Structure):
    """Mirror of ``struct FusedConvsArgs`` in ``csrc/fused_convs.cu`` (SIMT)."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("full", ctypes.c_void_p), ("pooled", ctypes.c_void_p),
        ("w", ctypes.c_void_p * MAX_CONVS), ("bias", ctypes.c_void_p * MAX_CONVS),
        ("sb", ctypes.c_longlong), ("sc", ctypes.c_longlong),
        ("sy", ctypes.c_longlong), ("sx", ctypes.c_longlong),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("pool", ctypes.c_int), ("TH", ctypes.c_int), ("TW", ctypes.c_int),
        ("n", ctypes.c_int), ("bf16", ctypes.c_int),
        ("buf1_off", ctypes.c_int), ("pool_off", ctypes.c_int), ("smem_bytes", ctypes.c_int),
        ("cin", ctypes.c_int * (MAX_CONVS + 1)), ("cout", ctypes.c_int * MAX_CONVS),
        ("cout_pad", ctypes.c_int * MAX_CONVS), ("relu", ctypes.c_int * MAX_CONVS),
        ("concat", ctypes.c_int * MAX_CONVS),
    ]


class _TcArgs(ctypes.Structure):
    """Mirror of ``struct FusedConvsTcArgs`` in ``csrc/fused_convs_tc.cu``."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("full", ctypes.c_void_p), ("pooled", ctypes.c_void_p),
        ("w", ctypes.c_void_p * MAX_CONVS), ("bias", ctypes.c_void_p * MAX_CONVS),
        ("sb", ctypes.c_longlong), ("sc", ctypes.c_longlong),
        ("sy", ctypes.c_longlong), ("sx", ctypes.c_longlong),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("pool", ctypes.c_int), ("TH", ctypes.c_int), ("TW", ctypes.c_int),
        ("n", ctypes.c_int), ("nt", ctypes.c_int), ("bf16", ctypes.c_int),
        ("ring", ctypes.c_int), ("stage_bytes", ctypes.c_int), ("smem_bytes", ctypes.c_int),
        ("buf_off", ctypes.c_int * 2), ("ring_off", ctypes.c_int), ("bar_off", ctypes.c_int),
        ("pool_off", ctypes.c_int),
        ("cin", ctypes.c_int * (MAX_CONVS + 1)), ("ps", ctypes.c_int * MAX_CONVS),
        ("relu", ctypes.c_int * MAX_CONVS), ("steps", ctypes.c_int * MAX_CONVS),
        ("spst", ctypes.c_int * MAX_CONVS), ("mb", ctypes.c_int * MAX_CONVS),
        ("passes", ctypes.c_int * MAX_CONVS),
    ]


def _library() -> ctypes.CDLL:
    lib = build.load()
    if lib.fused_convs_args_size() != ctypes.sizeof(_Args) or \
            lib.fused_convs_tc_args_size() != ctypes.sizeof(_TcArgs):
        raise RuntimeError("fused_convs_pool: the binding's argument struct differs from the kernel's")
    return lib


def tc_eligible(chain: Sequence[int], concat: Sequence[bool]) -> bool:
    """Whether the tensor-core kernel takes the chain: no concat, and every
    conv reads and writes a multiple of 16 channels (a K chunk of 8 or 16
    never straddles a tap; a warp's n8 tiles divide the outputs)."""
    return not any(concat) and len(chain) - 1 <= MAX_CONVS and all(c % 16 == 0 for c in chain)


def tc_nt(chain: Sequence[int], bf16: bool) -> int:
    """n8 tiles of a warp's item: float32 8 where every conv writes a
    multiple of 64 channels (a split A fragment then feeds all 64); 4 where
    every conv writes a multiple of 32 channels and some more than 16;
    else 2."""
    if not bf16 and all(c % 64 == 0 for c in chain[1:]):
        return 8
    return 4 if max(chain[1:]) > 16 and all(c % 32 == 0 for c in chain[1:]) else 2


def tc_warps(nt: int, bf16: bool) -> int:
    """Warps of a CTA (``Cfg`` in the kernel): 16 for bf16 items of 4 n8
    tiles, else 8."""
    return 16 if bf16 and nt == 4 else 8


def _tc_tiles(pool: Optional[int]) -> Sequence[Tuple[int, int]]:
    """Output tiles to try, in order: without a pool 16×16, 8×16, 8×8;
    with a pool window that divides 8, 8×16 then 8×8 (whole windows);
    else the window itself.  The tile does not depend on the batch or the
    image size."""
    if pool is None:
        return TC_FREE_TILES
    return TC_POOL_TILES if 8 % pool == 0 else ((pool, pool),)


def _tc_items(m16: int, n8: int, nt: int, warps: int) -> Tuple[int, int]:
    """(m16 tiles of an item, passes of the warps over the items) for a conv
    of m16 pixel tiles and n8 channel tiles: the item size (1 to TC_MT m16
    tiles x nt n8 tiles) with the least passes x (m16 tiles + 1), the +1
    for what an item costs beyond its MMAs (its weight fragments, and
    passes of dependent MMAs with fewer tiles between them); the larger on
    a tie."""
    ngroups = n8 // nt
    best = None
    for mb in range(TC_MT, 0, -1):
        passes = -(-(-(-m16 // mb) * ngroups) // warps)
        if best is None or passes * (mb + 1) < best[0]:
            best = (passes * (mb + 1), mb, passes)
    return best[1], best[2]


def _align(x: int, a: int = 128) -> int:
    return -(-x // a) * a


def _tc_layout(chain: Sequence[int], pool: Optional[int], bf16: bool, tile: Tuple[int, int]) -> Optional[Dict]:
    """The tensor-core launch of a chain at one tile, with the deepest ring
    of weight stages that fits (3, then 2; a one-conv chain whose weights
    fit one stage takes 1, loaded once per CTA); None when none fits."""
    n = len(chain) - 1
    th, tw = tile
    block = 8 * BK * (2 if bf16 else 8)  # bytes of 8 output channels x BK K values
    steps = [-(-9 * c // BK) for c in chain[:-1]]
    step_bytes = [chain[j + 1] // 8 * block for j in range(n)]
    nt = tc_nt(chain, bf16)
    warps = tc_warps(nt, bf16)
    caps, ps = [0, 0], []
    for j in range(n):
        e = n - j
        ps.append(chain[j] + 4)
        caps[j % 2] = max(caps[j % 2], (th + 2 * e) * (tw + 2 * e) * ps[j] * 4)
    pool_bytes = (th // pool) * (tw // pool) * chain[-1] * 4 if pool else 0
    buf_off = [0, _align(caps[0])]
    pool_off = buf_off[1] + _align(caps[1])
    bar_off = pool_off + _align(pool_bytes, 16)
    for ring in ((1,) + TC_RINGS if n == 1 else TC_RINGS):
        ring_off = _align(bar_off + 8 * ring)
        stage_cap = (MAX_SMEM - ring_off) // ring // 16 * 16
        spst = [min(st, stage_cap // sb) for st, sb in zip(steps, step_bytes)]
        if min(spst) < 1 or (ring == 1 and n == 1 and spst[0] < steps[0]):
            continue
        items = [_tc_items(-(-(th + 2 * (n - 1 - j)) * (tw + 2 * (n - 1 - j)) // 16), chain[j + 1] // 8, nt, warps)
                 for j in range(n)]
        stage_bytes = max(k * sb for k, sb in zip(spst, step_bytes))
        return {
            "tile": tile, "nt": nt, "warps": warps, "ring": ring, "stage_bytes": stage_bytes,
            "smem_bytes": ring_off + ring * stage_bytes, "buf_off": buf_off, "ring_off": ring_off,
            "bar_off": bar_off, "pool_off": pool_off, "ps": ps, "steps": steps, "spst": spst,
            "mb": [m for m, _ in items], "passes": [p for _, p in items],
        }
    return None


def plan_tc(chain: Sequence[int], pool: Optional[int], bf16: bool) -> Optional[Dict]:
    """The tensor-core launch of a chain: tile, shared-memory layout, the
    ring of weight stages and each conv's items, at the first tile of
    ``_tc_tiles`` that fits; None when none fits.

    Shared memory: two activation buffers (conv j's input region, the tile
    grown by n − j pixels, as [pixel][Cin + 4] floats; even convs read
    buffer 0, odd ones buffer 1), the pool sums ([windows][Cout]), the
    ring's mbarriers and ``ring`` stages of packed weights, each as many
    32-value K steps of a conv as fit."""
    for tile in _tc_tiles(pool):
        plan = _tc_layout(chain, pool, bf16, tile)
        if plan is not None:
            return plan
    return None


def pack_tc(w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] → the tensor-core kernel's packed weights:
    K5's ``k_order`` (K = tap, then channel, padded to a multiple of BK)
    and ``fragment_order`` (two TF32 planes, or bf16 rounded to nearest
    even)."""
    return fragment_order(k_order(w.detach().float(), None), bf16)


def kernel_info(device=None) -> Dict:
    """The tensor-core kernel at EEMFlow's three 720×1280 pyramid levels,
    float32 and bf16, on ``device`` (default the current card): each level's instance (NT 2, 4
    or 8) with its threads, registers, local (spill) bytes and CTAs an SM
    holds at the level's shared memory; and each level's plan (tile, ring,
    stage and shared-memory bytes, CTAs of a frame, passes)."""
    lib = _library()
    levels = {1: ([16, 16], 32, 384, 640), 2: ([32, 32, 32], 16, 192, 320), 3: ([64, 64, 64], 8, 96, 160)}
    out = {"instances": [], "levels": []}
    for bf16 in (False, True):
        for lvl, (chain, pool, h, w) in levels.items():
            plan = plan_tc(chain, pool, bf16)
            th, tw = plan["tile"]
            info = (ctypes.c_int * len(TC_INFO))()
            with torch.cuda.device(device or torch.cuda.current_device()):
                rc = lib.fused_convs_tc_kernel_info(plan["nt"], int(bf16), plan["smem_bytes"], info)
            build.check(rc, "fused_convs_tc_kernel_info")
            mode = "bf16" if bf16 else "float32"
            out["instances"].append({"level": lvl, "mode": mode, "nt": plan["nt"], **dict(zip(TC_INFO, info))})
            out["levels"].append({
                "level": lvl, "mode": mode, "tile": plan["tile"], "ring": plan["ring"],
                "stage_bytes": plan["stage_bytes"], "smem_bytes": plan["smem_bytes"],
                "ctas": -(-h // th) * -(-w // tw), "passes": plan["passes"],
            })
    return out


def smem_bytes(chain: Sequence[int], tile: Tuple[int, int], pooled: bool) -> Tuple[int, int, int]:
    """(bytes, offset of buffer 1, offset of the pool sums), in floats for
    the offsets: buffer 0 holds the inputs of the even convs, buffer 1 those
    of the odd ones; conv j's input region is the tile grown by n − j
    pixels on each side."""
    n = len(chain) - 1
    th, tw = tile
    caps = [0, 0]
    for j in range(n):
        m = n - j
        caps[j % 2] = max(caps[j % 2], chain[j] * (th + 2 * m) * (tw + 2 * m))
    pool_ch = chain[-1] if pooled else 0
    return 4 * (caps[0] + caps[1] + pool_ch), caps[0], caps[0] + caps[1]


def pack_weight(w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] → [Cin][9][Cout padded to COT], float32
    (values rounded to bf16 in bf16 mode)."""
    cout, cin = w.shape[:2]
    pad = -cout % COT
    p = w.detach().float().permute(1, 2, 3, 0).reshape(cin, 9, cout)
    if bf16:
        p = p.to(torch.bfloat16).float()
    return torch.nn.functional.pad(p, (0, pad)).contiguous()


def pack_bias(b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(b.detach().float(), (0, -b.shape[0] % COT)).contiguous()


def pack_chain(
    weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor], bf16: bool, device,
    concat: Optional[Sequence[bool]] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor, str]]:
    """Every conv's (weight, bias, kernel) in the layout of the kernel the
    chain's shape selects (``"tc"`` or ``"simt"``) on ``device``; a caller
    that runs the same chain again keeps this and passes it as ``packed``."""
    concat = tuple(concat) if concat is not None else (False,) * len(weights)
    chain = chain_channels(weights[0].shape[1], weights, concat)
    if tc_eligible(chain, concat):
        return [(pack_tc(w.to(device), bf16), b.detach().to(device, torch.float32).contiguous(), "tc")
                for w, b in zip(weights, biases)]
    return [(pack_weight(w.to(device), bf16), pack_bias(b.to(device)), "simt") for w, b in zip(weights, biases)]


def _plan_tile(chain: Sequence[int], pool: Optional[int]) -> Optional[Tuple[int, int]]:
    """The tile the launch uses, or None when the chain does not fit."""
    if pool is not None:
        tiles = [(pool, pool)]
    else:
        tiles = [(t, t) for t in (FIXED_TILE, 8, 4)]
    for tile in tiles:
        if smem_bytes(chain, tile, pool is not None)[0] <= MAX_SMEM:
            return tile
    return None


def _outputs(x, c_out, pool, emit_full):
    B, _, H, W = x.shape
    full = torch.empty((B, c_out, H, W), dtype=torch.float32, device=x.device) if emit_full else None
    pooled = (
        torch.empty((B, c_out, H // pool, W // pool), dtype=torch.float32, device=x.device)
        if pool is not None else None
    )
    return full, pooled


def _check_packed(packed, dev, kind: str) -> None:
    for w, b, k in packed:
        if k != kind:
            raise ValueError(f"fused_convs_pool: the chain runs on the {kind} kernel, but was packed for {k}")
        if w.device != dev or b.device != dev:
            raise ValueError("fused_convs_pool: packed weights must be on the input's device")


def _stream(dev) -> ctypes.c_void_p:
    with torch.cuda.device(dev):
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch_tc(x, pool, bf16, emit_full, relus, chain, plan, packed):
    B, _, H, W = x.shape
    n = len(chain) - 1
    _check_packed(packed, x.device, "tc")
    full, pooled = _outputs(x, chain[-1], pool, emit_full)
    a = _TcArgs()
    a.x = x.data_ptr()
    a.full = full.data_ptr() if full is not None else None
    a.pooled = pooled.data_ptr() if pooled is not None else None
    a.sb, a.sc, a.sy, a.sx = x.stride()
    a.B, a.H, a.W, a.pool = B, H, W, pool or 0
    a.TH, a.TW = plan["tile"]
    a.n, a.nt, a.bf16 = n, plan["nt"], int(bf16)
    a.ring, a.stage_bytes, a.smem_bytes = plan["ring"], plan["stage_bytes"], plan["smem_bytes"]
    a.buf_off[:] = plan["buf_off"]
    a.ring_off, a.bar_off, a.pool_off = plan["ring_off"], plan["bar_off"], plan["pool_off"]
    for j, (w, b, _) in enumerate(packed):
        a.w[j], a.bias[j] = w.data_ptr(), b.data_ptr()
        a.relu[j] = int(relus[j])
        a.ps[j], a.steps[j], a.spst[j] = plan["ps"][j], plan["steps"][j], plan["spst"][j]
        a.mb[j], a.passes[j] = plan["mb"][j], plan["passes"][j]
    a.cin[: n + 1] = chain
    rc = _library().fused_convs_tc_launch(ctypes.byref(a), _stream(x.device))
    build.check(rc, "fused_convs_pool")
    launch_counts["fused_convs_pool"] += 1
    return full, pooled


def _launch_simt(x, pool, bf16, emit_full, relus, concat, chain, tile, packed):
    B, _, H, W = x.shape
    n = len(packed)
    _check_packed(packed, x.device, "simt")
    full, pooled = _outputs(x, chain[-1], pool, emit_full)
    nbytes, buf1, pool_off = smem_bytes(chain, tile, pool is not None)
    a = _Args()
    a.x = x.data_ptr()
    a.full = full.data_ptr() if full is not None else None
    a.pooled = pooled.data_ptr() if pooled is not None else None
    a.sb, a.sc, a.sy, a.sx = x.stride()
    a.B, a.H, a.W = B, H, W
    a.pool = pool or 0
    a.TH, a.TW = tile
    a.n, a.bf16 = n, int(bf16)
    a.buf1_off, a.pool_off, a.smem_bytes = buf1, pool_off, nbytes
    for j, (w, b, _) in enumerate(packed):
        a.w[j] = w.data_ptr()
        a.bias[j] = b.data_ptr()
        a.cout[j] = chain[j + 1] - (chain[j] if concat[j] else 0)
        a.cout_pad[j] = w.shape[-1]
        a.relu[j] = int(relus[j])
        a.concat[j] = int(concat[j])
    for j, c in enumerate(chain):
        a.cin[j] = c
    rc = _library().fused_convs_launch(ctypes.byref(a), _stream(x.device))
    build.check(rc, "fused_convs_pool")
    launch_counts["fused_convs_pool_simt"] += 1
    return full, pooled


def fused_convs(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    pool: Optional[int],
    compute_dtype: torch.dtype = torch.float32,
    emit_full: bool = True,
    relus: Optional[Sequence[bool]] = None,
    concat: Optional[Sequence[bool]] = None,
    packed: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor, str]]] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """x [B, C, H, W] float32, any strides; OIHW weights; ``packed`` from
    ``pack_chain`` (made here when None), whose layout names the kernel.
    Returns NCHW (full or None, pooled or None)."""
    if x.device.type == "cpu":
        return plain(x, weights, biases, pool, compute_dtype, emit_full, relus, concat)
    if x.device.type != "cuda":
        raise ValueError(f"fused_convs_pool: unsupported device {x.device}")
    refuse_grad("fused_convs_pool", x, *weights, *biases)
    if x.dtype != torch.float32:
        raise ValueError("fused_convs_pool: float32 input only")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_convs_pool: compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    relus, concat, chain = check_args(tuple(x.shape), weights, biases, pool, emit_full, relus, concat)
    if len(weights) > MAX_CONVS:
        raise ValueError(f"fused_convs_pool: at most {MAX_CONVS} convs per chain")
    bf16 = compute_dtype == torch.bfloat16
    if packed is None:
        packed = pack_chain(weights, biases, bf16, x.device, concat)
    if len(packed) != len(weights):
        raise ValueError("fused_convs_pool: one packed (weight, bias) per conv")
    # the kernel pack_chain chose by the chain's shape (a split keeps it)
    tc = packed[0][2] == "tc"
    if tc and not tc_eligible(chain, concat):
        raise ValueError(f"fused_convs_pool: channels {chain} packed for the tensor-core kernel, which does not take them")
    plan = plan_tc(chain, pool, bf16) if tc else _plan_tile(chain, pool)
    if plan is None:
        n = len(weights)
        if n == 1:
            raise ValueError(
                f"fused_convs_pool: one conv with channels {chain} and pool {pool} does not fit "
                f"in {MAX_SMEM} bytes of shared memory"
            )
        s = n // 2
        mid, _ = fused_convs(x, weights[:s], biases[:s], None, compute_dtype, True,
                             relus[:s], concat[:s], packed[:s])
        return fused_convs(mid, weights[s:], biases[s:], pool, compute_dtype, emit_full,
                           relus[s:], concat[s:], packed[s:])
    if tc:
        return _launch_tc(x, pool, bf16, emit_full, relus, chain, plan, packed)
    return _launch_simt(x, pool, bf16, emit_full, relus, concat, chain, plan, packed)
