"""K3 wrapper: a fused 3×3 conv chain + average pool on the card, its
plain twin on the CPU.

Replaces ``eemflow_tpu/ops/pallas/fused_convs.py`` ``fused_convs_pool``.
One kernel, ``csrc/fused_convs_tc.cu``, on the tensor cores (split TF32
for float32, bf16 ``mma``), takes every chain: EEMFlow's pyramid,
EEMFlow+'s densely connected SGU estimator (concat chains) and its grouped,
channel-shuffled decoders; each launch counts in
``launch_counts["fused_convs_pool"]``.

``plan_chain`` keeps a chain that fits one launch's shared memory as one
launch (its intermediates never leave the chip) and runs one that does
not one conv a launch (between launches the carry goes through device
memory as NHWC).  ``_layout`` lays out each launch: which of two
activation buffers holds each conv's input, at which channel offset, and
where each conv writes its output.  A concat chain keeps its whole carry
in one buffer: conv j reads channels
``[off_j, end)`` and writes its output in front of them, so the concat
costs no copy.  Channels are padded inside each tap to whole K chunks of
the ``mma`` (8 for TF32, 16 for bf16) with zero weights, outputs to whole
n8 tiles.  Grouped convs stay grouped: an item of output tiles walks K over
its own group's inputs only; a channel shuffle after a conv is done where
its outputs are stored (K4's ``shuffle_destination``).  ``pack_chain`` packs
each launch's weights in K5's fragment order (``kernels/update_block.py``
``fragment_order``) for its layout; a caller that runs the same chain
again keeps the result and passes it as ``packed``.  A launch holds a plan
for every tile that fits (and, for one conv without a pool, splits of its
outputs over 2–4 CTAs a tile); the wrapper runs the one ``pick_tile``
predicts fastest on the input's grid.  The route is chosen by nothing but
the chain's shape: a chain that no plan takes raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from eemflow_tpu_torch.kernels import build, launch_counts, refuse_grad, stream_handle
from eemflow_tpu_torch.kernels.update_block import BK, fragment_order
from eemflow_tpu_torch.ops.fused_convs import check_args, fused_convs_pool_plain

plain = fused_convs_pool_plain

MAX_CONVS = 8
MAX_SMEM = 232_448  # shared memory one block may opt into on sm_90 (227 KB)
# m16 tiles of a warp's item at most, ring depths tried; the tiles tried
# without a pool, and with a pool window that divides 8 (level 3's 8x8: the
# 8x16 tile that chip_smoke.py times there)
TC_MT, TC_RINGS = 2, (3, 2)
TC_FREE_TILES = ((16, 16), (8, 16), (8, 8))
TC_POOL_TILES = ((8, 16), (8, 8))
TC_SPLITS = (1, 2, 3, 4)  # CTAs a tile a one-conv launch may split its outputs over
TC_INFO = ("threads", "registers", "local_bytes", "ctas_per_sm")


def kc(bf16: bool) -> int:
    """K values of one ``mma``: 8 (TF32 m16n8k8) or 16 (bf16 m16n8k16); a
    conv's input channels are padded to a multiple of it inside each tap."""
    return 16 if bf16 else 8


def _pad(c: int, a: int) -> int:
    return -(-c // a) * a


class ChainSpec(NamedTuple):
    """A chain as the planner sees it: input channels, and per conv its
    output channels, concat flag, groups and shuffle groups (1: none)."""

    cin: int
    couts: Tuple[int, ...]
    concat: Tuple[bool, ...]
    groups: Tuple[int, ...]
    shuffle: Tuple[int, ...]

    def part(self, lo: int, hi: int, cin: int) -> "ChainSpec":
        return ChainSpec(cin, self.couts[lo:hi], self.concat[lo:hi], self.groups[lo:hi], self.shuffle[lo:hi])

    def channels(self) -> List[int]:
        """[Cin_0, Cin_1, …, C_out]: conv j's input channels, then the
        chain's output channels."""
        out = [self.cin]
        for f, cat in zip(self.couts, self.concat):
            out.append(f + (out[-1] if cat else 0))
        return out


def chain_spec(cin: int, couts: Sequence[int], concat=None, groups=None, shuffle=None) -> ChainSpec:
    n = len(couts)
    return ChainSpec(int(cin), tuple(int(c) for c in couts),
                     tuple(bool(c) for c in (concat or (False,) * n)),
                     tuple(int(g) for g in (groups or (1,) * n)),
                     tuple(int(s) for s in (shuffle or (1,) * n)))


def tc_nt(spec: ChainSpec, bf16: bool) -> int:
    """n8 tiles of a warp's item at most (the kernel instance, ``Cfg`` in
    the kernel): float32 8 where every conv writes a multiple of 64
    channels (a split A fragment then feeds all 64); 4 where some conv
    writes 32 or more; else 2."""
    n8 = [_pad(c, 8) // 8 for c in spec.couts]
    if not bf16 and all(v % 8 == 0 for v in n8):
        return 8
    return 4 if max(n8) >= 4 else 2


def tc_warps(nt: int, bf16: bool) -> int:
    """Warps of a CTA (``Cfg`` in the kernel): 16 for bf16 items of 4 n8
    tiles, else 8."""
    return 16 if bf16 and nt == 4 else 8


def _tc_tiles(pool: Optional[int]) -> Sequence[Tuple[int, int]]:
    """Output tiles to try, in order: without a pool 16×16, 8×16, 8×8 (the
    wrapper picks among them by the grid, ``pick_tile``); with a pool
    window that divides 8, 8×16 then 8×8 (whole windows), else the window
    itself: the first that fits, whatever the batch or the image size."""
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


def _layout(spec: ChainSpec, bf16: bool) -> Dict:
    """Where one launch keeps its activations, independent of the tile.

    State k (k = 0 … n) is conv k's input (state n the chain's output):
    state 0 the staged input, state k+1 conv k's output, followed by state
    k where conv k concatenates.  A run of states joined by concats shares
    one buffer, the run's first state at the back and each output in front
    of its input, so conv j reads the window ``[off_j, off_j + width_j)``;
    a conv without concat writes into the other buffer.  Segment widths are
    channel counts padded to whole K chunks (``kc``).  State n is never
    held: the last conv stores straight to the output, and where it
    concatenates its carry (state n − 1) is copied out from shared memory
    behind it.
    Returns per state its buffer, run start, channel offset, width (region
    channels) and segments [(region channel, first real channel, count)],
    and per run start its pixel stride."""
    a = kc(bf16)
    n = len(spec.couts)
    width, segs = [_pad(spec.cin, a)], [[(0, 0, spec.cin)]]
    buf, start = [0], [0]
    for j, (f, cat) in enumerate(zip(spec.couts, spec.concat)):
        fw = _pad(f, a)
        own = [(0, 0, f)]
        if cat:
            width.append(fw + width[j])
            segs.append(own + [(fw + r, f + s, c) for r, s, c in segs[j]])
            buf.append(buf[j])
            start.append(start[j])
        else:
            width.append(fw)
            segs.append(own)
            buf.append(1 - buf[j])
            start.append(j + 1)
    run_w: Dict[int, int] = {}
    for k in range(n):  # the states held in shared memory
        run_w[start[k]] = max(run_w.get(start[k], 0), width[k])
    off = [run_w[start[k]] - width[k] if k < n else 0 for k in range(n + 1)]
    return {"n": n, "width": width, "segs": segs, "buf": buf, "start": start, "off": off,
            "ps": {s: w + 4 for s, w in run_w.items()}}


def _conv_shapes(spec: ChainSpec, lay: Dict, bf16: bool) -> List[Dict]:
    """Per conv: K channels a tap (kw), the channel advance from one group's
    window to the next, n8 tiles (all, and of one group), and its checks:
    a grouped conv reads one unpadded segment whose groups are whole K
    chunks and writes whole n8 tiles per group; a shuffled conv writes
    whole n8 tiles."""
    a = kc(bf16)
    out = []
    for j, (f, g, sh) in enumerate(zip(spec.couts, spec.groups, spec.shuffle)):
        cin = lay["width"][j] if g == 1 else spec.channels()[j]
        stored = j + 1 < len(spec.couts)
        n8 = (_pad(f, a) if stored else _pad(f, 8)) // 8
        if g > 1:
            if len(lay["segs"][j]) != 1 or cin != lay["width"][j] or (cin // g) % a or f % (8 * g):
                raise ValueError(f"fused_convs_pool: grouped conv {j} ({cin} -> {f}, groups {g}) needs its "
                                 f"input unpadded, each group a multiple of {a} channels in and 8 out")
        if sh > 1 and (f % 8 or f % sh):
            raise ValueError(f"fused_convs_pool: a shuffle by {sh} after conv {j} needs {f} outputs, "
                             "a multiple of 8 and of the shuffle's groups")
        out.append({"kw": cin // g, "gstride": cin // g if g > 1 else 0, "n8": n8, "n8pg": n8 // g})
    return out


def _conv_nt(n8pg: int, nt: int) -> int:
    """n8 tiles of an item of one conv: the largest power of two up to the
    instance's ``nt`` that divides the n8 tiles of one group."""
    t = nt
    while n8pg % t:
        t //= 2
    return t


def _tc_layout(spec: ChainSpec, pool: Optional[int], bf16: bool, tile: Tuple[int, int],
               lay: Dict, convs: List[Dict], nsplit: int = 1) -> Optional[Dict]:
    """The launch of a chain at one tile, with the ring of weight stages
    (3 or 2; a one-conv chain whose weights fit one stage 1, loaded once
    per CTA) that needs the fewest ring uses; None when none fits.
    ``nsplit`` CTAs a tile each compute 1/nsplit of the last conv's n8
    tiles (whole items), and stream only those tiles' weights.

    Shared memory: two activation buffers (a run of states in one buffer
    at the geometry of its first state, the tile grown by n − k pixels, as
    [pixel][run width + 4] floats), the pool sums ([windows][Cout]), the
    ring's mbarriers and ``ring`` stages of packed weights, each as many
    32-value K steps of a conv as fit."""
    n = lay["n"]
    th, tw = tile
    nt = tc_nt(spec, bf16)
    warps = tc_warps(nt, bf16)
    region = lambda e: (th + 2 * e) * (tw + 2 * e)
    caps = [0, 0]
    for k in range(n):
        s = lay["start"][k]
        caps[lay["buf"][k]] = max(caps[lay["buf"][k]], region(n - s) * lay["ps"][s] * 4)
    pool_bytes = (th // pool) * (tw // pool) * spec.channels()[-1] * 4 if pool else 0
    buf_off = [0, _align(caps[0])]
    pool_off = buf_off[1] + _align(caps[1])
    bar_off = pool_off + _align(pool_bytes, 16)
    block = 8 * BK * (2 if bf16 else 8)  # bytes of 8 output channels x BK K values
    steps = [-(-9 * c["kw"] // BK) for c in convs]
    n8c = [c["n8"] // (nsplit if j == n - 1 else 1) for j, c in enumerate(convs)]  # a CTA's n8 tiles
    step_bytes = [k * block for k in n8c]
    ntc = [_conv_nt(c["n8pg"], nt) for c in convs]
    if convs[-1]["n8"] % nsplit or n8c[-1] % ntc[-1]:
        return None
    items = [_tc_items(-(-region(n - 1 - j) // 16), n8c[j], ntc[j], warps) for j in range(n)]
    passes = [p for _, p in items]
    best = None
    for ring in ((1,) + TC_RINGS if n == 1 else TC_RINGS):
        ring_off = _align(bar_off + 8 * ring)
        stage_cap = (MAX_SMEM - ring_off) // ring // 16 * 16
        spst = [min(st, stage_cap // sb) for st, sb in zip(steps, step_bytes)]
        if min(spst) < 1 or (ring == 1 and n == 1 and spst[0] < steps[0]):
            continue
        # each ring use costs a CTA barrier and a wait on its stage: the
        # fewest uses win (on the card a 2-stage ring of twice the steps beat
        # 3 stages of one, chip_smoke.py's K3 plan lines), the deeper ring on
        # a tie
        uses = sum(-(-st // k) * p for st, k, p in zip(steps, spst, passes))
        if best is not None and uses >= best[0]:
            continue
        stage_bytes = max(k * sb for k, sb in zip(spst, step_bytes))
        best = (uses, {
            "tile": tile, "nt": nt, "warps": warps, "ring": ring, "stage_bytes": stage_bytes,
            "smem_bytes": ring_off + ring * stage_bytes, "buf_off": buf_off, "ring_off": ring_off,
            "bar_off": bar_off, "pool_off": pool_off, "steps": steps, "spst": spst, "ntc": ntc,
            "mb": [m for m, _ in items], "passes": passes, "ring_uses": uses, "nsplit": nsplit,
        })
    return None if best is None else best[1]


def plan_tc(chain: Sequence[int], pool: Optional[int], bf16: bool, concat=None, groups=None,
            shuffle=None) -> Optional[Dict]:
    """The launch of a whole chain (``chain`` = [Cin_0, …, C_out] as
    ``ops.fused_convs.chain_channels`` gives it) at the first tile of
    ``_tc_tiles`` that fits, with its layout (``_layout``), each conv's
    shapes and items; None when no tile fits.  Raises on a chain the
    kernel cannot take at any tile."""
    n = len(chain) - 1
    concat = tuple(concat or (False,) * n)
    couts = [chain[j + 1] - (chain[j] if concat[j] else 0) for j in range(n)]
    return _plan_launch(chain_spec(chain[0], couts, concat, groups, shuffle), pool, bf16)


def _tile_plans(spec: ChainSpec, pool: Optional[int], bf16: bool) -> List[Dict]:
    """The launch's plan at each tile of ``_tc_tiles`` that fits, in that
    order.  The layout and the packed weights do not depend on the tile."""
    if len(spec.couts) > MAX_CONVS:
        return []
    lay = _layout(spec, bf16)
    convs = _conv_shapes(spec, lay, bf16)
    plans = []
    # a one-conv launch without a pool may also split its outputs over 2, 3
    # or 4 CTAs a tile: fewer weights a CTA, for grids too small to fill
    # the card
    splits = TC_SPLITS if pool is None and len(spec.couts) == 1 else (1,)
    for tile in _tc_tiles(pool):
        for nsplit in splits:
            plan = _tc_layout(spec, pool, bf16, tile, lay, convs, nsplit)
            if plan is not None:
                plan = {**plan, "spec": spec, "pool": pool, "bf16": bf16, "layout": lay, "convs": convs}
                plan["args"] = launch_args(plan)
                plans.append(plan)
    return plans


def _plan_launch(spec: ChainSpec, pool: Optional[int], bf16: bool) -> Optional[Dict]:
    """The launch's plan at the first tile that fits, or None."""
    plans = _tile_plans(spec, pool, bf16)
    return plans[0] if plans else None


# A CTA's time on the card (µs), fitted to chip_smoke.py's "K3 launch by
# plan" lines (NVIDIA H100 80GB HBM3, 700.00 W): a fixed cost (launch,
# staging, epilogue), each ring use (a barrier and a wait on its stage) and
# each million MACs of its MMA work, by operand mode (float32's split TF32
# runs three products); and each element of a concat launch's carry that
# it copies out
CTA_US = {False: (15.0, 1.9, 4.3), True: (11.6, 0.71, 2.55)}
COPY_US = 1.15e-3


def cta_us(plan: Dict) -> float:
    """A CTA's predicted time (µs) for a plan: ``CTA_US`` and ``COPY_US``."""
    fixed, per_use, per_mmac = CTA_US[plan["bf16"]]
    th, tw = plan["tile"]
    n = len(plan["convs"])
    work = sum((th + 2 * (n - 1 - j)) * (tw + 2 * (n - 1 - j)) * 9 * c["kw"] * 8 * c["n8"]
               / (plan["nsplit"] if j == n - 1 else 1) for j, c in enumerate(plan["convs"]))
    spec = plan["spec"]
    carry = spec.channels()[-1] - spec.couts[-1]  # 0 unless the last conv concatenates
    return fixed + per_use * plan["ring_uses"] + per_mmac * work / 1e6 + COPY_US * carry * th * tw


def pick_tile(plans: Sequence[Dict], tiles_of, sms: int) -> int:
    """Which of a launch's plans (tile, split) to run on a grid: the least
    waves of CTAs over the card's ``sms`` (one CTA an SM holds a launch's
    shared memory) times a CTA's predicted time (``cta_us``); the earlier
    plan (the bigger tile, the fewer splits) on a tie.  A grid that fills
    the card takes big tiles (the least halo and staging); a small one
    (EEMFlow+'s levels 3–6) small tiles and split outputs, whose CTAs run
    the fewest MMAs and ring uses one after another.  ``tiles_of(tile)``
    gives a tile's count on the grid."""
    cost = [-(-tiles_of(p["tile"]) * p["nsplit"] // sms) * cta_us(p) for p in plans]
    return cost.index(min(cost))


def plan_chain(spec: ChainSpec, pool: Optional[int], bf16: bool) -> List[Tuple[int, int, Dict]]:
    """The launches of a chain: [(first conv, end conv, plan)].  A chain
    that fits one launch takes one (its intermediates never leave the
    chip); one that does not runs one conv a launch, the carry going
    through device memory as NHWC (at EEMFlow+'s 720x1280 levels it stays
    in the 50 MB L2), the pool in the last.  A launch of several convs
    recomputes all but the last on a halo that grows with the convs it
    holds, and its bigger buffers leave room for smaller tiles only: on
    the card the fewest launches that fit took up to 2.6x as long as one
    conv a launch (chip_smoke.py's "K3 cut" lines).  Raises where a conv
    does not fit alone."""
    n = len(spec.couts)
    whole = _plan_launch(spec, pool, bf16)
    if whole is not None:  # EEMFlow's pyramid: every level one launch
        return [(0, n, whole)]
    chans = spec.channels()
    out = []
    for j in range(n):
        plan = _plan_launch(spec.part(j, j + 1, chans[j]), pool if j == n - 1 else None, bf16)
        if plan is None:
            raise ValueError(f"fused_convs_pool: conv {j} of the chain {chans} does not fit {MAX_SMEM} bytes "
                             "of shared memory")
        out.append((j, j + 1, plan))
    return out


def _window_matrix(w: torch.Tensor, plan: Dict, j: int) -> torch.Tensor:
    """Conv j's OIHW weight → [9 · kw, N]: K = tap, then the channel of
    its input window (the window's segments in order, each padded; a
    grouped conv its group's own inputs), N = its n8 tiles; zero where a
    channel or an output is padding."""
    c = plan["convs"][j]
    cout = w.shape[0]
    taps = w.detach().float().permute(2, 3, 1, 0).reshape(9, w.shape[1], cout)
    k = taps.new_zeros(9, c["kw"], c["n8"] * 8)
    if c["gstride"]:
        k[:, : w.shape[1], :cout] = taps
    else:
        for r, s, cnt in plan["layout"]["segs"][j]:
            k[:, r: r + cnt, :cout] = taps[:, s: s + cnt]
    return k.reshape(9 * c["kw"], -1)


def pack_conv(w: torch.Tensor, plan: Dict, j: int, bf16: bool) -> torch.Tensor:
    """Conv j of a launch in the kernel's layout: ``_window_matrix`` padded
    to whole 32-value K steps, in K5's ``fragment_order`` (two TF32 planes,
    or bf16 rounded to nearest even)."""
    k = _window_matrix(w, plan, j)
    return fragment_order(F.pad(k, (0, 0, 0, -k.shape[0] % BK)), bf16)


class Launch(NamedTuple):
    """Convs [lo, hi) of a chain as one launch: its plan, packed weights,
    biases and the kernel's argument struct with every field that does not
    depend on the input (``_static_args``), at each tile that fits."""

    lo: int
    hi: int
    plan: Dict
    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    args: "_TcArgs"
    # the launch at every tile that fits (``plan``/``args`` first), for the
    # wrapper to pick by the grid (``pick_tile``); one tile with a pool
    tiles: Tuple[Tuple[Dict, "_TcArgs"], ...]


class PackedChain(NamedTuple):
    """A chain's launches with their packed weights and biases (zero past
    each conv's outputs), for one operand mode, pool and set of LeakyReLU
    flags, on the device of the weights."""

    spec: ChainSpec
    pool: Optional[int]
    bf16: bool
    relus: Tuple[bool, ...]
    launches: List[Launch]


def pack_chain(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor], bf16: bool, device,
               pool: Optional[int] = None, concat=None, groups=None, shuffle=None, relus=None) -> PackedChain:
    """Plan the chain (``plan_chain``) and pack every launch's weights for
    its layout on ``device``, with its LeakyReLU flags (default all)."""
    n = len(weights)
    groups = tuple(groups or (1,) * n)
    relus = tuple(bool(r) for r in relus) if relus is not None else (True,) * n
    spec = chain_spec(weights[0].shape[1] * groups[0], [w.shape[0] for w in weights], concat, groups, shuffle)
    device = torch.device(device)
    launches = []
    for lo, hi, plan in plan_chain(spec, pool, bf16):
        ws = [pack_conv(weights[j].to(device, torch.float32), plan, j - lo, bf16) for j in range(lo, hi)]
        bs = [F.pad(biases[j].detach().to(device, torch.float32), (0, plan["convs"][j - lo]["n8"] * 8
                                                                    - biases[j].shape[0])).contiguous()
              for j in range(lo, hi)]
        plans = [plan] if pool is not None else _tile_plans(plan["spec"], pool, bf16)
        tiles = tuple((p, _static_args(p, ws, bs, relus[lo:hi])) for p in plans)
        launches.append(Launch(lo, hi, plan, ws, bs, tiles[0][1], tiles))
    return PackedChain(spec, pool, bf16, relus, launches)


class _TcArgs(ctypes.Structure):
    """Mirror of ``struct FusedConvsTcArgs`` in ``csrc/fused_convs_tc.cu``."""

    _per_conv = ("kw", "gstride", "n8", "n8pg", "ntc", "ngrp", "in_buf", "in_ps", "in_w", "in_org", "in_ch",
                 "out_buf", "out_ps", "out_w", "out_org", "out_ch", "shuffle", "relu", "steps", "spst",
                 "mb", "passes")
    _fields_ = [
        ("x", ctypes.c_void_p), ("full", ctypes.c_void_p), ("pooled", ctypes.c_void_p),
        ("w", ctypes.c_void_p * MAX_CONVS), ("bias", ctypes.c_void_p * MAX_CONVS),
        ("sb", ctypes.c_longlong), ("sc", ctypes.c_longlong),
        ("sy", ctypes.c_longlong), ("sx", ctypes.c_longlong),
        ("fsb", ctypes.c_longlong), ("fsc", ctypes.c_longlong),
        ("fsy", ctypes.c_longlong), ("fsx", ctypes.c_longlong),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("pool", ctypes.c_int), ("TH", ctypes.c_int), ("TW", ctypes.c_int),
        ("n", ctypes.c_int), ("nt", ctypes.c_int), ("bf16", ctypes.c_int), ("nsplit", ctypes.c_int),
        ("ring", ctypes.c_int), ("stage_bytes", ctypes.c_int), ("smem_bytes", ctypes.c_int),
        ("buf_off", ctypes.c_int * 2), ("ring_off", ctypes.c_int), ("bar_off", ctypes.c_int),
        ("pool_off", ctypes.c_int),
        ("cin", ctypes.c_int), ("cout", ctypes.c_int), ("fout", ctypes.c_int),
        ("x_ch", ctypes.c_int), ("x_cw", ctypes.c_int), ("x_ps", ctypes.c_int),
        ("copy_out", ctypes.c_int), ("cp_buf", ctypes.c_int), ("cp_ps", ctypes.c_int),
        ("cp_w", ctypes.c_int), ("cp_org", ctypes.c_int), ("nseg", ctypes.c_int), ("cp_vec", ctypes.c_int),
        ("seg_ch", ctypes.c_int * (MAX_CONVS + 1)), ("seg_c", ctypes.c_int * (MAX_CONVS + 1)),
    ] + [(name, ctypes.c_int * MAX_CONVS) for name in _per_conv]


def _library() -> ctypes.CDLL:
    lib = build.load()
    if lib.fused_convs_tc_args_size() != ctypes.sizeof(_TcArgs):
        raise RuntimeError("fused_convs_pool: the binding's argument struct differs from the kernel's")
    return lib


def launch_args(plan: Dict) -> Dict:
    """The shape-only fields of the kernel's argument struct for a plan:
    each conv's input window and output segment as buffer, pixel stride,
    row width (pixels), pixel offset of the region's origin and channel
    offset (``_layout``'s geometry: a run of states at the size of its
    first state, the tile grown by n − start pixels), and the copy-out of
    a chain whose last conv concatenates."""
    lay, spec = plan["layout"], plan["spec"]
    n = lay["n"]
    th, tw = plan["tile"]

    def where(k, e):  # buffer, pixel stride, row width, origin of state k's region of ext e, channel offset
        s = lay["start"][k]
        e_run = n - s
        row = tw + 2 * e_run
        return lay["buf"][k], lay["ps"][s], row, (e_run - e) * (row + 1), lay["off"][k]

    out = {k: [] for k in _TcArgs._per_conv}
    for j, c in enumerate(plan["convs"]):
        ib, ips, iw, iorg, ich = where(j, n - j)
        # the output region of conv j is state j+1's, one pixel smaller than the input's
        ob, ops, ow, oorg, och = where(j + 1, n - j - 1) if j + 1 < n else (0, 0, 0, 0, 0)
        split = plan["nsplit"] if j == n - 1 else 1
        vals = dict(kw=c["kw"], gstride=c["gstride"], n8=c["n8"], n8pg=c["n8pg"], ntc=plan["ntc"][j],
                    ngrp=c["n8"] // split // plan["ntc"][j],
                    in_buf=ib, in_ps=ips, in_w=iw, in_org=iorg, in_ch=ich, out_buf=ob, out_ps=ops, out_w=ow,
                    out_org=oorg, out_ch=och, shuffle=spec.shuffle[j], steps=plan["steps"][j],
                    spst=plan["spst"][j], mb=plan["mb"][j], passes=plan["passes"][j])
        for k, v in vals.items():
            out[k].append(v)
    # the carry of a last conv that concatenates: state n − 1 at the tile
    copy = spec.concat[-1]
    cp = where(n - 1, 0) if copy else (0, 0, 0, 0, 0)
    segs = lay["segs"][n - 1] if copy else []
    out.update(
        nsplit=plan["nsplit"], cin=spec.cin, cout=spec.channels()[-1], fout=spec.couts[-1], x_ch=lay["off"][0],
        x_cw=lay["width"][0],
        x_ps=lay["ps"][0], copy_out=int(copy), cp_buf=cp[0], cp_ps=cp[1], cp_w=cp[2], cp_org=cp[3],
        nseg=len(segs), seg_ch=[cp[4] + r for r, _, _ in segs], seg_c=[cnt for *_, cnt in segs],
    )
    out["cp_vec"] = int(copy and all(v % 4 == 0 for v in out["seg_ch"] + out["seg_c"] + [out["fout"]]))
    return out


def kernel_info(chains: Sequence[Tuple[str, Sequence[int], Optional[int], Dict]], device=None) -> List[Dict]:
    """Each chain's launches on ``device`` (default the current card), in
    float32 and bf16: (label, channels, pool, flags: ``concat``, ``groups``,
    ``shuffle``) → per launch its convs, the instance (NT n8 tiles an item)
    with its threads, registers, local (spill) bytes and the CTAs an SM
    holds at the launch's shared memory, and the plan (tile, ring, stage
    and shared-memory bytes, passes)."""
    lib = _library()
    out = []
    for bf16 in (False, True):
        for label, chain, pool, flags in chains:
            n = len(chain) - 1
            concat = tuple(flags.get("concat") or (False,) * n)
            couts = [chain[j + 1] - (chain[j] if concat[j] else 0) for j in range(n)]
            spec = chain_spec(chain[0], couts, concat, flags.get("groups"), flags.get("shuffle"))
            for lo, hi, plan in plan_chain(spec, pool, bf16):
                info = (ctypes.c_int * len(TC_INFO))()
                with torch.cuda.device(device or torch.cuda.current_device()):
                    rc = lib.fused_convs_tc_kernel_info(plan["nt"], int(bf16), plan["smem_bytes"], info)
                build.check(rc, "fused_convs_tc_kernel_info")
                out.append({"chain": label, "mode": "bf16" if bf16 else "float32", "convs": [lo, hi],
                            "nt": plan["nt"], **dict(zip(TC_INFO, info)), "tile": plan["tile"],
                            "ring": plan["ring"], "stage_bytes": plan["stage_bytes"],
                            "smem_bytes": plan["smem_bytes"], "passes": plan["passes"]})
    return out


def _static_args(plan: Dict, weights, biases, relus) -> _TcArgs:
    """The argument struct of a launch without its input, outputs and sizes:
    made once when the chain is packed, copied per call."""
    a = _TcArgs()
    a.pool = plan["pool"] or 0
    a.TH, a.TW = plan["tile"]
    a.n, a.nt, a.bf16 = len(weights), plan["nt"], int(plan["bf16"])
    a.ring, a.stage_bytes, a.smem_bytes = plan["ring"], plan["stage_bytes"], plan["smem_bytes"]
    a.buf_off[:] = plan["buf_off"]
    a.ring_off, a.bar_off, a.pool_off = plan["ring_off"], plan["bar_off"], plan["pool_off"]
    for k, v in plan["args"].items():
        if isinstance(v, list):
            getattr(a, k)[: len(v)] = v
        else:
            setattr(a, k, v)
    for j, (w, b, r) in enumerate(zip(weights, biases, relus)):
        a.w[j], a.bias[j], a.relu[j] = w.data_ptr(), b.data_ptr(), int(r)
    return a


_SMS: Dict[int, int] = {}  # SMs of each card, by device index


def _launch(x, out_full, pooled, launch: Launch):
    args = launch.args
    if len(launch.tiles) > 1:
        index = x.device.index if x.device.index is not None else torch.cuda.current_device()
        if index not in _SMS:
            _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
        B, _, H, W = x.shape
        args = launch.tiles[pick_tile([p for p, _ in launch.tiles],
                                      lambda t: B * -(-H // t[0]) * -(-W // t[1]), _SMS[index])][1]
    a = _TcArgs.from_buffer_copy(args)
    a.x = x.data_ptr()
    a.sb, a.sc, a.sy, a.sx = x.stride()
    if out_full is not None:
        a.full = out_full.data_ptr()
        a.fsb, a.fsc, a.fsy, a.fsx = out_full.stride()
    if pooled is not None:
        a.pooled = pooled.data_ptr()
    a.B, _, a.H, a.W = x.shape
    rc = _library().fused_convs_tc_launch(ctypes.byref(a), ctypes.c_void_p(stream_handle(x.device)))
    build.check(rc, "fused_convs_pool")
    launch_counts["fused_convs_pool"] += 1


def fused_convs(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    pool: Optional[int],
    compute_dtype: torch.dtype = torch.float32,
    emit_full: bool = True,
    relus: Optional[Sequence[bool]] = None,
    concat: Optional[Sequence[bool]] = None,
    packed: Optional[PackedChain] = None,
    groups: Optional[Sequence[int]] = None,
    shuffle: Optional[Sequence[int]] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """x [B, C, H, W] float32 (bf16 with ``compute_dtype`` bf16: the JAX
    kernel reads its operands in float32, and bf16 values stay exact in the
    bf16 route), any strides; OIHW weights ([Cout, Cin/g, 3, 3] for a conv
    of ``groups`` g); ``shuffle[j]`` > 1 shuffles conv j's output channels by
    that many groups; ``packed`` from ``pack_chain`` (made here when None).
    Returns NCHW float32 (full or None, pooled or None)."""
    if x.device.type == "cpu":
        return plain(x, weights, biases, pool, compute_dtype, emit_full, relus, concat, groups, shuffle)
    if x.device.type != "cuda":
        raise ValueError(f"fused_convs_pool: unsupported device {x.device}")
    refuse_grad("fused_convs_pool", x, *weights, *biases)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_convs_pool: compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    bf16 = compute_dtype == torch.bfloat16
    if x.dtype == torch.bfloat16 and bf16:
        x = x.float()
    if x.dtype != torch.float32:
        raise ValueError(f"fused_convs_pool: float32 input (bf16 in the bf16 route) only, got {x.dtype}")
    if packed is None:
        relus, concat, groups, shuffle, _ = check_args(tuple(x.shape), weights, biases, pool, emit_full, relus,
                                                       concat, groups, shuffle)
        packed = pack_chain(weights, biases, bf16, x.device, pool, concat, groups, shuffle, relus)
    else:  # checked when packed: the chain it was packed for, this input
        n = len(weights)
        spec = chain_spec(x.shape[1], [w.shape[0] for w in weights], concat, groups, shuffle)
        relus = tuple(bool(r) for r in relus) if relus is not None else (True,) * n
        if (packed.spec, packed.pool, packed.bf16, packed.relus) != (spec, pool, bf16, relus) or \
                packed.launches[0].weights[0].device != x.device:
            raise ValueError("fused_convs_pool: packed for another chain, pool, operand mode, flags or device")
        if (not emit_full and pool is None) or (pool is not None and (x.shape[2] % pool or x.shape[3] % pool)):
            raise ValueError(f"fused_convs_pool: pool {pool} and emit_full {emit_full} do not fit {tuple(x.shape)}")
    chain = packed.spec.channels()
    B, _, H, W = x.shape
    for launch in packed.launches:
        last = launch.hi == len(chain) - 1
        c_out = chain[launch.hi]
        if not last:  # the carry to the next launch, NHWC: its staging reads whole pixels
            full = torch.empty((B, H, W, c_out), dtype=torch.float32, device=x.device).permute(0, 3, 1, 2)
            pooled = None
        else:
            full = torch.empty((B, c_out, H, W), dtype=torch.float32, device=x.device) if emit_full else None
            pooled = (torch.empty((B, c_out, H // pool, W // pool), dtype=torch.float32, device=x.device)
                      if pool is not None else None)
        _launch(x, full, pooled, launch)
        x = full
    return full, pooled
