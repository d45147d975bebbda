"""K4 wrapper: EEMFlow's coarse stage on the card (``csrc/coarse_head.cu``),
its plain twin on the CPU.

Replaces ``eemflow_tpu/ops/pallas/coarse_head.py`` ``coarse_head``.  The
kernel runs one thread-block cluster of R CTAs per (level, sample); the
ranks split every step's output channels (``rank_plan``).  It keeps the
decoder's grouped convs grouped and does each channel shuffle at the
store (``shuffle_destination``), so its weight layout
(``pack_kernel_weights``) is its own: per conv ``[Cout/COT][Cin/groups]
[9][COT]``, a rank's slice one contiguous run.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from eemflow_tpu_torch.kernels import build, launch_counts, refuse_grad
from eemflow_tpu_torch.ops.coarse_head import HeadWeights, coarse_head_plain, conv_names

plain = coarse_head_plain

NLEV, NCONV, MAXK = 3, 8, 81
NSTAGE = NCONV + 1  # the correlation, then the convs
MAXR = 16           # the largest cluster the kernel takes
CLUSTER_SIZES = (16, 8)  # tried in this order: 16 (non-portable) where it fits, else 8
THREADS = 512
PIX = 4             # neighbouring pixels a thread computes
MAX_SMEM = 232_448  # shared memory one block may opt into on sm_90
STATIC_SMEM = 16    # the kernel's own __shared__ flag, within that
KERNEL_INFO = ("threads", "registers", "local_bytes")


class _Args(ctypes.Structure):
    """Mirror of ``struct CoarseHeadArgs`` in ``csrc/coarse_head.cu``."""

    _fields_ = [
        ("f1", ctypes.c_void_p * NLEV), ("f2", ctypes.c_void_p * NLEV),
        ("wt", (ctypes.c_void_p * NCONV) * NLEV), ("bias", (ctypes.c_void_p * NCONV) * NLEV),
        ("wout", ctypes.c_void_p), ("bout", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("flows", ctypes.c_void_p), ("act", ctypes.c_void_p),
        ("counters", ctypes.c_void_p),
        ("s1", (ctypes.c_longlong * 4) * NLEV), ("s2", (ctypes.c_longlong * 4) * NLEV),
        ("B", ctypes.c_int), ("h", ctypes.c_int), ("w", ctypes.c_int), ("K", ctypes.c_int),
        ("md", ctypes.c_int), ("cap", ctypes.c_int), ("smem_bytes", ctypes.c_int), ("R", ctypes.c_int),
        ("w_smem", ctypes.c_int),
        ("C", ctypes.c_int * NLEV),
        ("cout", ctypes.c_int * NCONV), ("groups", ctypes.c_int * NCONV), ("cot", ctypes.c_int * NCONV),
        ("ks", ctypes.c_int * NSTAGE), ("bounds", (ctypes.c_int * (MAXR + 1)) * NSTAGE),
        ("idx", ctypes.c_int * MAXK),
    ]


def _library() -> ctypes.CDLL:
    lib = build.load()
    if lib.coarse_head_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("coarse_head: the binding's argument struct differs from the kernel's")
    return lib


def _cot(cout_per_group: int) -> int:
    return next(c for c in (4, 2, 1) if cout_per_group % c == 0)


def pack_conv(w: torch.Tensor, cot: int) -> torch.Tensor:
    """OIHW [Cout, Cin/groups, 3, 3] → [Cout/cot][Cin/groups][9][cot]:
    element (u, ci, ky*3+kx, c) is w[u*cot + c, ci, ky, kx], so the units
    of a rank's channel slice are one contiguous run."""
    cout, cin_pg = w.shape[:2]
    return w.reshape(cout // cot, cot, cin_pg, 9).permute(0, 2, 3, 1).contiguous()


def pack_kernel_weights(params: Mapping[str, torch.Tensor], groups: int, device) -> Dict:
    """The coarse-stage parameters (the port's state-dict names, OIHW) in
    the kernel's layout on ``device``; ``meta`` holds (Cout, groups, COT)
    per conv."""
    levels = []
    meta = None
    for lvl in (1, 2, 3):
        convs = []
        lmeta = []
        for name, g in zip(conv_names(lvl), (1, 1, groups, groups, groups, 1, 1, 1)):
            w = params[f"{name}.weight"].detach().to(device, torch.float32)
            b = params[f"{name}.bias"].detach().to(device, torch.float32)
            cout = w.shape[0]
            if cout % g:
                raise ValueError(f"coarse_head: {name} has {cout} outputs, not divisible by groups={g}")
            cot = _cot(cout // g)
            convs.append((pack_conv(w, cot), b.contiguous()))
            lmeta.append((cout, g, cot))
        if meta not in (None, lmeta):
            raise ValueError("coarse_head: the three levels' decoders differ in shape")
        meta = lmeta
        levels.append(convs)
    wout = params["out_conv.weight"].detach().to(device, torch.float32).reshape(2, 6).contiguous()
    bout = params["out_conv.bias"].detach().to(device, torch.float32).contiguous()
    # per-sample counters of the last-cluster fuse, zero between launches
    # (the CTA that fuses resets its sample's); grown by ``_counters``
    counters = torch.zeros(8, dtype=torch.int32, device=device)
    return {"levels": levels, "meta": meta, "wout": wout, "bout": bout, "counters": counters}


def conv_inputs(k: int, meta: Sequence[Tuple[int, int, int]], channels: int) -> List[int]:
    """Input channels of each conv (rconv, conv1 .. conv7) at a level of
    ``channels`` feature channels and ``k`` correlation channels."""
    couts = [m[0] for m in meta]
    return [channels, k + couts[0]] + couts[1:-1]


def rank_plan(k: int, meta: Sequence[Tuple[int, int, int]], R: int, h: int, w: int,
              channels: Sequence[int] = (16, 32, 64)):
    """How a cluster of R ranks splits each step: (bounds, ks).

    ``bounds[s]`` has R + 1 entries; rank r computes output channels
    ``[bounds[s][r], bounds[s][r + 1])`` of step s (0: the k correlation
    channels; 1 + i: conv i), whole units of the conv's COT channels.
    Where the units do not divide, some ranks take one more, the extra
    units of each step going on from the rank after the previous step's
    last extra (the correlation's extras and the rconv's, which share a
    barrier interval, land on different ranks).
    ``ks[s]`` lanes share each item of a conv (COT channels x a row x PIX
    columns), splitting its input channels, as many as keep the busiest
    rank's items x ks within the CTA's threads."""
    if not 1 <= R <= MAXR:
        raise ValueError(f"coarse_head: cluster size must be in [1, {MAXR}], got {R}")
    ngx = -(-w // PIX)
    cins = conv_inputs(k, meta, min(channels))
    steps = [(k, 1, None)] + [(cout, cot, cin // g) for (cout, g, cot), cin in zip(meta, cins)]
    bounds, ks = [], []
    start = 0  # the rank that takes the next extra unit
    for width, unit, cin_pg in steps:
        q, rem = divmod(width // unit, R)
        counts = [q + ((r - start) % R < rem) for r in range(R)]
        start = (start + rem) % R
        bounds.append([unit * sum(counts[:r]) for r in range(R + 1)])
        split = 1
        if cin_pg is not None:
            items = (q + (rem > 0)) * h * ngx
            while split * 2 <= min(32, cin_pg) and items * split * 2 <= THREADS:
                split *= 2
        ks.append(split)
    return bounds, ks


def shuffle_destination(co: int, cout: int, groups: int) -> int:
    """The buffer channel where conv2-4 store output channel ``co``: the
    position of ``co`` after a channel shuffle by ``groups``
    (σ⁻¹(co) = (co % (C/g))·g + co // (C/g))."""
    cpg = cout // groups
    return (co % cpg) * groups + co // cpg


def _cap(k: int, meta: Sequence[Tuple[int, int, int]]) -> int:
    """Channels of an activation buffer: the widest input of conv1 .. conv7."""
    return max([k + meta[0][0]] + [m[0] for m in meta[1:-1]])


def plan_buffers(k: int, meta: Sequence[Tuple[int, int, int]], h: int, w: int) -> Tuple[int, int]:
    """(dynamic shared memory of a CTA, device-memory scratch floats of a
    (sample, level)) for the two ping-pong activation buffers: in each
    CTA's shared memory where they fit the 227 KB a block may hold, else
    one scratch per (sample, level) and no dynamic shared memory."""
    nbytes = 2 * _cap(k, meta) * h * w * 4
    return (nbytes, 0) if nbytes <= MAX_SMEM else (0, nbytes // 4)


def weight_buffer_bytes(k: int, meta: Sequence[Tuple[int, int, int]], bounds, channels: Sequence[int],
                        smem: int) -> int:
    """Bytes of each of the two shared-memory buffers that hold a rank's
    weight slice of a conv (the largest over convs, ranks and levels,
    rounded up to 16), or 0 when two do not fit beside ``smem`` bytes of
    activations (or the activations are in device memory, ``smem`` 0)."""
    if not smem:
        return 0
    need = 0
    for c in channels:
        for i, ((cout, g, cot), cin) in enumerate(zip(meta, conv_inputs(k, meta, c))):
            widest = max(b1 - b0 for b0, b1 in zip(bounds[i + 1][:-1], bounds[i + 1][1:]))
            need = max(need, widest * (cin // g) * 9 * 4)
    need = -(-need // 16) * 16
    return need if smem + 2 * need <= MAX_SMEM - STATIC_SMEM else 0


def _max_clusters(lib, R: int, smem: int) -> int:
    n = ctypes.c_int(0)
    build.check(lib.coarse_head_max_clusters(R, smem, ctypes.byref(n)), "coarse_head_max_clusters")
    return n.value


def plan_launch(device, k: int, meta: Sequence[Tuple[int, int, int]], h: int, w: int,
                channels: Sequence[int], cluster: Optional[int] = None) -> Dict:
    """The launch at a grid of h x w: the cluster size (``cluster``, or 16
    where the card holds such a cluster at the launch's shared memory, else
    8), the rank plan, the activation buffers (shared memory or a
    device-memory scratch) and the two weight buffers; asked of the card
    once per shape and device."""
    key = (torch.device(device), k, tuple(meta), h, w, tuple(channels), cluster)
    if key not in _plans:
        act, scratch = plan_buffers(k, meta, h, w)
        lib = _library()
        for R in (cluster,) if cluster else CLUSTER_SIZES:
            bounds, ks = rank_plan(k, meta, R, h, w, channels)
            w_smem = weight_buffer_bytes(k, meta, bounds, channels, act)
            smem = act + 2 * w_smem
            with torch.cuda.device(device):
                fits = _max_clusters(lib, R, smem)
            if fits or cluster:
                _plans[key] = {"R": R, "bounds": bounds, "ks": ks, "act_bytes": act, "scratch": scratch,
                               "w_smem": w_smem, "smem_bytes": smem, "clusters": fits}
                break
        else:
            raise RuntimeError(f"coarse_head: no cluster of {CLUSTER_SIZES} CTAs fits the launch at {h}x{w}")
    return _plans[key]


_plans: Dict = {}
# EEMFlow's coarse stage: (Cout, groups, COT) of the rconv and conv1 .. conv7
EEMFLOW_META = ((16, 1, 4), (100, 1, 4), (100, 5, 4), (100, 5, 4), (100, 5, 4), (64, 1, 4), (32, 1, 4), (2, 1, 2))


def kernel_info(device=None, h: int = 12, w: int = 20) -> Dict:
    """The kernel on the current card: threads, registers and local (spill)
    bytes; for clusters of 8 and of 16 at EEMFlow's h x w grids (12×20 at
    720×1280) the shared memory a CTA takes and the clusters the card holds
    at once; the cluster size the wrapper picks there."""
    device = device or torch.device("cuda")
    lib = _library()
    info = (ctypes.c_int * len(KERNEL_INFO))()
    build.check(lib.coarse_head_kernel_info(info), "coarse_head_kernel_info")
    out = dict(zip(KERNEL_INFO, info))
    for R in (8, 16):
        plan = plan_launch(device, 53, EEMFLOW_META, h, w, (16, 32, 64), R)
        out[f"smem_{R}"], out[f"max_clusters_{R}"] = plan["smem_bytes"], plan["clusters"]
    out["cluster_size"] = plan_launch(device, 53, EEMFLOW_META, h, w, (16, 32, 64))["R"]
    return out


def _counters(packed: Dict, n: int) -> torch.Tensor:
    """The fuse counters for a batch of ``n``.  Launches that share them
    must run one after another, as launches on one stream do."""
    if packed["counters"].numel() < n:
        packed["counters"] = torch.zeros(n, dtype=torch.int32, device=packed["counters"].device)
    return packed["counters"]


def _bcyx_strides(t: torch.Tensor):
    """(b, c, y, x) element strides of an NHWC tensor."""
    sb, sy, sx, sc = t.stride()
    return sb, sc, sy, sx


def coarse_head_fused(
    f1_levels: Sequence[torch.Tensor],
    f2_levels: Sequence[torch.Tensor],
    weights: HeadWeights,
    indices: Sequence[int],
    max_displacement: int,
) -> torch.Tensor:
    """Three NHWC [B, h, w, C_l] float32 feature pairs (any strides) →
    the pre-upsample flow [B, h, w, 2]: K4 on the card, in clusters of the
    size ``plan_launch`` picks; the twin on the CPU."""
    f0 = f1_levels[0]
    if f0.device.type == "cpu":
        return plain(f1_levels, f2_levels, *weights.plain(f0.device), indices, max_displacement)
    return _launch(f1_levels, f2_levels, weights, indices, max_displacement, None)


def _launch(f1_levels, f2_levels, weights: HeadWeights, indices, max_displacement: int,
            cluster: Optional[int]) -> torch.Tensor:
    """K4 on CUDA tensors, in clusters of ``cluster`` CTAs (None: 16 where
    the card holds them, else 8); a given size is for the card tests and
    ``chip_smoke.py``, which hold both against the twin."""
    f0 = f1_levels[0]
    if f0.device.type != "cuda":
        raise ValueError(f"coarse_head: unsupported device {f0.device}")
    refuse_grad("coarse_head", *f1_levels, *f2_levels, *weights.params.values())
    packed = weights.kernel(f0.device)
    if len(f1_levels) != NLEV or len(f2_levels) != NLEV:
        raise ValueError("coarse_head: three levels per frame")
    B, h, w, _ = f0.shape
    idx = tuple(int(i) for i in indices)
    win = 2 * max_displacement + 1
    if len(idx) > MAXK or any(not 0 <= i < win * win for i in idx):
        raise ValueError(f"coarse_head: at most {MAXK} indices in [0, {win * win})")
    meta = packed["meta"]
    for lvl, (a, b) in enumerate(zip(f1_levels, f2_levels)):
        if a.shape != b.shape or tuple(a.shape[:3]) != (B, h, w) or a.dtype != torch.float32 \
                or b.dtype != torch.float32 or a.device != f0.device or b.device != f0.device:
            raise ValueError("coarse_head: every level must be float32 [B, h, w, C] on one device")
        if packed["levels"][lvl][0][0].shape[1] != a.shape[3]:
            raise ValueError(f"coarse_head: level {lvl + 1} has {a.shape[3]} channels, its rconv expects "
                             f"{packed['levels'][lvl][0][0].shape[1]}")
    if packed["levels"][0][1][0].shape[1] != len(idx) + meta[0][0]:
        raise ValueError("coarse_head: conv1's inputs are not the correlation plus the rconv")

    dev = f0.device
    hw = h * w
    K = len(idx)
    cap = _cap(K, meta)
    plan = plan_launch(dev, K, meta, h, w, [t.shape[3] for t in f1_levels], cluster)
    R, bounds, ks = plan["R"], plan["bounds"], plan["ks"]
    act = torch.empty(B * NLEV * plan["scratch"], dtype=torch.float32, device=dev) if plan["scratch"] else None
    out = torch.empty((B, h, w, 2), dtype=torch.float32, device=dev)
    flows = torch.empty((B, NLEV, 2, h, w), dtype=torch.float32, device=dev)
    counters = _counters(packed, B)

    a = _Args()
    for lvl in range(NLEV):
        a.f1[lvl] = f1_levels[lvl].data_ptr()
        a.f2[lvl] = f2_levels[lvl].data_ptr()
        a.s1[lvl][:] = _bcyx_strides(f1_levels[lvl])
        a.s2[lvl][:] = _bcyx_strides(f2_levels[lvl])
        a.C[lvl] = f1_levels[lvl].shape[3]
        for i, (wt, bs) in enumerate(packed["levels"][lvl]):
            a.wt[lvl][i] = wt.data_ptr()
            a.bias[lvl][i] = bs.data_ptr()
    for i, (cout, g, cot) in enumerate(meta):
        a.cout[i], a.groups[i], a.cot[i] = cout, g, cot
    for st in range(NSTAGE):
        a.ks[st] = ks[st]
        a.bounds[st][: R + 1] = bounds[st]
    a.wout, a.bout = packed["wout"].data_ptr(), packed["bout"].data_ptr()
    a.out, a.flows = out.data_ptr(), flows.data_ptr()
    a.act = act.data_ptr() if act is not None else None
    a.counters = counters.data_ptr()
    a.B, a.h, a.w, a.K, a.md, a.cap, a.R = B, h, w, K, max_displacement, cap, R
    a.w_smem, a.smem_bytes = plan["w_smem"], plan["smem_bytes"]
    a.idx[: len(idx)] = idx
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.coarse_head_launch(ctypes.byref(a), ctypes.c_void_p(stream))
    build.check(rc, "coarse_head")
    launch_counts["coarse_head"] += 1
    return out
