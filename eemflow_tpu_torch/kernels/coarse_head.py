"""K4 wrapper: EEMFlow's coarse stage on the card (``csrc/coarse_head.cu``),
its plain twin on the CPU.

Replaces ``eemflow_tpu/ops/pallas/coarse_head.py`` ``coarse_head``.  The
kernel keeps the decoder's grouped convs grouped and does each channel
shuffle at the store, so its weight layout (``pack_kernel_weights``) is
its own: per conv ``[Cin/groups][9][Cout]``, Cout padded to 4 for the
dense convs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Sequence

import torch
import torch.nn.functional as F

from eemflow_tpu_torch.kernels import build, launch_counts
from eemflow_tpu_torch.ops.coarse_head import HeadWeights, coarse_head_plain, conv_names

plain = coarse_head_plain

NLEV, NCONV, MAXK = 3, 8, 81
MAX_SMEM = 232_448  # shared memory one block may opt into on sm_90


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
        ("md", ctypes.c_int), ("cap", ctypes.c_int), ("smem_bytes", ctypes.c_int),
        ("C", ctypes.c_int * NLEV),
        ("cout", ctypes.c_int * NCONV), ("cout_pad", ctypes.c_int * NCONV),
        ("groups", ctypes.c_int * NCONV), ("cot", ctypes.c_int * NCONV),
        ("idx", ctypes.c_int * MAXK),
    ]


def _library() -> ctypes.CDLL:
    lib = build.load()
    if lib.coarse_head_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("coarse_head: the binding's argument struct differs from the kernel's")
    return lib


def _cot(cout_per_group: int) -> int:
    return next(c for c in (4, 2, 1) if cout_per_group % c == 0)


def pack_kernel_weights(params: Mapping[str, torch.Tensor], groups: int, device) -> Dict:
    """The coarse-stage parameters (the port's state-dict names, OIHW) in
    the kernel's layout on ``device``."""
    levels = []
    meta = None
    for lvl in (1, 2, 3):
        convs = []
        lmeta = []
        for name, g in zip(conv_names(lvl), (1, 1, groups, groups, groups, 1, 1, 1)):
            w = params[f"{name}.weight"].detach().to(device, torch.float32)
            b = params[f"{name}.bias"].detach().to(device, torch.float32)
            cout, cin_pg = w.shape[:2]
            if cout % g:
                raise ValueError(f"coarse_head: {name} has {cout} outputs, not divisible by groups={g}")
            pad = -cout % 4 if g == 1 else 0
            p = w.permute(1, 2, 3, 0).reshape(cin_pg, 9, cout)
            convs.append((F.pad(p, (0, pad)).contiguous(), F.pad(b, (0, pad)).contiguous()))
            lmeta.append((cout, cout + pad, g, _cot((cout + pad) // g)))
        if meta not in (None, lmeta):
            raise ValueError("coarse_head: the three levels' decoders differ in shape")
        meta = lmeta
        levels.append(convs)
    wout = params["out_conv.weight"].detach().to(device, torch.float32).reshape(2, 6).contiguous()
    bout = params["out_conv.bias"].detach().to(device, torch.float32).contiguous()
    # per-sample counters of the last-CTA fuse, zero between launches (the
    # CTA that fuses resets its sample's); grown by ``_counters``
    counters = torch.zeros(8, dtype=torch.int32, device=device)
    return {"levels": levels, "meta": meta, "wout": wout, "bout": bout, "counters": counters}


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
    the pre-upsample flow [B, h, w, 2]: K4 on the card, the twin on the
    CPU."""
    f0 = f1_levels[0]
    if f0.device.type == "cpu":
        return plain(f1_levels, f2_levels, *weights.plain(f0.device), indices, max_displacement)
    if f0.device.type != "cuda":
        raise ValueError(f"coarse_head: unsupported device {f0.device}")
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
        if packed["levels"][lvl][0][0].shape[0] != a.shape[3]:
            raise ValueError(f"coarse_head: level {lvl + 1} has {a.shape[3]} channels, its rconv expects "
                             f"{packed['levels'][lvl][0][0].shape[0]}")
    if packed["levels"][0][1][0].shape[0] != len(idx) + meta[0][0]:
        raise ValueError("coarse_head: conv1's inputs are not the correlation plus the rconv")

    dev = f0.device
    hw = h * w
    cap = max([len(idx) + meta[0][0]] + [m[0] for m in meta[1:-1]])
    smem = 2 * cap * hw * 4
    act = None
    if smem > MAX_SMEM:
        act = torch.empty(B * NLEV * 2 * cap * hw, dtype=torch.float32, device=dev)
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
    for i, (cout, cpad, g, cot) in enumerate(meta):
        a.cout[i], a.cout_pad[i], a.groups[i], a.cot[i] = cout, cpad, g, cot
    a.wout, a.bout = packed["wout"].data_ptr(), packed["bout"].data_ptr()
    a.out, a.flows = out.data_ptr(), flows.data_ptr()
    a.act = act.data_ptr() if act is not None else None
    a.counters = counters.data_ptr()
    a.B, a.h, a.w, a.K, a.md, a.cap, a.smem_bytes = B, h, w, len(idx), max_displacement, cap, smem
    a.idx[: len(idx)] = idx
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.coarse_head_launch(ctypes.byref(a), ctypes.c_void_p(stream))
    build.check(rc, "coarse_head")
    launch_counts["coarse_head"] += 1
    return out
