"""K5 wrapper: the RAFT update block without its mask head on the card
(``csrc/update_block.cu``), its plain version on the CPU.

Replaces ``eemflow_tpu/ops/pallas/update_block.py`` ``motion_encoder_fused``
and ``gru_flowhead_fused``: ``update_motion`` and ``update_gru`` each make
one call of their C entry point (``update_block_motion_launch``,
``update_block_gru_launch``), which enqueues a fixed sequence of conv
launches on PyTorch's current stream, and add one to
``launch_counts["update_block"]``.  Tensors are read and written through
their strides (NHWC is the fast layout); intermediates go to scratch
allocated here with ``torch.empty``.  The weights are packed per device
by ``pack_update_weights`` (``FusedUpdate.packed``).  The kernel has no
backward: under grad it refuses an input or a weight that requires grad.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from eemflow_tpu_torch.kernels import build, launch_counts, refuse_grad
from eemflow_tpu_torch.ops.update_block import FusedUpdate, gru_flowhead_plain, motion_encoder_plain

NCONV = 11
COUT_ALIGN = 64  # the kernel's widest output tile
MOTION_C = 128   # the motion features: conv's 126 channels and the flow


class _T4(ctypes.Structure):
    """Mirror of ``struct T4``: a tensor as (b, y, x, c) with element strides."""

    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong), ("sy", ctypes.c_longlong),
                ("sx", ctypes.c_longlong), ("sc", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    """Mirror of ``struct UpdateBlockArgs`` in ``csrc/update_block.cu``."""

    _fields_ = [
        ("corr", _T4), ("flow", _T4), ("net", _T4), ("inp", _T4),
        ("motion", _T4), ("net_out", _T4), ("delta", _T4),
        ("c1", _T4), ("c2", _T4), ("f1", _T4), ("f2", _T4),
        ("z", _T4), ("rh", _T4), ("h1", _T4), ("d1", _T4),
        ("w", ctypes.c_void_p * NCONV), ("b", ctypes.c_void_p * NCONV),
        ("cout_pad", ctypes.c_int * NCONV),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("corr_c", ctypes.c_int), ("hidden", ctypes.c_int), ("context", ctypes.c_int),
        ("bf16", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = build.load()
    if lib.update_block_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("update_block: the binding's argument struct differs from the kernel's")
    return lib


def _pack(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], bf16: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW convs stacked along their outputs → ([KH·KW·Cin, Cout padded],
    [Cout padded]) float32 on ``device``, the weights rounded to bf16 in
    bf16 mode."""
    w = torch.cat([t.detach().to(device, torch.float32) for t in ws], dim=0)
    b = torch.cat([t.detach().to(device, torch.float32) for t in bs], dim=0)
    cout, cin, kh, kw = w.shape
    p = w.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    if bf16:
        p = p.to(torch.bfloat16).float()
    pad = -cout % COUT_ALIGN
    return F.pad(p, (0, pad)).contiguous(), F.pad(b, (0, pad)).contiguous()


def pack_update_weights(motion, gru, bf16: bool, device) -> Dict:
    """The eleven convs the kernel runs, in its layout: convc1, convc2,
    convf1, convf2, conv; z|r and q of the 1×5 stage, of the 5×1 stage;
    the flow head's two convs."""
    one = lambda wb: _pack([wb[0]], [wb[1]], bf16, device)
    zr = lambda z, r: _pack([z[0], r[0]], [z[1], r[1]], bf16, device)
    convs = [one(wb) for wb in motion]
    convs += [zr(gru[0], gru[1]), one(gru[2]), zr(gru[3], gru[4]), one(gru[5])]
    convs += [one(gru[6]), one(gru[7])]
    hidden = gru[2][0].shape[0]
    # (Cout, Cin, KH, KW) of each conv as the kernel's launch sequence fixes them
    fixed = [(256, None, 1, 1), (192, 256, 3, 3), (128, 2, 7, 7), (64, 128, 3, 3), (126, 256, 3, 3)]
    fixed += [(hidden, None, 1, 5)] * 3 + [(hidden, None, 5, 1)] * 3 + [(256, hidden, 3, 3), (2, 256, 3, 3)]
    for (w, _), want in zip(list(motion) + list(gru), fixed):
        got = tuple(w.shape)
        if any(g != x for g, x in zip(got, want) if x is not None):
            raise ValueError(f"update_block: a conv of shape {got} where the kernel runs {want}")
    return {
        "convs": convs,
        "corr_c": motion[0][0].shape[1],
        "hidden": hidden,
        "context": gru[2][0].shape[1] - gru[2][0].shape[0] - MOTION_C,
    }


def _t4(t: torch.Tensor) -> _T4:
    """An NHWC tensor (any strides) as the kernel's (b, y, x, c) view."""
    sb, sy, sx, sc = t.stride()
    return _T4(t.data_ptr(), sb, sy, sx, sc)


def _scratch(B: int, H: int, W: int, C: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty((B, H, W, C), dtype=torch.float32, device=like.device)


def _check(name: str, tensors, shapes) -> None:
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 inputs only, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: every input must be on one device")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(entry: str, a: _Args, device: torch.device) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, entry)(ctypes.byref(a), ctypes.c_void_p(stream))
    build.check(rc, "update_block")
    launch_counts["update_block"] += 1


def _args(packed: Dict, B: int, H: int, W: int, bf16: bool) -> _Args:
    a = _Args()
    for i, (w, b) in enumerate(packed["convs"]):
        a.w[i], a.b[i], a.cout_pad[i] = w.data_ptr(), b.data_ptr(), w.shape[1]
    a.B, a.H, a.W = B, H, W
    a.corr_c, a.hidden, a.context = packed["corr_c"], packed["hidden"], packed["context"]
    a.bf16 = int(bf16)
    return a


def update_motion(corr: torch.Tensor, flow: torch.Tensor, fused: FusedUpdate) -> torch.Tensor:
    """corr [B, H, W, Cc], flow [B, H, W, 2] → motion [B, H, W, 128]
    float32: the first K5 entry point on the card, ``motion_encoder_plain``
    on the CPU."""
    if corr.device.type == "cpu":
        return motion_encoder_plain(corr, flow, fused.motion, fused.dtype)
    if corr.device.type != "cuda":
        raise ValueError(f"update_block: unsupported device {corr.device}")
    refuse_grad("update_block", corr, flow, *fused.tensors())
    packed = fused.packed(corr.device)
    if corr.dim() != 4:
        raise ValueError(f"update_block: corr must be [B, H, W, C], got {tuple(corr.shape)}")
    B, H, W, _ = corr.shape
    _check("update_block", (corr, flow), ((B, H, W, packed["corr_c"]), (B, H, W, 2)))
    bf16 = fused.dtype == torch.bfloat16
    a = _args(packed, B, H, W, bf16)
    motion = _scratch(B, H, W, MOTION_C, corr)
    a.corr, a.flow, a.motion = _t4(corr), _t4(flow), _t4(motion)
    keep = [_scratch(B, H, W, c, corr) for c in (256, 192, 128, 64)]
    a.c1, a.c2, a.f1, a.f2 = (_t4(t) for t in keep)
    _launch("update_block_motion_launch", a, corr.device)
    return motion


def update_gru(
    net: torch.Tensor, inp: torch.Tensor, motion: torch.Tensor, fused: FusedUpdate
) -> Tuple[torch.Tensor, torch.Tensor]:
    """net [B, H, W, hidden], inp [B, H, W, context], motion [B, H, W, 128]
    → (net' [B, H, W, hidden], Δflow [B, H, W, 2]) float32: the second K5
    entry point on the card, ``gru_flowhead_plain`` on the CPU."""
    if net.device.type == "cpu":
        return gru_flowhead_plain(net, inp, motion, fused.gru, fused.dtype)
    if net.device.type != "cuda":
        raise ValueError(f"update_block: unsupported device {net.device}")
    refuse_grad("update_block", net, inp, motion, *fused.tensors())
    packed = fused.packed(net.device)
    if net.dim() != 4:
        raise ValueError(f"update_block: net must be [B, H, W, C], got {tuple(net.shape)}")
    B, H, W, _ = net.shape
    hd, ctx = packed["hidden"], packed["context"]
    _check("update_block", (net, inp, motion), ((B, H, W, hd), (B, H, W, ctx), (B, H, W, MOTION_C)))
    a = _args(packed, B, H, W, fused.dtype == torch.bfloat16)
    net_out = _scratch(B, H, W, hd, net)
    delta = _scratch(B, H, W, 2, net)
    a.net, a.inp, a.motion, a.net_out, a.delta = (_t4(t) for t in (net, inp, motion, net_out, delta))
    keep = [_scratch(B, H, W, c, net) for c in (hd, hd, hd, 256)]
    a.z, a.rh, a.h1, a.d1 = (_t4(t) for t in keep)
    _launch("update_block_gru_launch", a, net.device)
    return net_out, delta
