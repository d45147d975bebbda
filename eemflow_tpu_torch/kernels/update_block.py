"""K5 wrapper: the RAFT update block without its mask head on the card
(``csrc/update_block.cu``), its plain version on the CPU.

Replaces ``eemflow_tpu/ops/pallas/update_block.py`` ``motion_encoder_fused``
and ``gru_flowhead_fused``: ``update_motion`` and ``update_gru`` each make
one call of their C entry point (``update_block_motion_launch``,
``update_block_gru_launch``), which enqueues a fixed sequence of conv
launches on PyTorch's current stream, and add one to
``launch_counts["update_block"]``.  The kernel reads its inputs as
pixel-linear NHWC (``needs_relayout``); an input that is not is copied
first, each copy counted in ``launch_counts["update_block_relayout"]``.
Intermediates go to scratch allocated here with ``torch.empty``.

The weights are packed per device by ``pack_update_weights``
(``FusedUpdate.packed``): each conv's OIHW weight in the kernel's K order
(tap, then source, then its channels padded to ``BK``; the flow conv tap,
then channel), then per (K step, 8 output channels) in the order the
``mma`` fragments are read.  float32 mode stores two TF32 planes,
w = big + small (``tf32_split``); bf16 mode stores bf16.  The kernel has no
backward: under grad it refuses an input or a weight that requires grad.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from eemflow_tpu_torch.kernels import build, launch_counts, refuse_grad
from eemflow_tpu_torch.ops.update_block import FusedUpdate, gru_flowhead_plain, motion_encoder_plain

NCONV = 11
BK = 32          # K values of one kernel step
MOTION_C = 128   # the motion features: conv's 126 channels and the flow
# the kernel's CTA tiles and their names in update_block_kernel_info
TILES = ("wide", "mid", "narrow", "thin")
KERNEL_INFO = ("BM", "BN", "threads", "stages", "smem_bytes", "registers", "local_bytes", "ctas_per_sm")


class _Plane(ctypes.Structure):
    """Mirror of ``struct Plane``: an NHWC tensor as (pointer, pixel stride)."""

    _fields_ = [("p", ctypes.c_void_p), ("sx", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    """Mirror of ``struct UpdateBlockArgs`` in ``csrc/update_block.cu``."""

    _fields_ = [
        ("corr", _Plane), ("flow", _Plane), ("net", _Plane), ("inp", _Plane),
        ("motion", _Plane), ("net_out", _Plane), ("delta", _Plane),
        ("c1", _Plane), ("c2", _Plane), ("f1", _Plane), ("f2", _Plane),
        ("z", _Plane), ("rh", _Plane), ("h1", _Plane), ("d1", _Plane),
        ("w", ctypes.c_void_p * NCONV), ("b", ctypes.c_void_p * NCONV),
        ("n_pad", ctypes.c_int * NCONV),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("corr_c", ctypes.c_int), ("hidden", ctypes.c_int), ("context", ctypes.c_int),
        ("bf16", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = build.load()
    if lib.update_block_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("update_block: the binding's argument struct differs from the kernel's")
    return lib


def kernel_info() -> List[Dict]:
    """Each conv kernel instance on the current card: tile, mode, threads,
    ring stages, dynamic shared memory, registers, local (spill) bytes and
    the CTAs an SM holds."""
    lib = _library()
    out = []
    for bf16 in (False, True):
        for tile, name in enumerate(TILES):
            info = (ctypes.c_int * len(KERNEL_INFO))()
            build.check(lib.update_block_kernel_info(tile, int(bf16), info), "update_block_kernel_info")
            out.append({"tile": name, "mode": "bf16" if bf16 else "float32", **dict(zip(KERNEL_INFO, info))})
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties away
    from zero; the low 13 bits of the result are zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = big + small (to 2^-22·|x|), both TF32: the planes whose three
    products big·big + big·small + small·big keep float32 accuracy."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def conv_sources(corr_c: int, hidden: int, context: int) -> List:
    """The sources (input channel counts, in order) each of the eleven convs
    reads, as the C entry points launch them; None is convf1's gather of the
    2-channel flow."""
    gru = [hidden, context, MOTION_C]
    return [[corr_c], [256], None, [128], [192, 64], gru, gru, gru, gru, [hidden], [256]]


def k_order(w: torch.Tensor, sources) -> torch.Tensor:
    """OIHW → [K padded to BK, Cout]: the rows in the order the kernel's
    steps read them: tap, then source, then its channels padded to a
    multiple of BK with zero rows; for the flow gather (``sources`` None)
    tap, then channel, padded at the end."""
    cout, cin, kh, kw = w.shape
    taps = w.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout)
    if sources is None:
        k = taps.reshape(kh * kw * cin, cout)
        return F.pad(k, (0, 0, 0, -k.shape[0] % BK))
    if sum(sources) != cin:
        raise ValueError(f"update_block: sources {sources} do not add up to {cin} input channels")
    parts, c0 = [], 0
    for c in sources:
        parts.append(F.pad(taps[:, c0:c0 + c], (0, 0, 0, -c % BK)))
        c0 += c
    return torch.cat(parts, dim=1).reshape(-1, cout)


def fragment_order(k: torch.Tensor, bf16: bool) -> torch.Tensor:
    """[K, N] (K a multiple of BK, N of 8) → the packed blocks, one per
    (step s, 8 output channels j), lane = 4g + t holding column 8j + g:

      float32 [s, j, kk, plane, g, t, h]: K row 8kk + 4h + t of the step,
        plane 0 big, 1 small (the b0, b1 of mma m16n8k8.tf32; a plane's
        32 lanes are one conflict-free 8-byte read);
      bf16 [s, j, kk, g, t, q, h]: K row 16kk + 8q + 4h + t, register q,
        half h (b0..b3 of mma m16n8k16, K permuted within the k16 step the
        way the kernel builds its A fragment)."""
    steps, n8 = k.shape[0] // BK, k.shape[1] // 8
    if bf16:
        v = k.reshape(steps, BK // 16, 2, 2, 4, n8, 8)  # s, kk, q, h, t, j, g
        return v.permute(0, 5, 1, 6, 4, 2, 3).to(torch.bfloat16).contiguous()
    v = k.reshape(steps, BK // 8, 2, 4, n8, 8).permute(0, 4, 1, 5, 3, 2)  # s, j, kk, g, t, h
    return torch.stack(tf32_split(v), dim=3).contiguous()


def pack_conv(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], sources, bf16: bool,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW convs stacked along their outputs → (packed weights, bias padded
    to N) on ``device``; N is Cout padded to 8 for the flow head's 2
    channels, else to 64."""
    w = torch.cat([t.detach().to(device, torch.float32) for t in ws], dim=0)
    b = torch.cat([t.detach().to(device, torch.float32) for t in bs], dim=0)
    cout = w.shape[0]
    pad = -cout % (8 if cout <= 8 else 64)
    return fragment_order(F.pad(k_order(w, sources), (0, pad)), bf16), F.pad(b, (0, pad)).contiguous()


def pack_update_weights(motion, gru, bf16: bool, device) -> Dict:
    """The eleven convs the kernel runs, in its layout: convc1, convc2,
    convf1, convf2, conv; z|r and q of the 1×5 stage, of the 5×1 stage;
    the flow head's two convs."""
    hidden = gru[2][0].shape[0]
    corr_c = motion[0][0].shape[1]
    context = gru[2][0].shape[1] - hidden - MOTION_C
    # (Cout, Cin, KH, KW) of each conv as the kernel's launch sequence fixes them
    fixed = [(256, None, 1, 1), (192, 256, 3, 3), (128, 2, 7, 7), (64, 128, 3, 3), (126, 256, 3, 3)]
    fixed += [(hidden, None, 1, 5)] * 3 + [(hidden, None, 5, 1)] * 3 + [(256, hidden, 3, 3), (2, 256, 3, 3)]
    for (w, _), want in zip(list(motion) + list(gru), fixed):
        got = tuple(w.shape)
        if any(g != x for g, x in zip(got, want) if x is not None):
            raise ValueError(f"update_block: a conv of shape {got} where the kernel runs {want}")
    if corr_c % 4 or hidden % 4 or context % 4:
        raise ValueError(f"update_block: channel counts must be multiples of 4 (corr {corr_c}, "
                         f"hidden {hidden}, context {context})")
    srcs = conv_sources(corr_c, hidden, context)
    groups = [[wb] for wb in motion] + [[gru[0], gru[1]], [gru[2]], [gru[3], gru[4]], [gru[5]], [gru[6]], [gru[7]]]
    convs = [pack_conv([w for w, _ in g], [b for _, b in g], s, bf16, device) for g, s in zip(groups, srcs)]
    return {"convs": convs, "corr_c": corr_c, "hidden": hidden, "context": context}


def needs_relayout(t: torch.Tensor, align: int = 4) -> bool:
    """True unless the kernel's loader can read ``t`` [B, H, W, C] where it
    lies: channel stride 1 and element (b, y, x, c) at p[m·sx + c] with m =
    (b·H + y)·W + x, a pixel stride sx that is a multiple of ``align``
    floats and p aligned to ``align`` floats (4: 16-byte copies; 2 for the
    flow's 8-byte ones).  Strides of size-1 dimensions do not matter."""
    B, H, W, C = t.shape
    sb, sy, sx, sc = t.stride()
    return ((C > 1 and sc != 1) or sx % align != 0 or t.data_ptr() % (4 * align) != 0
            or (H > 1 and sy != W * sx) or (B > 1 and sb != H * W * sx))


def _readable(t: torch.Tensor, align: int = 4) -> torch.Tensor:
    """``t`` itself, or a fresh channels-last copy (counted) when the
    kernel cannot read it where it lies."""
    if not needs_relayout(t, align):
        return t
    launch_counts["update_block_relayout"] += 1
    return t.clone(memory_format=torch.contiguous_format)


def _plane(t: torch.Tensor) -> _Plane:
    """A pixel-linear tensor (``needs_relayout`` False: its W stride is the
    pixel stride, whatever the sizes) as (pointer, pixel stride)."""
    return _Plane(t.data_ptr(), t.stride(2))


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
        a.w[i], a.b[i], a.n_pad[i] = w.data_ptr(), b.data_ptr(), b.numel()
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
    corr, flow = _readable(corr), _readable(flow, align=2)
    a = _args(packed, B, H, W, fused.dtype == torch.bfloat16)
    motion = _scratch(B, H, W, MOTION_C, corr)
    a.corr, a.flow, a.motion = _plane(corr), _plane(flow), _plane(motion)
    keep = [_scratch(B, H, W, c, corr) for c in (256, 192, 128, 64)]
    a.c1, a.c2, a.f1, a.f2 = (_plane(t) for t in keep)
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
    net, inp, motion = _readable(net), _readable(inp), _readable(motion)
    a = _args(packed, B, H, W, fused.dtype == torch.bfloat16)
    net_out = _scratch(B, H, W, hd, net)
    delta = _scratch(B, H, W, 2, net)
    a.net, a.inp, a.motion, a.net_out, a.delta = (_plane(t) for t in (net, inp, motion, net_out, delta))
    keep = [_scratch(B, H, W, c, net) for c in (hd, hd, hd, 256)]
    a.z, a.rh, a.h1, a.d1 = (_plane(t) for t in keep)
    _launch("update_block_gru_launch", a, net.device)
    return net_out, delta
