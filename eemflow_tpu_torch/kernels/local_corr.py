"""K2 wrapper: windowed local correlation on the card (``csrc/local_corr.cu``),
its plain twin on the CPU.

Replaces ``eemflow_tpu/ops/pallas/local_corr.py`` ``local_correlation_pallas``
and its custom VJP.  ``local_corr_levels`` computes up to three levels of
different C and H×W in one launch, reading each input through its strides
(EEMFlow's permuted NCHW views need no copy) and writing each output
channels-first, the layout the decoder's concatenation reads;
``local_corr`` is the same kernel with one level and an NHWC output.
Inputs are float32, or bf16 (the training forward's mixed precision, as
the JAX kernel computes in its input's dtype): bf16 operands are multiplied
and summed in float32 and the result rounded to bf16 once, the plain
version's definition too.  When a gradient is wanted, ``local_corr_levels``
goes through ``LocalCorrLevels`` and ``local_corr`` through ``LocalCorr``,
``autograd.Function``s whose forward is the kernel on the card (one launch
for all levels; the twin on the CPU) and whose backward is the autograd of
the twin's function, recomputed level by level from the saved inputs
(``_plain_vjp``) — as the JAX ``_bwd`` is the VJP of the XLA formulation,
not a kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from eemflow_tpu_torch.kernels import build, launch_counts, stream_handle
from eemflow_tpu_torch.ops.correlation import (
    local_correlation_plain,
    local_correlation_windowed,
    selected_displacements,
)

plain = local_correlation_plain

MAX_LEVELS = 3
MAX_K = 289          # a full window up to md = 8
THREADS = 512
OUT_PER_THREAD = 4   # outputs a thread can own: rows * cols * K <= THREADS * OUT_PER_THREAD
OUT_TARGET = 1024    # outputs the plan gives a CTA, so that a 12x20 level takes 24 CTAs a sample
SMEM_BUDGET = 100 * 1024  # staging per CTA, so that two CTAs share an SM


class _Level(ctypes.Structure):
    """Mirror of ``struct CorrLevel`` in ``csrc/local_corr.cu``."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("y", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("xs", ctypes.c_longlong * 4), ("ys", ctypes.c_longlong * 4), ("os", ctypes.c_longlong * 4),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int), ("C", ctypes.c_int),
        ("rows", ctypes.c_int), ("cols", ctypes.c_int), ("cc", ctypes.c_int), ("cs", ctypes.c_int),
        ("bands", ctypes.c_int), ("ctiles", ctypes.c_int), ("first_block", ctypes.c_int),
        ("inv_c", ctypes.c_float),
    ]


class _Args(ctypes.Structure):
    """Mirror of ``struct CorrArgs`` in ``csrc/local_corr.cu``."""

    _fields_ = [
        ("lv", _Level * MAX_LEVELS),
        ("nlevels", ctypes.c_int), ("K", ctypes.c_int), ("md", ctypes.c_int),
        ("blocks", ctypes.c_int), ("smem_bytes", ctypes.c_int), ("dtype", ctypes.c_int),
        ("idx", ctypes.c_int * MAX_K),
    ]


# the kernel's element types (``CorrArgs::dtype``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load()
        if lib.local_corr_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("local_corr: the binding's argument struct differs from the kernel's")
        _lib = lib
    return _lib


def channel_stride(cc: int) -> int:
    """Floats a staged position takes for a channel chunk of ``cc``: odd, so
    that neighbouring positions of a channels-innermost input fall in
    different banks (a channel-planar input takes ``cc`` planes, no more)."""
    return cc | 1


def staging_bytes(rows: int, cols: int, cc: int, md: int) -> int:
    """Shared memory of one CTA: the X tile and Y's halo."""
    return (rows * cols + (rows + 2 * md) * (cols + 2 * md)) * channel_stride(cc) * 4


def _max_chunk(rows: int, cols: int, md: int) -> int:
    """The largest channel chunk whose staging fits ``SMEM_BUDGET`` (0 if
    none does)."""
    stride = SMEM_BUDGET // (4 * (rows * cols + (rows + 2 * md) * (cols + 2 * md)))
    return stride if stride % 2 else stride - 1  # an even chunk takes one float more


def plan_level(H: int, W: int, C: int, K: int, md: int) -> Tuple[int, int, int]:
    """(rows, cols, cc) of one level's CTA tile: up to ``OUT_TARGET``
    outputs, the width split into equal column tiles and as many rows as
    then fit; then the largest channel chunk whose staging fits
    ``SMEM_BUDGET``, the tile shrunk until one channel does."""
    most = OUT_TARGET // K
    if most < 1:
        raise ValueError(f"local_corr: K={K} displacements exceed what a CTA computes")
    cols = -(-W // -(-W // most))
    rows = max(1, min(H, most // cols))
    while _max_chunk(rows, cols, md) < 1:
        if rows > 1:
            rows -= 1
        elif cols > 1:
            cols -= 1
        else:
            raise ValueError(f"local_corr: md={md} leaves no room for a tile in shared memory")
    return rows, cols, min(C, _max_chunk(rows, cols, md))


def _check(x: torch.Tensor, y: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"{name}: x and y must be equal [B, H, W, C], got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in DTYPES or y.dtype != x.dtype:
        raise ValueError(f"{name}: x and y must both be float32 or both bf16, got {x.dtype} and {y.dtype}")
    if y.device != x.device:
        raise ValueError(f"{name}: x and y must be on one device")


class _Plan:
    """One launch's level table for given shapes, strides, types and
    devices (each call copies it and sets the pointers in its copy), and
    where each level's output lies in the one buffer allocated for them."""

    def __init__(self, pairs, out_strides, max_displacement: int, wanted: Tuple[int, ...]):
        K = len(wanted)
        if K > MAX_K:
            raise ValueError(f"local_corr: at most {MAX_K} displacements, got {K}")
        self.args = args = _Args()
        args.nlevels, args.K, args.md = len(pairs), K, max_displacement
        args.dtype = DTYPES[pairs[0][0].dtype]
        self.dtype = pairs[0][0].dtype
        args.idx[:K] = wanted
        self.outs = []  # (size, stride, offset) of each output in the buffer
        blocks = smem = at = 0
        for lv, (x, y), os_ in zip(args.lv, pairs, out_strides):
            B, H, W, C = x.shape
            rows, cols, cc = plan_level(H, W, C, K, max_displacement)
            lv.xs[:], lv.ys[:], lv.os[:] = x.stride(), y.stride(), os_
            lv.B, lv.H, lv.W, lv.C = B, H, W, C
            lv.rows, lv.cols, lv.cc, lv.cs = rows, cols, cc, channel_stride(cc)
            lv.bands, lv.ctiles = -(-H // rows), -(-W // cols)
            lv.first_block = blocks
            lv.inv_c = float(np.float32(1.0 / C))
            blocks += B * lv.bands * lv.ctiles
            smem = max(smem, staging_bytes(rows, cols, cc, max_displacement))
            self.outs.append(((B, H, W, K), os_, at))
            at += B * H * W * K
        args.blocks, args.smem_bytes = blocks, smem
        self.numel = at
        self.device = pairs[0][0].device


# plans by (md, displacements, output layout, each level's shapes, strides,
# types and devices): a call seen before is not checked or planned again
_plans: Dict[tuple, _Plan] = {}
MAX_PLANS = 256  # past this many shapes the cache starts over


@functools.lru_cache(maxsize=64)
def _wanted(max_displacement: int, indices: Optional[Tuple[int, ...]]) -> Tuple[int, ...]:
    return selected_displacements(max_displacement, indices)


def _run(pairs, max_displacement: int, indices, channels_first: bool) -> List[torch.Tensor]:
    """One launch over the levels ``pairs`` ((x, y) as [B, H, W, C] views of
    any strides): [B, H, W, K] results, channels-first in memory or NHWC."""
    wanted = _wanted(max_displacement, None if indices is None else tuple(indices))
    key = (max_displacement, wanted, channels_first,
           tuple((x.shape, x.stride(), y.shape, y.stride(), x.dtype, y.dtype, x.device, y.device) for x, y in pairs))
    plan = _plans.get(key)
    if plan is None:
        for x, y in pairs:
            _check(x, y, "local_corr")
        if any(x.device != pairs[0][0].device for x, _ in pairs):
            raise ValueError("local_corr_levels: all levels must be on one device")
        if any(x.dtype != pairs[0][0].dtype for x, _ in pairs):
            raise ValueError("local_corr_levels: all levels must have one dtype")
        K = len(wanted)
        out_strides = [
            (K * H * W, W, 1, H * W) if channels_first else (H * W * K, W * K, K, 1)
            for B, H, W, _ in (x.shape for x, _ in pairs)
        ]
        if len(_plans) >= MAX_PLANS:
            _plans.clear()
        plan = _plans[key] = _Plan(pairs, out_strides, max_displacement, wanted)
    buf = torch.empty(plan.numel, dtype=plan.dtype, device=plan.device)
    outs = [buf.as_strided(*o) for o in plan.outs]
    # this call's own copy of the table, so that calls from other threads
    # with the same shapes cannot swap pointers into it
    args = _Args.from_buffer_copy(plan.args)
    for lv, (x, y), o in zip(args.lv, pairs, outs):
        lv.x, lv.y, lv.out = x.data_ptr(), y.data_ptr(), o.data_ptr()
    rc = _library().local_corr_levels_launch(ctypes.byref(args), ctypes.c_void_p(stream_handle(plan.device)))
    build.check(rc, "local_corr")
    launch_counts["local_corr"] += 1
    return outs


def local_corr_levels(
    pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    max_displacement: int = 4,
    indices: Optional[Sequence[int]] = None,
) -> List[torch.Tensor]:
    """Up to three levels of NHWC (x, y) [B, H, W, C_l], float32 or bf16 →
    a list of [B, H, W, K] of that dtype; on the card one launch, each
    result a view of a channels-first [B, K, H, W] tensor
    (``.permute(0, 3, 1, 2)`` of it is contiguous).  Differentiable in every
    x and y (one ``LocalCorrLevels`` under grad, still one launch)."""
    if not 1 <= len(pairs) <= MAX_LEVELS:
        raise ValueError(f"local_corr_levels: 1 to {MAX_LEVELS} levels, got {len(pairs)}")
    if torch.is_grad_enabled() and any(x.requires_grad or y.requires_grad for x, y in pairs):
        wanted = None if indices is None else tuple(int(i) for i in indices)
        return list(LocalCorrLevels.apply(max_displacement, wanted, *(t for xy in pairs for t in xy)))
    return _levels_forward(pairs, max_displacement, indices)


def _levels_forward(pairs, max_displacement: int, indices) -> List[torch.Tensor]:
    """The twin level by level on the CPU, one kernel launch on the card;
    no autograd."""
    if all(x.device.type == "cpu" for x, _ in pairs):
        return [plain(x, y, max_displacement, indices) for x, y in pairs]
    return _run(pairs, max_displacement, indices, channels_first=True)


def local_corr(
    x: torch.Tensor,
    y: torch.Tensor,
    max_displacement: int = 4,
    indices: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """NHWC x, y [B, H, W, C], float32 or bf16 → [B, H, W, K] of that
    dtype (NHWC contiguous), differentiable in x and y."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        wanted = None if indices is None else tuple(int(i) for i in indices)
        return LocalCorr.apply(x, y, max_displacement, wanted)
    return _forward(x, y, max_displacement, indices)


class LocalCorr(torch.autograd.Function):
    """K2 with the twin's backward (the JAX custom VJP's counterpart)."""

    @staticmethod
    def forward(ctx, x, y, max_displacement, indices):
        ctx.save_for_backward(x, y)
        ctx.max_displacement = max_displacement
        ctx.indices = indices
        return _forward(x, y, max_displacement, indices)

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        gx, gy = _plain_vjp(x, y, grad, ctx.needs_input_grad[:2], ctx.max_displacement, ctx.indices)
        return gx, gy, None, None


class LocalCorrLevels(torch.autograd.Function):
    """``local_corr_levels`` with the twin's backward: the forward is one
    kernel launch for every level, the backward ``_plain_vjp`` of each
    level at its saved inputs.  Inputs: the displacement settings, then x
    and y of each level in turn."""

    @staticmethod
    def forward(ctx, max_displacement, indices, *xy):
        ctx.save_for_backward(*xy)
        ctx.max_displacement = max_displacement
        ctx.indices = indices
        pairs = list(zip(xy[0::2], xy[1::2]))
        return tuple(_levels_forward(pairs, max_displacement, indices))

    @staticmethod
    def backward(ctx, *grads):
        xy = ctx.saved_tensors
        out = [None, None]
        for level, grad in enumerate(grads):
            need = ctx.needs_input_grad[2 + 2 * level: 4 + 2 * level]
            out += _plain_vjp(xy[2 * level], xy[2 * level + 1], grad, need,
                              ctx.max_displacement, ctx.indices)
        return tuple(out)


def _plain_vjp(x, y, grad, need, max_displacement, indices):
    """(dx, dy) of the twin's function at (x, y) for the output gradient
    ``grad``, by autograd through its windowed formulation (a dozen ops a
    level, where the displacement-by-displacement one takes hundreds of
    small launches and holds a training step to the host's pace); None for
    an input whose gradient ``need`` does not ask for."""
    if not any(need):
        return [None, None]
    with torch.enable_grad():
        xd = x.detach().requires_grad_(need[0])
        yd = y.detach().requires_grad_(need[1])
        out = local_correlation_windowed(xd, yd, max_displacement, indices)
        grads = iter(torch.autograd.grad(out, [t for t in (xd, yd) if t.requires_grad], grad))
    return [next(grads) if n else None for n in need]


def _forward(
    x: torch.Tensor,
    y: torch.Tensor,
    max_displacement: int,
    indices: Optional[Sequence[int]],
) -> torch.Tensor:
    """The twin on the CPU, the kernel (one level) on the card; no autograd."""
    if x.device.type == "cpu":
        return plain(x, y, max_displacement, indices)
    return _run([(x, y)], max_displacement, indices, channels_first=False)[0]
