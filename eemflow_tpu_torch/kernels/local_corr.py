"""K2 wrapper: windowed local correlation on the card (``csrc/local_corr.cu``),
its plain twin on the CPU.

Replaces ``eemflow_tpu/ops/pallas/local_corr.py`` ``local_correlation_pallas``
and its custom VJP.  When a gradient is wanted, the call goes through
``LocalCorr``, an ``autograd.Function`` whose forward is the kernel on the
card (the twin on the CPU) and whose backward is the twin's autograd,
recomputed from the saved ``x`` and ``y`` — as the JAX ``_bwd`` is the VJP
of the XLA formulation, not a kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from eemflow_tpu_torch.kernels import build, launch_counts
from eemflow_tpu_torch.ops.correlation import local_correlation_plain, selected_displacements

plain = local_correlation_plain

# displacement-index tables already on a device, keyed by (indices, device)
_index_cache: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def _device_indices(wanted: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    key = (wanted, device)
    t = _index_cache.get(key)
    if t is None:
        t = torch.tensor(wanted, dtype=torch.int32, device=device)
        _index_cache[key] = t
    return t


def local_corr(
    x: torch.Tensor,
    y: torch.Tensor,
    max_displacement: int = 4,
    indices: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """NHWC x, y [B, H, W, C] float32 → [B, H, W, K] float32, differentiable
    in x and y."""
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
        with torch.enable_grad():
            xd = x.detach().requires_grad_(ctx.needs_input_grad[0])
            yd = y.detach().requires_grad_(ctx.needs_input_grad[1])
            out = plain(xd, yd, ctx.max_displacement, ctx.indices)
            wrt = [t for t in (xd, yd) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad))
        gx = next(grads) if ctx.needs_input_grad[0] else None
        gy = next(grads) if ctx.needs_input_grad[1] else None
        return gx, gy, None, None


def _forward(
    x: torch.Tensor,
    y: torch.Tensor,
    max_displacement: int,
    indices: Optional[Sequence[int]],
) -> torch.Tensor:
    """The twin on the CPU, the kernel on the card; no autograd."""
    if x.device.type == "cpu":
        return plain(x, y, max_displacement, indices)
    if x.device.type != "cuda":
        raise ValueError(f"local_corr: unsupported device {x.device}")
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"local_corr: x and y must be equal [B, H, W, C], got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("local_corr: float32 only")
    if y.device != x.device:
        raise ValueError("local_corr: x and y must be on one device")
    wanted = selected_displacements(max_displacement, indices)
    x = x.contiguous()
    y = y.contiguous()
    B, H, W, C = x.shape
    K = len(wanted)
    lib = build.load()
    idx = _device_indices(wanted, x.device)
    out = torch.empty((B, H, W, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    inv_c = float(np.float32(1.0 / C))
    rc = lib.local_corr_launch(
        x.data_ptr(), y.data_ptr(), idx.data_ptr(), out.data_ptr(),
        B, H, W, C, K, max_displacement, inv_c, ctypes.c_void_p(stream),
    )
    build.check(rc, "local_corr")
    launch_counts["local_corr"] += 1
    return out
