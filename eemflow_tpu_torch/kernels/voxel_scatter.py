"""K1 wrapper: event → unnormalized voxel grid on the card
(``csrc/voxel_scatter.cu``), its plain twin on the CPU.

Replaces ``eemflow_tpu/ops/pallas/voxel_scatter.py`` ``voxel_scatter_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from eemflow_tpu_torch.events.voxel import voxel_scatter_plain
from eemflow_tpu_torch.kernels import build, launch_counts, refuse_grad

plain = voxel_scatter_plain


def voxel_scatter(
    events: torch.Tensor, n_valid: torch.Tensor, num_bins: int, height: int, width: int
) -> torch.Tensor:
    """[B, N, 4] float32 (t, x, y, p) events + [B] int32 counts →
    [B, bins, H, W] float32 UNNORMALIZED voxel grid."""
    if events.device.type == "cpu":
        return plain(events, n_valid, num_bins, height, width)
    if events.device.type != "cuda":
        raise ValueError(f"voxel_scatter: unsupported device {events.device}")
    refuse_grad("voxel_scatter", events)
    if events.dim() != 3 or events.shape[-1] != 4 or events.dtype != torch.float32:
        raise ValueError(f"voxel_scatter: events must be [B, N, 4] float32, got {tuple(events.shape)} {events.dtype}")
    B, N, _ = events.shape
    if tuple(n_valid.shape) != (B,) or n_valid.dtype != torch.int32:
        raise ValueError("voxel_scatter: n_valid must be [B] int32")
    if n_valid.device != events.device:
        raise ValueError("voxel_scatter: events and n_valid must be on one device")
    if not events.is_contiguous() or events.data_ptr() % 16:
        raise ValueError("voxel_scatter: events must be contiguous and 16-byte aligned")
    if not n_valid.is_contiguous():
        raise ValueError("voxel_scatter: n_valid must be contiguous")
    if min(num_bins, height, width) <= 0:
        raise ValueError("voxel_scatter: bins, height and width must be positive")
    lib = build.load()
    grid = torch.zeros((B, num_bins, height, width), dtype=torch.float32, device=events.device)
    with torch.cuda.device(events.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.voxel_scatter_launch(
        events.data_ptr(), n_valid.data_ptr(), grid.data_ptr(),
        B, N, num_bins, height, width, ctypes.c_void_p(stream),
    )
    build.check(rc, "voxel_scatter")
    launch_counts["voxel_scatter"] += 1
    return grid
