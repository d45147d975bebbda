"""K1 wrapper: events → voxel grid on the card (``csrc/voxel_scatter.cu``),
unnormalized (``voxel_scatter``) or normalized (``voxelize``), each with its
plain twin on the CPU.

Replaces ``eemflow_tpu/ops/pallas/voxel_scatter.py`` ``voxel_scatter_pallas``
and, in ``voxelize``, the normalization its caller runs after it
(``eemflow_tpu/events/voxel.py`` ``normalize_voxel_grid``).  On the card
the grid is allocated with ``torch.empty`` and written once by the kernel,
tile by tile: no zero-fill, no global atomics into it.
"""

from __future__ import annotations

import ctypes

import torch

from eemflow_tpu_torch.events.voxel import voxel_scatter_plain, voxelize_plain
from eemflow_tpu_torch.kernels import build, launch_counts, refuse_grad, stream_handle

plain = voxel_scatter_plain

TILE = 32             # pixels a side of the tile one CTA writes
MAX_BINS = 48         # bins × 4 KB of shared memory a tile
MAX_TILES = 40_960    # an int counter a tile beside 64 KB of staged votes
EVENTS_PER_CTA = 4096 # events one CTA of the binning pass takes
MAX_SMEM = 232_448    # shared memory one block may opt into on sm_90
# the kernel's modes: the unnormalized grid; the normalized grid, its records
# added again to write it
MODES = {"scatter": 0, "voxelize": 1}


def voxel_scatter(
    events: torch.Tensor, n_valid: torch.Tensor, num_bins: int, height: int, width: int
) -> torch.Tensor:
    """[B, N, 4] float32 (t, x, y, p) events + [B] int32 counts →
    [B, bins, H, W] float32 UNNORMALIZED voxel grid."""
    if events.device.type == "cpu":
        return plain(events, n_valid, num_bins, height, width)
    return _launch(events, n_valid, num_bins, height, width, "scatter")


def voxelize(
    events: torch.Tensor, n_valid: torch.Tensor, num_bins: int, height: int, width: int
) -> torch.Tensor:
    """[B, N, 4] float32 (t, x, y, p) events + [B] int32 counts →
    [B, bins, H, W] float32 grid, normalized per sample over its nonzero
    cells (``normalize_voxel_grid`` of the unnormalized grid)."""
    if events.device.type == "cpu":
        return voxelize_plain(events, n_valid, num_bins, height, width)
    return _launch(events, n_valid, num_bins, height, width, "voxelize")


def _launch(
    events: torch.Tensor, n_valid: torch.Tensor, num_bins: int, height: int, width: int, mode: str
) -> torch.Tensor:
    name = "voxel_scatter" if mode == "scatter" else "voxelize"
    if events.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {events.device}")
    refuse_grad(name, events)
    if events.dim() != 3 or events.shape[-1] != 4 or events.dtype != torch.float32:
        raise ValueError(f"{name}: events must be [B, N, 4] float32, got {tuple(events.shape)} {events.dtype}")
    B, N, _ = events.shape
    if tuple(n_valid.shape) != (B,) or n_valid.dtype != torch.int32:
        raise ValueError(f"{name}: n_valid must be [B] int32")
    if n_valid.device != events.device:
        raise ValueError(f"{name}: events and n_valid must be on one device")
    if not events.is_contiguous() or events.data_ptr() % 16:
        raise ValueError(f"{name}: events must be contiguous and 16-byte aligned")
    if not n_valid.is_contiguous():
        raise ValueError(f"{name}: n_valid must be contiguous")
    if min(num_bins, height, width) <= 0:
        raise ValueError(f"{name}: bins, height and width must be positive")
    if num_bins > MAX_BINS:
        raise ValueError(f"{name}: at most {MAX_BINS} bins, got {num_bins}")
    if -(-height // TILE) * -(-width // TILE) > MAX_TILES:
        raise ValueError(f"{name}: a {height}x{width} frame has more than {MAX_TILES} tiles of {TILE}x{TILE}")
    # a tile's CTA keeps its cells and one (source, offset) pair per binning CTA
    if num_bins * TILE * TILE * 4 + -(-N // EVENTS_PER_CTA) * 12 > MAX_SMEM - 1024:
        raise ValueError(f"{name}: {N} events and {num_bins} bins exceed a tile CTA's shared memory")
    lib = build.load()
    grid = torch.empty((B, num_bins, height, width), dtype=torch.float32, device=events.device)
    scratch = torch.empty(lib.voxel_grid_scratch_bytes(B, N, num_bins, height, width),
                          dtype=torch.uint8, device=events.device)
    rc = lib.voxel_grid_launch(
        events.data_ptr(), n_valid.data_ptr(), grid.data_ptr(), scratch.data_ptr(),
        B, N, num_bins, height, width, MODES[mode], ctypes.c_void_p(stream_handle(events.device)),
    )
    build.check(rc, name)
    launch_counts["voxel_scatter"] += 1
    return grid
