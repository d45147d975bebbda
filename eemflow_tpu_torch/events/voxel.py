"""Event-stream → voxel-grid binning (counterpart of
``eemflow_tpu/events/voxel.py``).

Semantics (reference ``loader/loader_utils.py:429-537``): events
(t, x, y, p) vote bilinearly in time into a [bins, H, W] grid —
timestamps normalized to ``(bins-1)·(t−t₀)/ΔT`` (ΔT→1 if zero), polarity
±1 (p==0 → −1), ``p·(1−dt)`` into bin ⌊ts⌋ and ``p·dt`` into ⌊ts⌋+1;
out-of-frame events vote nothing.  Normalization works over the nonzero
cells only: subtract the mean and divide by the sample std (ddof=1) when
it is defined and positive.

On the card the scatter, and with ``normalize=True`` the normalization
too, is kernel K1 (``kernels/voxel_scatter.py``: ``voxel_scatter`` and
``voxelize``), which writes the grid once; ``voxel_scatter_plain`` and
``voxelize_plain`` are its plain twins, used for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def pad_events(
    events: np.ndarray, bucket_size: int, out: Optional[np.ndarray] = None
) -> tuple[np.ndarray, int, int]:
    """Pad/truncate an [N,4] event array to [bucket_size, 4] float32.

    Returns (padded, n_valid, n_dropped); ``n_dropped > 0`` means the
    bucket was too small and the caller must count it
    (``data.device_input.EventOverflowCounter``).  ``out``: an optional
    [bucket_size, 4] float32 buffer to fill (``BufferPool``)."""
    n = min(len(events), bucket_size)
    if out is None:
        out = np.empty((bucket_size, 4), dtype=np.float32)
    elif out.shape != (bucket_size, 4) or out.dtype != np.float32:
        raise ValueError("pad_events: out must be a [bucket_size, 4] float32 buffer")
    out[:n] = events[:n]
    out[n:] = 0.0
    return out, n, len(events) - n


class BufferPool:
    """Rotating per-bucket float32 buffers for event packs: a buffer handed
    out is overwritten again only after ``ring`` further requests of the
    same bucket, so its pages stay warm instead of faulting fresh on every
    sample.  Not thread-safe; one pool per loader thread."""

    def __init__(self, ring: int = 16):
        self.ring = max(2, ring)
        self._pool: dict = {}
        self._next: dict = {}

    def ensure_ring(self, ring: int) -> None:
        """Grow the ring (never shrink it).  A consumer that holds more than
        ``ring`` buffers of one bucket at once would read overwritten data:
        ``data.loader.batch_iterator`` sizes it as ``2 * batch_size + 4``
        (two pack buffers a sample, copied by collate only once the whole
        batch is read)."""
        ring = max(self.ring, ring)
        if ring == self.ring:
            return
        self.ring = ring
        for bucket, lst in self._pool.items():
            while len(lst) < ring:
                lst.append(np.zeros((bucket, 4), np.float32))

    def get(self, bucket: int) -> np.ndarray:
        ring = self._pool.get(bucket)
        if ring is None:
            ring = self._pool[bucket] = [
                np.zeros((bucket, 4), np.float32) for _ in range(self.ring)
            ]
            self._next[bucket] = 0
        i = self._next[bucket]
        self._next[bucket] = (i + 1) % self.ring
        return ring[i]


def make_ladder(bucket_size: int, n_rungs: int = 4) -> tuple:
    """Geometric bucket ladder ``(bucket/2^(r-1), ..., bucket/2, bucket)``."""
    if n_rungs < 1:
        raise ValueError("make_ladder: n_rungs must be >= 1")
    return tuple(max(1, bucket_size >> (n_rungs - 1 - i)) for i in range(n_rungs))


def choose_bucket(n: int, ladder) -> int:
    """Smallest ladder rung ≥ n; the largest rung if none fits (the caller
    truncates to it and must count the overflow)."""
    for b in ladder:
        if n <= b:
            return int(b)
    return int(ladder[-1])


def voxel_votes(
    events: torch.Tensor, n_valid: torch.Tensor, num_bins: int, height: int, width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every vote of a [B, N, 4] event batch as (flat cell index into
    [B, bins, H, W], value): all left votes in event order, then all right
    votes, as the JAX scatter adds them.  Votes that fall outside the
    frame, the bins or the first ``n_valid`` events are left out."""
    B, N, _ = events.shape
    dev = events.device
    n_valid = n_valid.to(device=dev, dtype=torch.int64)
    valid = torch.arange(N, device=dev)[None, :] < n_valid[:, None]

    t = events[..., 0]
    xs = events[..., 1].to(torch.int32)
    ys = events[..., 2].to(torch.int32)
    pols = torch.where(events[..., 3] == 0, -1.0, events[..., 3])

    first = t[:, :1]
    last = torch.gather(t, 1, (n_valid - 1).clamp(0, N - 1)[:, None])
    delta = last - first
    delta = torch.where(delta == 0, torch.ones_like(delta), delta)

    ts = (num_bins - 1) * (t - first) / delta
    tis = torch.floor(ts)
    tis_i = tis.to(torch.int64)
    dts = ts - tis

    hw = height * width
    base = (
        torch.arange(B, device=dev)[:, None] * (num_bins * hw)
        + xs.to(torch.int64) + ys.to(torch.int64) * width
    )
    inb = valid & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height) & (tis >= 0)
    mask_l = inb & (tis < num_bins)
    mask_r = inb & (tis + 1 < num_bins)
    idx = torch.cat([(base + tis_i * hw)[mask_l], (base + (tis_i + 1) * hw)[mask_r]])
    val = torch.cat([(pols * (1.0 - dts))[mask_l], (pols * dts)[mask_r]])
    return idx, val


def voxel_scatter_plain(
    events: torch.Tensor, n_valid: torch.Tensor, num_bins: int, height: int, width: int
) -> torch.Tensor:
    """Plain PyTorch twin of K1: [B, N, 4] events + [B] counts →
    [B, bins, H, W] UNNORMALIZED grid."""
    B = events.shape[0]
    idx, val = voxel_votes(events, n_valid, num_bins, height, width)
    grid = torch.zeros(B * num_bins * height * width, dtype=torch.float32, device=events.device)
    grid.index_add_(0, idx, val)
    return grid.view(B, num_bins, height, width)


def normalize_voxel_grid(grid: torch.Tensor) -> torch.Tensor:
    """Per-sample nonzero mean/std normalization (sample std, ddof=1) of a
    [B, bins, H, W] grid (counterpart of ``voxel.py:332-343``)."""
    dims = tuple(range(1, grid.dim()))
    shape = (-1,) + (1,) * (grid.dim() - 1)
    nz = grid != 0
    n = nz.sum(dim=dims)
    mean = grid.sum(dim=dims) / n.clamp(min=1).to(grid.dtype)
    centred = grid - mean.view(shape)
    var = torch.where(nz, centred * centred, 0.0).sum(dim=dims) / (n - 1).clamp(min=1)
    std = torch.sqrt(var)
    denom = torch.where((n > 1) & (std > 0), std, torch.ones_like(std))
    return torch.where(nz, centred / denom.view(shape), grid)


def voxelize_plain(
    events: torch.Tensor, n_valid: torch.Tensor, num_bins: int, height: int, width: int
) -> torch.Tensor:
    """Plain PyTorch twin of K1's ``voxelize``: the normalized
    [B, bins, H, W] grid."""
    return normalize_voxel_grid(voxel_scatter_plain(events, n_valid, num_bins, height, width))


def events_to_voxel_grid(
    events: torch.Tensor,
    n_valid,
    num_bins: int,
    height: int,
    width: int,
    normalize: bool = True,
) -> torch.Tensor:
    """events: [N, 4] (t, x, y, p) float32, time-sorted, first n_valid real
    → [bins, H, W] float32 (counterpart of ``voxel.py:127-187``).  Goes
    through K1: the kernel on the card, the twin on the CPU."""
    from eemflow_tpu_torch.kernels.voxel_scatter import voxel_scatter, voxelize

    n = torch.as_tensor(n_valid, dtype=torch.int32, device=events.device).reshape(1)
    fn = voxelize if normalize else voxel_scatter
    return fn(events[None].contiguous(), n, num_bins, height, width)[0]


def voxelize_batch_nhwc(
    events: torch.Tensor,
    n_valid: torch.Tensor,
    num_bins: int,
    height: int,
    width: int,
    normalize: bool = True,
) -> torch.Tensor:
    """[B, N, 4] + [B] → [B, H, W, bins] (NHWC, the model input layout;
    counterpart of ``voxel.py:415-447``).  The result is a permuted view of
    the NCHW grid, so the model's permute back to NCHW costs no copy."""
    from eemflow_tpu_torch.kernels.voxel_scatter import voxel_scatter, voxelize

    fn = voxelize if normalize else voxel_scatter
    grid = fn(events.contiguous(), n_valid.to(torch.int32).contiguous(), num_bins, height, width)
    return grid.permute(0, 2, 3, 1)


def events_to_voxel_grid_np(
    events: np.ndarray,
    num_bins: int,
    height: int,
    width: int,
    normalize: bool = True,
) -> np.ndarray:
    """Host (numpy, float64) voxelizer for loaders and golden tests
    (counterpart of ``voxel.py:346-397``). events: [N,4], time-sorted."""
    grid = np.zeros(num_bins * height * width, dtype=np.float64)
    if len(events) > 0:
        t = events[:, 0].astype(np.float64)
        xs = events[:, 1].astype(np.int64)
        ys = events[:, 2].astype(np.int64)
        pols = events[:, 3].astype(np.float64).copy()
        pols[pols == 0] = -1

        deltaT = t[-1] - t[0]
        if deltaT == 0:
            deltaT = 1.0
        ts = (num_bins - 1) * (t - t[0]) / deltaT
        tis = np.floor(ts)
        dts = ts - tis
        tis_i = tis.astype(np.int64)
        vals_left = pols * (1.0 - dts)
        vals_right = pols * dts

        inb = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
        m = inb & (tis < num_bins) & (tis >= 0)
        np.add.at(grid, xs[m] + ys[m] * width + tis_i[m] * width * height, vals_left[m])
        m = inb & (tis + 1 < num_bins) & (tis >= 0)
        np.add.at(
            grid, xs[m] + ys[m] * width + (tis_i[m] + 1) * width * height, vals_right[m]
        )

    grid = grid.reshape(num_bins, height, width)
    if normalize:
        nz = grid != 0
        n = nz.sum()
        if n > 0:
            mean = grid[nz].mean()
            std = grid[nz].std(ddof=1) if n > 1 else 0.0
            if std > 0:
                grid[nz] = (grid[nz] - mean) / std
            else:
                grid[nz] = grid[nz] - mean
    return grid.astype(np.float32)
