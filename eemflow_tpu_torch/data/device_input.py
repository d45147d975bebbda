"""Device-side input step: raw padded events → voxel grids on the card
(counterpart of ``eemflow_tpu/data/device_input.py:40-193``).

The host only reads and pads raw events to a fixed bucket; the scatter
and the normalization run on the device as the first part of the eval or
train step, as one call of kernel K1 (``voxelize``) per frame.  Batch
contract (the datasets' raw-event mode):

  * ``events_old``/``events_new`` [B, bucket, 4] float32 (t, x, y, p),
    time-sorted, relative timestamps; ``n_old``/``n_new`` [B] int32;
  * optional ``flip_h``/``flip_v`` [B] bool, the flips drawn on the host
    (which flipped the label with the same draws,
    ``augment.FlowAugmentor.draw_flips``);
  * optional ``crop_y``/``crop_x`` [B] int32 crop offsets (the MVSEC
    raw-event training path, which crops the label on the host with the
    same draws, ``augment.FlowAugmentor.draw_crop``); without them a
    ``crop_size`` preprocess takes the static centre crop of MVSEC's
    validation protocol.

As on the host path, the full frame is voxelized first (the normalization
statistics are the whole grid's, 260×346 on MVSEC), then flipped, then
cropped, so both paths give the same grids for the same draws.  The JAX
step's on-device event mask (``event_mask``) is left out: the MVSEC CLIs
take ``event_valid`` from the host, which computes it from the old
window's events before the crop.  The step takes no gradient: the train
step runs it under ``torch.no_grad()``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple

import torch

from eemflow_tpu_torch.events.voxel import voxelize_batch_nhwc

logger = logging.getLogger("eemflow_tpu_torch")

_RAW_KEYS = ("events_old", "events_new", "n_old", "n_new", "flip_h", "flip_v", "crop_y", "crop_x")


class EventOverflowCounter:
    """Host-side accounting of events dropped by bucket truncation."""

    def __init__(self, name: str = "events"):
        self.name = name
        self.total_events = 0
        self.total_dropped = 0
        self.samples_overflowed = 0
        self._warned = False

    def update(self, n_total: int, n_dropped: int) -> None:
        self.total_events += n_total
        self.total_dropped += n_dropped
        if n_dropped > 0:
            self.samples_overflowed += 1
            if not self._warned:
                logger.warning(
                    "%s: event bucket overflow — %d/%d events dropped in one "
                    "sample; increase bucket_size (further overflows counted "
                    "silently, see .summary())",
                    self.name, n_dropped, n_total,
                )
                self._warned = True

    def summary(self) -> Dict[str, float]:
        return {
            "total_events": self.total_events,
            "total_dropped": self.total_dropped,
            "samples_overflowed": self.samples_overflowed,
            "drop_rate": self.total_dropped / max(self.total_events, 1),
        }


def flip_batch(grids: torch.Tensor, flip_h: torch.Tensor, flip_v: torch.Tensor) -> torch.Tensor:
    """Per-sample h/v flips of [B, H, W, C] grids (h reverses the W axis),
    selected on the device: no host sync."""
    grids = torch.where(flip_h.view(-1, 1, 1, 1), grids.flip(2), grids)
    return torch.where(flip_v.view(-1, 1, 1, 1), grids.flip(1), grids)


def crop_batch(
    grids: torch.Tensor, crop_y: torch.Tensor, crop_x: torch.Tensor, crop_size: Tuple[int, int]
) -> torch.Tensor:
    """Per-sample crop of [B, H, W, C] grids to ``crop_size`` at the offsets
    ``crop_y``/``crop_x`` [B], gathered on the device (no host sync).  An
    offset is clamped so that the crop fits, as ``jax.lax.dynamic_slice``
    clamps it."""
    B, H, W, _ = grids.shape
    ch, cw = crop_size
    if ch > H or cw > W:
        raise ValueError(f"crop_batch: a {ch}x{cw} crop of a {H}x{W} grid")
    dev = grids.device
    rows = crop_y.to(dev, torch.int64).clamp(0, H - ch)[:, None] + torch.arange(ch, device=dev)
    cols = crop_x.to(dev, torch.int64).clamp(0, W - cw)[:, None] + torch.arange(cw, device=dev)
    b = torch.arange(B, device=dev)[:, None, None]
    return grids[b, rows[:, :, None], cols[:, None, :]]


def make_device_preprocess(
    num_bins: int, height: int, width: int, crop_size: Optional[Tuple[int, int]] = None
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """fn(batch) → batch with ``event_volume_old/new`` ([B, H, W, bins]
    NHWC) in place of the raw-event keys: the full ``height``×``width``
    frame voxelized, flipped where the batch has flip flags, then cropped to
    ``crop_size`` when one is given (at the batch's ``crop_y``/``crop_x``,
    or in the centre without them).  A host-voxelized batch passes through
    unchanged."""

    def preprocess(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if "events_old" not in batch:
            return batch
        out = {k: v for k, v in batch.items() if k not in _RAW_KEYS}
        ev_old = voxelize_batch_nhwc(batch["events_old"], batch["n_old"], num_bins, height, width)
        ev_new = voxelize_batch_nhwc(batch["events_new"], batch["n_new"], num_bins, height, width)
        if "flip_h" in batch:
            fh, fv = batch["flip_h"], batch["flip_v"]
            ev_old, ev_new = flip_batch(ev_old, fh, fv), flip_batch(ev_new, fh, fv)
        if crop_size is not None:
            cy, cx = batch.get("crop_y"), batch.get("crop_x")
            if cy is None:  # the static centre crop (MVSEC's validation protocol)
                B = ev_old.shape[0]
                cy = torch.full((B,), (height - crop_size[0]) // 2, dtype=torch.int64, device=ev_old.device)
                cx = torch.full((B,), (width - crop_size[1]) // 2, dtype=torch.int64, device=ev_old.device)
            ev_old = crop_batch(ev_old, cy, cx, crop_size)
            ev_new = crop_batch(ev_new, cy, cx, crop_size)
        out["event_volume_old"] = ev_old
        out["event_volume_new"] = ev_new
        return out

    return preprocess
