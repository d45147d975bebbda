"""Device-side input step: raw padded events → voxel grids on the card
(eval part of ``eemflow_tpu/data/device_input.py:40-160``).

The host only reads and pads raw events to a fixed bucket; the scatter
and the normalization run on the device as the first part of the eval
step, as one call of kernel K1 (``voxelize``) per frame.  Batch contract (the datasets' raw-event mode):
``events_old``/``events_new`` [B, bucket, 4] float32 (t, x, y, p),
time-sorted, relative timestamps; ``n_old``/``n_new`` [B] int32.  Flips
and crops are train-only and come with the training slice.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict

import torch

from eemflow_tpu_torch.events.voxel import voxelize_batch_nhwc

logger = logging.getLogger("eemflow_tpu_torch")

_RAW_KEYS = ("events_old", "events_new", "n_old", "n_new")


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


def make_device_preprocess(
    num_bins: int, height: int, width: int
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """fn(batch) → batch with ``event_volume_old/new`` ([B, H, W, bins]
    NHWC) in place of the raw-event keys; a host-voxelized batch passes
    through unchanged."""

    def preprocess(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if "events_old" not in batch:
            return batch
        out = {k: v for k, v in batch.items() if k not in _RAW_KEYS}
        out["event_volume_old"] = voxelize_batch_nhwc(
            batch["events_old"], batch["n_old"], num_bins, height, width
        )
        out["event_volume_new"] = voxelize_batch_nhwc(
            batch["events_new"], batch["n_new"], num_bins, height, width
        )
        return out

    return preprocess
