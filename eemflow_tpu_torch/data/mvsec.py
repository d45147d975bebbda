"""MVSEC dataset (counterpart of ``eemflow_tpu/data/mvsec.py:1-435``;
reference ``loader/MVSEC.py``), for the two-volume models.

346×260 event flow from per-frame HDF5 event tables (``event/{i+1:06d}.h5``,
written by the offline encoder, read by ``events.io.read_events_h5``) and
GT flow ``.npy`` files (``flowgt_dt1/{i}.npy`` or ``flowgt_dt4``).
Protocols:

  * dt1: the events between consecutive frames (``MvsecEventFlow``);
  * dt4: the events of 4 frame intervals concatenated
    (``MvsecEventFlow_dt4``, reference ``MVSEC.py:197-285``);
  * dense or sparse evaluation (``eval_type``): sparse also masks to the
    pixels where the old window has an event (``event_valid``, a 2D
    histogram of its event coordinates over the full frame, reference
    ``MVSEC.py:132-142``), in raw-event mode too;
  * validation centre-crops the flow, the masks and the grids to 256×256
    (``MVSEC.py:189-193``); ``valid`` is |u|, |v| < 1000.

Events carry absolute timestamps in seconds (~1.5e9 on the real
recordings); ``EventSequence`` scales them to µs and makes them relative in
float64 on the host, before they are voxelized or packed as float32 for
the device (in float32, 1.5e15 µs has a spacing of ~1.3e8 µs).

Per sample, the events become host voxel grids (``_voxelize`` at the full
frame, so the normalization statistics are the whole frame's; the crop
comes after) or, in raw-event mode, padded [bucket, 4] float32 buffers on
the bucket ladder (``events.voxel.make_ladder``), counted by an
``EventOverflowCounter``, that the device voxelizes and crops
(``data.device_input.make_device_preprocess(crop_size=(256, 256))``).  In
training the host path runs the augmentor's resize branch (scale, stretch,
flips, a random crop); raw-event mode draws the flips and the crop offsets
here, applies them to the label, and hands them on as ``flip_h``/``flip_v``
and ``crop_y``/``crop_x`` (``:318-345`` of the JAX file).

The valid frame range of each sequence is the reference's table
(``MVSEC.py:24-31``); ``valid_time_index`` replaces it for one dataset
(subset evals, synthetic fixtures) without changing the module's table.
The other families' contracts (``with_dense``, ``time_stack``,
``with_images``, ``seg_events``) raise: their models are not ported.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from eemflow_tpu_torch.data.augment import FlowAugmentor
from eemflow_tpu_torch.data.device_input import EventOverflowCounter
from eemflow_tpu_torch.events.io import read_events_h5
from eemflow_tpu_torch.events.sequence import EventSequence
from eemflow_tpu_torch.events.voxel import choose_bucket, events_to_voxel_grid_np, make_ladder, pad_events

VALID_TIME_INDEX = {
    "indoor_flying1": [(314, 2199)],
    "indoor_flying2": [(314, 2199)],
    "indoor_flying3": [(314, 2199)],
    "indoor_flying4": [(196, 570)],
    "outdoor_day1": [(245, 3000)],
    "outdoor_day2": [(4375, 7002)],
}
VAL_CROP = 256
# the JAX dataset's options for families whose models the port has not yet
UNPORTED_CONTRACTS = {
    "with_dense": "the dense/sparse families (DenseSparse, DenseCtx, MimoUNet)",
    "time_stack": "the single-volume family (STE, spiking FlowNet)",
    "with_images": "the event+image family (DCEIFlow)",
    "seg_events": "the raw-segment family (the point-transformer models)",
}


def center_crop(arr: np.ndarray, size: int = VAL_CROP) -> np.ndarray:
    """torchvision CenterCrop semantics on [H, W, ...]."""
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top : top + size, left : left + size]


class MvsecEventFlow:
    image_width = 346
    image_height = 260
    dt_intervals = 1

    def __init__(
        self,
        root: str,
        sequence: str,
        train: bool = True,
        num_bins: int = 5,
        eval_type: str = "dense",
        aug_params: Optional[dict] = None,
        flowgt_dirname: str = "flowgt_dt1",
        rng: Optional[np.random.Generator] = None,
        raw_events: bool = False,
        bucket_size: int = 1 << 17,
        bucket_rungs: int = 1,
        valid_time_index: Optional[Dict[str, list]] = None,
        **family_options,
    ):
        for option, value in family_options.items():
            if option not in UNPORTED_CONTRACTS:
                raise TypeError(f"MvsecEventFlow: unexpected argument {option!r}")
            if value:
                raise NotImplementedError(
                    f"MvsecEventFlow({option}=True) is the input of {UNPORTED_CONTRACTS[option]}, whose models "
                    "the port has not yet (ROADMAP.md section 1 item 7)")
        self.root = root
        self.type = "train" if train else "val"
        self.num_bins = num_bins
        self.evaluation_type = eval_type
        self.flowgt_dirname = flowgt_dirname
        self.valid_time_index = VALID_TIME_INDEX if valid_time_index is None else valid_time_index
        self.raw_events = raw_events
        self.bucket_size = bucket_size
        # the bucket ladder: each sample padded to the smallest rung that fits
        self.bucket_ladder = make_ladder(bucket_size, bucket_rungs) if bucket_rungs > 1 else (bucket_size,)
        if raw_events:
            self.overflow = EventOverflowCounter("MVSEC")
        self.augmentor = FlowAugmentor(**aug_params, rng=rng) if aug_params is not None else None
        self.change_test_sequence(sequence)

    def change_test_sequence(self, sequence: str) -> None:
        self.names = []
        for s in self.valid_time_index[sequence]:
            self.names.extend(range(s[0], s[1]))
        self.sequence = sequence
        seq_dir = os.path.join(self.root, sequence)
        self.flowgt_path = os.path.join(seq_dir, self.flowgt_dirname)
        self.event_path = os.path.join(seq_dir, "event")
        self.flow_list = [os.path.join(self.flowgt_path, f"{i}.npy") for i in self.names]
        self.event_list = [os.path.join(self.event_path, f"{i + 1:06d}.h5") for i in self.names]
        # trailing event files for the last windows: sample idx reads
        # old = event_list[idx : idx+k] and new = event_list[idx+k : idx+2k],
        # so the last sample needs 2k-1 files past the M-th
        last = self.names[-1] if self.names else 0
        for j in range(2 * self.dt_intervals - 1):
            self.event_list.append(os.path.join(self.event_path, f"{last + 2 + j:06d}.h5"))

    def __len__(self) -> int:
        return len(self.names)

    def _sequence(self, paths) -> EventSequence:
        arrays = [read_events_h5(p) for p in paths]
        events = np.concatenate(arrays, axis=0) if len(arrays) > 1 else arrays[0]
        return EventSequence(
            events, height=self.image_height, width=self.image_width,
            timestamp_multiplier=1e6, convert_to_relative=True,
        )

    def _voxelize(self, seq: EventSequence) -> np.ndarray:
        grid = events_to_voxel_grid_np(seq.features, self.num_bins, self.image_height, self.image_width)
        return grid.transpose(1, 2, 0)

    def _event_mask(self, seq: EventSequence) -> np.ndarray:
        ev = seq.features
        hist, _, _ = np.histogram2d(
            x=ev[:, 1], y=ev[:, 2],
            bins=(self.image_width, self.image_height),
            range=[[0, self.image_width], [0, self.image_height]],
        )
        return (hist.T > 0)[..., None].astype(np.float32)  # [H, W, 1]

    def get_sample(self, idx: int) -> Dict[str, np.ndarray]:
        flow = np.load(self.flow_list[idx])
        if flow.shape[0] == 2 and flow.ndim == 3:
            flow = flow.transpose(1, 2, 0)
        flow = flow.astype(np.float32)
        k = self.dt_intervals
        # direct indexing: change_test_sequence appended the 2k-1 trailing
        # files, so no window wraps around to the start of the recording
        seq_old = self._sequence(self.event_list[idx : idx + k])
        seq_new = self._sequence(self.event_list[idx + k : idx + 2 * k])
        sample = {"idx": self.names[idx], "flow": flow}
        if self.raw_events:
            for key, seq in (("old", seq_old), ("new", seq_new)):
                bucket = choose_bucket(len(seq.features), self.bucket_ladder)
                padded, n, dropped = pad_events(seq.features, bucket)
                self.overflow.update(len(seq.features), dropped)
                sample[f"events_{key}"] = padded
                sample[f"n_{key}"] = np.int32(n)
        else:
            sample["event_volume_old"] = self._voxelize(seq_old)
            sample["event_volume_new"] = self._voxelize(seq_new)
        if self.type == "val":
            sample["event_valid"] = self._event_mask(seq_old)
        return sample

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self.get_sample(idx % len(self))
        if self.type == "train" and self.raw_events:
            flow = sample["flow"]
            fh = fv = False
            aug = self.augmentor
            if aug is not None:
                flow, fh, fv = aug.draw_flips(flow)
            # the device voxelizes the full frame, flips, then crops with these
            # offsets: the label is flipped first, then cropped the same way
            if aug is not None and aug.crop_size is not None and tuple(aug.crop_size) != flow.shape[:2]:
                cy, cx = aug.draw_crop(flow.shape[0], flow.shape[1])
                ch, cw = aug.crop_size
                flow = flow[cy : cy + ch, cx : cx + cw]
                sample["crop_y"] = np.int32(cy)
                sample["crop_x"] = np.int32(cx)
            valid = np.isfinite(flow).all(-1) & (np.linalg.norm(flow, axis=-1) > 0)
            sample["flow"] = flow
            sample["valid"] = valid.astype(np.float32)
            sample["flip_h"] = np.bool_(fh)
            sample["flip_v"] = np.bool_(fv)
        elif self.type == "train":
            ev1, ev2, flow = sample["event_volume_old"], sample["event_volume_new"], sample["flow"]
            if self.augmentor is not None:
                ev1, ev2, flow = self.augmentor(ev1, ev2, flow)
            valid = np.isfinite(flow).all(-1) & (np.linalg.norm(flow, axis=-1) > 0)
            sample["event_volume_old"] = ev1
            sample["event_volume_new"] = ev2
            sample["flow"] = flow
            sample["valid"] = valid.astype(np.float32)
        else:
            sample["flow"] = center_crop(sample["flow"])
            sample["valid"] = (
                (np.abs(sample["flow"][..., 0]) < 1000) & (np.abs(sample["flow"][..., 1]) < 1000)
            ).astype(np.float32)
            if not self.raw_events:
                # raw-event mode: the device preprocess centre-crops the grids
                for key in ("event_volume_old", "event_volume_new"):
                    sample[key] = center_crop(sample[key])
            sample["event_valid"] = center_crop(sample["event_valid"])
        return sample


class MvsecEventFlow_dt4(MvsecEventFlow):
    """dt4 protocol: 4 frame intervals of events a window
    (reference ``MVSEC.py:197-285``)."""

    dt_intervals = 4

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("flowgt_dirname", "flowgt_dt4")
        super().__init__(*args, **kwargs)
