"""HREM dataset (counterpart of ``eemflow_tpu/data/hrem.py:41-224``;
reference ``loader/HREM.py``).

Layout on disk (reference ``HREM.py:154-189``):
  * train: ``{root}/train/{dt}/{name}/{events1.npz, events2.npz, flow.flo}``;
  * test: ``{root}/test/{dt}/{sequence}/{name}/...`` with sequences
    {indoor,outdoor}×{fast,slow}; ``change_test_sequence`` selects one.

Per sample: dense flow → 16×16 meshflow (``data.meshflow``).  Test: the
meshflow bilinearly upsampled back to full resolution (align_corners=False,
reference ``HREM.py:266-268``) and masked to finite, nonzero GT.  Train:
the meshflow (or, with ``full_res_flow``, the dense flow) is the label,
``valid`` is all ones, and the flip-only augmentor runs (``without_resize``,
reference ``HREM.py:252``, with the label-flip bug fixed, see
``data.augment``).  Events become either host voxel grids (numpy, float64)
or, in raw-event mode, padded [bucket, 4] float32 buffers (the C++
packer, ``native.decode_pack_arrays``) that the model's device step
voxelizes (``data.device_input``); in that mode the flips are
drawn here, applied to the label, and handed on as ``flip_h``/``flip_v``
for the device to flip the grids.  Arrays are NHWC per sample.

One difference from the JAX class: ``train`` defaults to False, the split
the port had before its training slice, so that its eval callers stay as
they are.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from eemflow_tpu_torch.data.augment import FlowAugmentor
from eemflow_tpu_torch.data.device_input import EventOverflowCounter
from eemflow_tpu_torch.data.meshflow import motion_propagate
from eemflow_tpu_torch.events.io import read_compressed_events, read_flo
from eemflow_tpu_torch.events.sequence import EventSequence
from eemflow_tpu_torch.events.voxel import BufferPool, choose_bucket, events_to_voxel_grid_np, make_ladder
from eemflow_tpu_torch.native import decode_pack_arrays
from eemflow_tpu_torch.ops.upsample import resize_bilinear

HREM_SEQUENCES = ["indoor_fast", "indoor_slow", "outdoor_fast", "outdoor_slow"]


def _bilinear_upsample_np(flow_hw2: np.ndarray, size) -> np.ndarray:
    """[h, w, 2] → [H, W, 2] bilinear (align_corners=False), on the CPU."""
    out = resize_bilinear(torch.from_numpy(np.ascontiguousarray(flow_hw2))[None], size)
    return out[0].numpy()


class HREMEventFlow:
    image_width = 1280
    image_height = 720

    def __init__(
        self,
        root: str,
        dt: str = "dt1",
        num_bins: int = 5,
        raw_events: bool = False,
        bucket_size: int = 1 << 18,
        bucket_rungs: int = 1,
        train: bool = False,
        aug_params: Optional[dict] = None,
        rng: Optional[np.random.Generator] = None,
        full_res_flow: bool = False,
    ):
        self.root = root
        self.dt = dt
        self.type = "train" if train else "val"
        self.num_bins = num_bins
        # full_res_flow: train labels are the dense .flo flow instead of the
        # 16x16 meshflow
        self.full_res_flow = full_res_flow
        self.augmentor = (
            FlowAugmentor(**aug_params, rng=rng) if aug_params is not None else None
        )
        self.raw_events = raw_events
        self.bucket_size = bucket_size
        self.bucket_ladder = (
            make_ladder(bucket_size, bucket_rungs) if bucket_rungs > 1
            else (bucket_size,)
        )
        if raw_events:
            self.overflow = EventOverflowCounter(f"HREM[{dt}]")
            self._pack_pool = BufferPool()
        self._scan()

    def _scan_dir(self, d: str) -> List[Dict[str, str]]:
        out = []
        if not os.path.isdir(d):
            return out
        for name in sorted(os.listdir(d)):
            e1 = os.path.join(d, name, "events1.npz")
            e2 = os.path.join(d, name, "events2.npz")
            fl = os.path.join(d, name, "flow.flo")
            if os.path.exists(e1) and os.path.exists(e2) and os.path.exists(fl):
                out.append({"names": name, "event0": e1, "event1": e2, "fflow": fl})
        return out

    def _scan(self) -> None:
        if self.type == "train":
            self.data_ls = self._scan_dir(os.path.join(self.root, "train", self.dt))
            return
        test_dir = os.path.join(self.root, "test", self.dt)
        self.nori_list = {}
        if os.path.isdir(test_dir):
            for seq in sorted(os.listdir(test_dir)):
                self.nori_list[seq] = self._scan_dir(os.path.join(test_dir, seq))
        self.data_ls = next(iter(self.nori_list.values()), [])

    def change_test_sequence(self, sequence: str) -> None:
        self.data_ls = self.nori_list[sequence]

    def __len__(self) -> int:
        return len(self.data_ls)

    def _voxelize(self, path: str) -> np.ndarray:
        seq = EventSequence(
            read_compressed_events(path),
            height=self.image_height,
            width=self.image_width,
            timestamp_multiplier=1e6,
            convert_to_relative=True,
        )
        grid = events_to_voxel_grid_np(
            seq.features, self.num_bins, self.image_height, self.image_width
        )
        return grid.transpose(1, 2, 0)  # [H, W, bins]

    def _raw(self, path: str):
        """Read + pad raw events for device-side voxelization: the port's
        fused C++ decode+pack (``eemflow_tpu_torch.native``) into a pooled
        buffer.  The columns are decompressed once: NpzFile members are not
        cached, so a separate ``len(npz['t'])`` for the bucket ladder would
        decode the int64 t column twice."""
        with np.load(path) as npz:
            t = np.ascontiguousarray(npz["t"], np.int64)
            x = np.ascontiguousarray(npz["x"], np.int16)
            y = np.ascontiguousarray(npz["y"], np.int16)
            p = np.ascontiguousarray(npz["p"], np.int8)
        bucket = choose_bucket(len(t), self.bucket_ladder)
        padded, n, dropped = decode_pack_arrays(t, x, y, p, bucket, out=self._pack_pool.get(bucket))
        self.overflow.update(n + dropped, dropped)
        return padded, np.int32(n)

    def get_sample(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.data_ls[idx]
        fflow = read_flo(rec["fflow"])  # [H, W, 2]
        if self.full_res_flow and self.type == "train":
            flow = fflow  # the dense label: no mesh propagation
        else:
            x_mesh, y_mesh = motion_propagate(fflow, mesh_size=16)
            flow = np.stack([x_mesh, y_mesh], axis=-1).astype(np.float32)
        sample = {"names": rec["names"], "flow": flow}
        if self.type != "train":
            # the full-resolution GT for eval only: in training it would go
            # stale (unflipped) after augmentation
            sample["fflow"] = fflow
        if self.raw_events:
            sample["events_old"], sample["n_old"] = self._raw(rec["event0"])
            sample["events_new"], sample["n_new"] = self._raw(rec["event1"])
        else:
            ev_old = self._voxelize(rec["event0"])
            sample["event_volume_old"] = ev_old
            sample["event_volume_new"] = self._voxelize(rec["event1"])
            sample["event_valid"] = ev_old.sum(axis=-1, keepdims=True)  # [H, W, 1]
        return sample

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self.get_sample(idx % len(self))
        if self.type == "train" and self.raw_events:
            # flips drawn here (the label flipped here), grids flipped on the
            # device (data.device_input)
            flow = sample["flow"]
            if self.augmentor is not None:
                flow, fh, fv = self.augmentor.draw_flips(flow)
            else:
                fh = fv = False
            sample["flow"] = flow
            sample["flip_h"] = np.bool_(fh)
            sample["flip_v"] = np.bool_(fv)
            sample["valid"] = np.ones(flow.shape[:2], np.float32)
            return sample
        if self.type == "train":
            ev1, ev2, flow = sample["event_volume_old"], sample["event_volume_new"], sample["flow"]
            if self.augmentor is not None:
                ev1, ev2, flow = self.augmentor(ev1, ev2, flow, without_resize=True)
            sample["event_volume_old"] = ev1
            sample["event_volume_new"] = ev2
            sample["flow"] = flow
            sample["valid"] = np.ones(flow.shape[:2], np.float32)
            return sample
        flow_full = _bilinear_upsample_np(
            sample["flow"], (self.image_height, self.image_width)
        )
        sample["flow"] = flow_full
        valid = np.isfinite(flow_full).all(-1) & (np.linalg.norm(flow_full, axis=-1) > 0)
        sample["valid"] = valid.astype(np.float32)
        return sample
