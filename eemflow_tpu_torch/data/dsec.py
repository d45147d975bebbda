"""DSEC helpers (counterpart of ``eemflow_tpu/data/dsec.py``; reference
``utils/dsec_utils.py`` and the submission writer of
``utils/visualization.py:76``).  Numpy only.

  * ``DSECVoxelGrid`` — DSEC's normalized voxel grid, the port's
    ``events_to_voxel_grid_np`` behind the reference's callable;
  * ``flow_16bit_to_float`` — decode DSEC's 16-bit flow PNG values
    (reference ``dsec_utils.py:66-83``);
  * ``flow_to_16bit`` / ``write_flow_submission`` — the inverse, for
    benchmark submission files (16-bit PNG through ``viz.png``).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from eemflow_tpu_torch.events.voxel import events_to_voxel_grid_np
from eemflow_tpu_torch.viz.png import write_png


class DSECVoxelGrid:
    """Callable voxelizer with the reference's ``dsec_utils.VoxelGrid`` fields."""

    def __init__(self, num_bins: int, height: int, width: int, normalize: bool = True):
        self.num_bins = num_bins
        self.height = height
        self.width = width
        self.normalize = normalize

    def __call__(self, events: np.ndarray) -> np.ndarray:
        """events: [N, 4] (t, x, y, p), time-sorted → [bins, H, W]."""
        return events_to_voxel_grid_np(events, self.num_bins, self.height, self.width, self.normalize)


def flow_16bit_to_float(flow_16bit: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[H, W, 3] uint16 (u, v, valid) → ([H, W, 2] float32 flow, [H, W] bool);
    a value is (flow + 2¹⁵)·128."""
    h, w, c = flow_16bit.shape
    assert c == 3
    valid = flow_16bit[..., 2] > 0
    flow = (flow_16bit[..., :2].astype(np.float64) - 2**15) / 128.0
    flow[~valid] = 0
    return flow.astype(np.float32), valid


def flow_to_16bit(flow: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
    """The inverse of ``flow_16bit_to_float``, for submission files."""
    h, w, _ = flow.shape
    out = np.zeros((h, w, 3), np.uint16)
    out[..., :2] = np.clip(flow * 128.0 + 2**15, 0, 2**16 - 1).astype(np.uint16)
    out[..., 2] = 1 if valid is None else valid.astype(np.uint16)
    return out


def write_flow_submission(flow: np.ndarray, path: str) -> None:
    """Write [H, W, 2] flow as a DSEC 16-bit PNG: the file's R, G, B
    samples are u, v and valid, as the JAX package's file holds them."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, flow_to_16bit(flow)[..., ::-1])  # BGR in, as cv2.imwrite takes it
