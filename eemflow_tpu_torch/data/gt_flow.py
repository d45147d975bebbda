"""MVSEC GT-flow time propagation for the offline encoder (the port's copy
of ``eemflow_tpu/data/gt_flow.py:1-100``; reference
``loader/loader_utils.py:70-161``).

The GT flow maps are not synchronized with the grayscale frames, so the
flow between two frame timestamps is synthesized by advecting a pixel grid
through the per-interval GT flow fields (nearest-neighbour remap), scaling
the first and last partial intervals, and zeroing the pixels that ever
sampled an exactly-zero flow (the reference's out-of-frame proxy).
"""

from __future__ import annotations

import numpy as np


def _remap_nearest(img: np.ndarray, x_idx: np.ndarray, y_idx: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, x, y, INTER_NEAREST)`` with float32 maps and cv2's
    default zero border, in numpy: each coordinate rounds half to even, as
    cv2's ``saturate_cast<int>`` does (2.5 → 2, 3.5 → 4), and a pixel whose
    rounded source lies outside the image is 0."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    xi = np.rint(np.asarray(x_idx, np.float32)).astype(np.int64)
    yi = np.rint(np.asarray(y_idx, np.float32)).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.zeros(xi.shape + img.shape[2:], np.float32)
    out[valid] = img[yi[valid], xi[valid]]
    return out


def prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask, scale_factor=1.0):
    """One advection step (in place on the indices and masks)."""
    fx = _remap_nearest(x_flow, x_indices, y_indices)
    fy = _remap_nearest(y_flow, x_indices, y_indices)
    x_mask[fx == 0] = False
    y_mask[fy == 0] = False
    x_indices += fx * scale_factor
    y_indices += fy * scale_factor


def estimate_corresponding_gt_flow(x_flow_in, y_flow_in, gt_timestamps, start_time, end_time):
    """Pixel-displacement flow between ``start_time`` and ``end_time``.

    x_flow_in/y_flow_in: [T, H, W] stacks of per-interval GT flow;
    gt_timestamps: [T] interval start times.  Returns (x_shift, y_shift)."""
    x_flow_in = np.asarray(x_flow_in, dtype=np.float64)
    y_flow_in = np.asarray(y_flow_in, dtype=np.float64)
    gt_timestamps = np.asarray(gt_timestamps, dtype=np.float64)

    gt_iter = np.searchsorted(gt_timestamps, start_time, side="right") - 1
    gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    x_flow = np.squeeze(x_flow_in[gt_iter])
    y_flow = np.squeeze(y_flow_in[gt_iter])

    dt = end_time - start_time
    if gt_dt > dt:
        # the window lies inside one GT interval: linear scaling suffices
        return x_flow * dt / gt_dt, y_flow * dt / gt_dt

    x_indices, y_indices = np.meshgrid(np.arange(x_flow.shape[1]), np.arange(x_flow.shape[0]))
    x_indices = x_indices.astype(np.float32)
    y_indices = y_indices.astype(np.float32)
    orig_x = x_indices.copy()
    orig_y = y_indices.copy()
    x_mask = np.ones(x_indices.shape, dtype=bool)
    y_mask = np.ones(y_indices.shape, dtype=bool)

    # the first (partial) interval
    scale = (gt_timestamps[gt_iter + 1] - start_time) / gt_dt
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask, scale)
    gt_iter += 1

    # the whole intervals
    while gt_timestamps[gt_iter + 1] < end_time:
        x_flow = np.squeeze(x_flow_in[gt_iter])
        y_flow = np.squeeze(y_flow_in[gt_iter])
        prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask)
        gt_iter += 1

    # the last (partial) interval
    final_dt = end_time - gt_timestamps[gt_iter]
    final_gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    x_flow = np.squeeze(x_flow_in[gt_iter])
    y_flow = np.squeeze(y_flow_in[gt_iter])
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask, final_dt / final_gt_dt)

    x_shift = x_indices - orig_x
    y_shift = y_indices - orig_y
    x_shift[~x_mask] = 0
    y_shift[~y_mask] = 0
    return x_shift, y_shift
