"""Host-side train-time augmentor (the port's copy of
``eemflow_tpu/data/augment.py`` ``FlowAugmentor``; reference
``utils/augumentor.py:16-241``).

HREM training takes the flip-only branch (``without_resize=True``,
reference ``utils/augumentor.py:204-241``): a horizontal flip with
probability ``h_flip_prob`` and a vertical one with ``v_flip_prob``, applied
to both event grids and to the flow (its sign flipped along the axis), with
the label-flip bug of the reference's HREM loader fixed as the JAX package
fixes it.  Both methods draw from ``rng`` in the JAX package's order, so
one seed gives the same flips in both packages and on the host and device
paths.

MVSEC training takes the resize branch (``without_resize=False``,
reference ``utils/augumentor.py:16-203``): a log2-uniform scale with
probability ``stretch_prob`` of an independent stretch of each axis,
clipped so that the crop still fits with 8 pixels to spare, applied with
probability ``spatial_aug_prob`` to both grids and to the flow (whose
values are scaled with the image); then the flips; then a random crop of
``crop_size``.  The resize is ``cv2.resize(img, None, fx, fy,
INTER_LINEAR)`` in the JAX package; ``_resize`` here computes the same
function in numpy (the port imports no ``cv2``), and equals cv2's
result bit for bit on float32 images of 2, 5 and more channels (the flow
and the voxel grids; ``tests/test_torch_mvsec.py``).
"""

from __future__ import annotations

import numpy as np


def _axis_taps(n_out: int, scale: float):
    """cv2's INTER_LINEAR source taps along one axis: output pixel ``d``
    reads ``(d + 0.5)/scale − 0.5`` (computed from the scale factor, not
    from the ratio of the rounded sizes, in double and rounded to float32),
    split into its floor and the float32 fraction; rows and columns are
    clamped into the image (border replicate)."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / scale) - 0.5).astype(np.float32)
    lo = np.floor(f).astype(np.int64)
    frac = f - lo.astype(np.float32)
    return lo, frac


def _resize(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=fx, fy=fy, interpolation=INTER_LINEAR)``
    for a float [H, W] or [H, W, C] image: the output is ``round(W·fx)`` ×
    ``round(H·fy)`` (round half to even, as cv2's ``saturate_cast``); each
    row is first interpolated along x (a tap left of column 0 or at the last
    column takes that column with weight 1), then the rows along y (taps
    clamped to the image); one-channel images come back without their
    channel axis, as cv2 returns them."""
    if not np.issubdtype(img.dtype, np.floating):
        raise ValueError(f"_resize: float images only, got {img.dtype}")
    h, w = img.shape[:2]
    out_w, out_h = int(np.rint(w * fx)), int(np.rint(h * fy))
    x = img.reshape(h, w, -1)
    sx, ax = _axis_taps(out_w, fx)
    left = sx < 0
    right = sx >= w - 1
    ax[left | right] = 0
    sx = np.where(left, 0, np.where(right, w - 1, sx))
    sx1 = np.minimum(sx + 1, w - 1)
    one = np.float32(1)
    rows = x[:, sx] * (one - ax)[None, :, None].astype(x.dtype) + x[:, sx1] * ax[None, :, None].astype(x.dtype)
    sy, ay = _axis_taps(out_h, fy)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    out = rows[y0] * (one - ay)[:, None, None].astype(x.dtype) + rows[y1] * ay[:, None, None].astype(x.dtype)
    return out[..., 0] if img.ndim == 2 or img.shape[2] == 1 else out


class FlowAugmentor:
    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 spatial_aug_prob=0.8, stretch_prob=0.8, max_stretch=0.2,
                 h_flip_prob=0.5, v_flip_prob=0.1, rng=None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = spatial_aug_prob
        self.stretch_prob = stretch_prob
        self.max_stretch = max_stretch
        self.do_flip = do_flip
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob
        self.rng = rng if rng is not None else np.random.default_rng()

    def _sample_scales(self, ht, wd):
        min_scale = max(
            (self.crop_size[0] + 8) / float(ht), (self.crop_size[1] + 8) / float(wd)
        )
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if self.rng.random() < self.stretch_prob:
            sx *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
        return max(sx, min_scale), max(sy, min_scale)

    def _flips(self, imgs, flow):
        if self.do_flip:
            if self.rng.random() < self.h_flip_prob:
                imgs = [im[:, ::-1] for im in imgs]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if self.rng.random() < self.v_flip_prob:
                imgs = [im[::-1, :] for im in imgs]
                flow = flow[::-1, :] * [1.0, -1.0]
        return imgs, flow

    def _crop(self, imgs, flow):
        # +1: the high end is inclusive, so a dimension equal to the crop is
        # legal and the bottom/right-most crop is reachable
        y0 = self.rng.integers(0, imgs[0].shape[0] - self.crop_size[0] + 1)
        x0 = self.rng.integers(0, imgs[0].shape[1] - self.crop_size[1] + 1)
        sl = np.s_[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return [im[sl] for im in imgs], flow[sl]

    def draw_flips(self, flow):
        """Raw-event (device-voxelize) mode: draw the h/v flip decisions,
        apply them to the label only, and return the flags so that the
        grids are flipped on the device (``data.device_input.flip_batch``).
        The same draws as ``_flips``."""
        fh = fv = False
        if self.do_flip:
            if self.rng.random() < self.h_flip_prob:
                fh = True
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if self.rng.random() < self.v_flip_prob:
                fv = True
                flow = flow[::-1, :] * [1.0, -1.0]
        return np.ascontiguousarray(flow), fh, fv

    def draw_crop(self, height, width):
        """A random crop offset in the full frame, for the crop on the
        device (raw-event mode): the draws of ``_crop``."""
        y0 = int(self.rng.integers(0, height - self.crop_size[0] + 1))
        x0 = int(self.rng.integers(0, width - self.crop_size[1] + 1))
        return y0, x0

    def __call__(self, img1, img2, flow, without_resize=False):
        if without_resize:
            (img1, img2), flow = self._flips([img1, img2], flow)
        else:
            ht, wd = img1.shape[:2]
            sx, sy = self._sample_scales(ht, wd)
            if self.rng.random() < self.spatial_aug_prob:
                img1 = _resize(img1, sx, sy)
                img2 = _resize(img2, sx, sy)
                flow = _resize(flow, sx, sy) * [sx, sy]
            (img1, img2), flow = self._flips([img1, img2], flow)
            (img1, img2), flow = self._crop([img1, img2], flow)
        return (
            np.ascontiguousarray(img1),
            np.ascontiguousarray(img2),
            np.ascontiguousarray(flow),
        )
