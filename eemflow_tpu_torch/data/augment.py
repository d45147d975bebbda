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

The resize branch (random scale and stretch, then flips and a crop) needs
an image resize that the card's machine does not have; it comes, with the
crops, with the MVSEC training slice, and ``without_resize=False`` raises
until then.
"""

from __future__ import annotations

import numpy as np


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

    def _flips(self, imgs, flow):
        if self.do_flip:
            if self.rng.random() < self.h_flip_prob:
                imgs = [im[:, ::-1] for im in imgs]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if self.rng.random() < self.v_flip_prob:
                imgs = [im[::-1, :] for im in imgs]
                flow = flow[::-1, :] * [1.0, -1.0]
        return imgs, flow

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

    def __call__(self, img1, img2, flow, without_resize=False):
        if not without_resize:
            raise NotImplementedError(
                "FlowAugmentor: the resize branch comes with the MVSEC training slice; "
                "HREM training takes without_resize=True"
            )
        (img1, img2), flow = self._flips([img1, img2], flow)
        return (
            np.ascontiguousarray(img1),
            np.ascontiguousarray(img2),
            np.ascontiguousarray(flow),
        )
