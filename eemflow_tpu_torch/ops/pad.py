"""Input padding to network-friendly sizes (counterpart of
``eemflow_tpu/ops/pad.py:21-84``).

``InputPadder`` replicate-pads H and W up to the next multiple of
``eval_pad_rate`` (reference ``utils/image_utils.py:126-145``).  Mode
``chairs`` pads the bottom only and splits the width left/right; mode
``sintel`` centres both.  EEMFlow uses ``pad_rate=64``, so 720×1280 pads
to 768×1280 (48 bottom rows).  ``ImagePadder`` zero-pads the top and the
left of NHWC images to a multiple of ``min_size``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads images so H and W are divisible by ``eval_pad_rate``.

    ``pad``/``unpad`` take NHWC like the JAX package; the model pads its
    NCHW activations with ``pad_nchw``."""

    def __init__(self, dims, mode: str = "sintel", eval_pad_rate: int = 32):
        self.eval_pad_rate = eval_pad_rate
        self.ht, self.wd = dims[-2], dims[-1]
        r = eval_pad_rate
        pad_ht = (((self.ht // r) + 1) * r - self.ht) % r
        pad_wd = (((self.wd // r) + 1) * r - self.wd) % r
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
        elif mode == "chairs":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]
        else:
            raise ValueError(f"unknown pad mode {mode!r}")

    @property
    def padded_shape(self):
        l, r, t, b = self._pad
        return (self.ht + t + b, self.wd + l + r)

    def pad_nchw(self, *inputs: torch.Tensor):
        """Replicate-pad each [B, C, H, W] tensor; returns a list."""
        if not any(self._pad):
            return list(inputs)
        return [F.pad(x, self._pad, mode="replicate") for x in inputs]

    def pad(self, *inputs: torch.Tensor):
        """Replicate-pad each NHWC tensor; returns a list like the reference."""
        out = self.pad_nchw(*(x.permute(0, 3, 1, 2) for x in inputs))
        return [x.permute(0, 2, 3, 1) for x in out]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """Remove padding from [..., H, W, C]."""
        l, r, t, b = self._pad
        ht, wd = x.shape[-3], x.shape[-2]
        return x[..., t : ht - b, l : wd - r, :]


class ImagePadder:
    """Zero-pads top and left to a multiple of ``min_size`` (NHWC); the
    amounts are fixed by the first image padded."""

    def __init__(self, min_size: int = 64):
        self.min_size = min_size
        self.pad_height = None
        self.pad_width = None

    def pad(self, image: torch.Tensor) -> torch.Tensor:
        height, width = image.shape[1], image.shape[2]
        if self.pad_width is None:
            self.pad_height = (self.min_size - height % self.min_size) % self.min_size
            self.pad_width = (self.min_size - width % self.min_size) % self.min_size
        return F.pad(image, (0, 0, self.pad_width, 0, self.pad_height, 0))

    def unpad(self, image: torch.Tensor) -> torch.Tensor:
        return image[:, self.pad_height :, self.pad_width :, :]
