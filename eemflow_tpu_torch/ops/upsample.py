"""Bilinear resizing, EEMFlow's and EEMFlow+'s flow upsamplers, ``upflow8``
and RAFT's convex upsampler (counterpart of ``eemflow_tpu/ops/upsample.py:
25-109``), NHWC in and out.

align_corners=False is torch ``F.interpolate``'s own convention
(src = (dst+0.5)·in/out − 0.5, clamped at 0), which the JAX package
rebuilt by hand; align_corners=True maps the corners onto each other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Resize an NHWC tensor to (H, W) = size with torch bilinear numerics.
    A bf16 input is interpolated in float32 and the result rounded once:
    the card's backward of a bf16 interpolation adds each output's gradient
    into its source cells with bf16 atomics, and upsampling EEMFlow+'s
    coarsest flow 64× gathers thousands of them a cell (a bf16 train step's
    gradient 28% from float32's on the card, 0.3% on the CPU)."""
    h, w = size
    if tuple(x.shape[1:3]) == (h, w):
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2).float(), size=(h, w), mode="bilinear",
        align_corners=align_corners,
    )
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample_flow_to(flow: torch.Tensor, size) -> torch.Tensor:
    """EEMFlow final upsampler: plain bilinear (align_corners=False), flow
    values NOT rescaled (reference ``EEMFlow.py:118-120``)."""
    return resize_bilinear(flow, size, align_corners=False)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8× bilinear (align_corners=True), magnitudes ×8."""
    _, h, w, _ = flow.shape
    return 8.0 * resize_bilinear(flow, (8 * h, 8 * w), align_corners=True)


_RATES: dict = {}


def upsample2d_flow_as(flow: torch.Tensor, target_hw, if_rate: bool = False) -> torch.Tensor:
    """EEMFlow+'s upsampler (reference ``cdc_utils.py:80-103``): resize
    (align_corners=True) to ``target_hw``, and with ``if_rate`` scale u by
    the width ratio and v by the height ratio."""
    h, w = target_hw
    _, h_, w_, _ = flow.shape
    res = resize_bilinear(flow, (h, w), align_corners=True)
    if if_rate:
        key = (w / w_, h / h_, res.dtype, res.device)
        scale = _RATES.get(key)
        if scale is None:  # made once: a fresh copy to the card each call costs the host
            with torch.inference_mode(False):  # a normal tensor, which training may save
                scale = _RATES[key] = torch.tensor(key[:2], dtype=res.dtype, device=res.device)
        res = res * scale
    return res


def convex_upsample_flow(flow: torch.Tensor, mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """RAFT's convex-combination upsampler (reference ``model/eraft.py:83-94``).

    flow NHWC [B, h, w, 2]; mask NHWC [B, h, w, 9·factor²] in the torch
    channel layout c = k·factor² + iy·factor + ix (k the 3×3 neighbour,
    ky-major).  A softmax over the 9 neighbours weighs ``factor · flow``
    around each cell.  Returns [B, h·factor, w·factor, 2]."""
    B, h, w, _ = flow.shape
    f = factor
    m = torch.softmax(mask.permute(0, 3, 1, 2).reshape(B, 1, 9, f, f, h, w), dim=2)
    nb = F.unfold(f * flow.permute(0, 3, 1, 2), [3, 3], padding=1).reshape(B, 2, 9, 1, 1, h, w)
    up = (m * nb).sum(dim=2)  # [B, 2, f(iy), f(ix), h, w]
    return up.permute(0, 4, 2, 5, 3, 1).reshape(B, h * f, w * f, 2)
