"""Bilinear backwarping of EEMFlow+ (counterpart of
``eemflow_tpu/ops/warp.py:28-157``), NHWC in and out.

The reference mixes both ``F.grid_sample`` conventions, and the JAX
package rebuilt both by hand as one bilinear gather at pixel coordinates
with zero padding; the port keeps that gather, operation for operation,
rather than ``grid_sample`` (which reaches the same pixel coordinate
through a normalized grid, in another rounding):

  * ``backwarp`` — reference ``utils_luo/tools.py:2262-2307``
    ``torch_warp``: grid + flow normalized with ``2x/(W-1)-1`` but sampled
    with the default ``align_corners=False``, so the pixel coordinate is
    ``x·W/(W-1) − 0.5``.  The SGU's upsampler;
  * ``backwarp_masked`` — reference ``cdc_utils.py:50-78``
    ``WarpingLayer_no_div``: ``backwarp`` times an in-bounds mask, computed
    analytically (the sample lies inside [0, W-1]×[0, H-1]) as the JAX
    package computes it, not by thresholding a warped ones tensor;
  * ``warp_align_corners`` — reference ``EEMFlow+.py:137-149``: grid +
    flow sampled with ``align_corners=True`` (exact pixel coordinates);
  * ``pwc_warp`` — the IRR-PWC line's ``WarpingLayer``
    (``eemflow_tpu/models/irrpwc.py:81-94``): a flow in input-image pixels
    × ``div_flow`` moved onto the feature grid by ``(W−1)/(width_im−1)/
    div_flow``, align_corners=True, times the analytic in-bounds mask;
  * ``flownet_warp`` — the FlowNet line's (``eemflow_tpu/models/
    flownet1s.py:63-73``): the scale ``(W−1)/(width_im·div_flow)`` (÷W,
    not ÷(W−1)) and no mask.

The coordinates are computed in float32 whatever the feature dtype (a
bf16 coordinate cannot address a 1280-pixel row); the samples keep the
feature dtype.  The gather runs on the NCHW layout of the input (an NHWC
view of an NCHW tensor costs no copy) and returns an NHWC view of an NCHW
result.  ``bilinear_sampler`` and ``forward_interpolate`` come with the
RAFT items of ``ROADMAP.md``.
"""

from __future__ import annotations

import torch


def _gather_bilinear(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of NHWC ``img`` [B, H, W, C] at float32 pixel
    coordinates px, py [B, h, w], zero outside the image; the JAX
    ``_gather_bilinear``'s operations in its order.  Returns [B, h, w, C]."""
    B, H, W, C = img.shape
    src = img.permute(0, 3, 1, 2).reshape(B, C, H * W)
    h, w = px.shape[1:]
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = px - x0
    wx0 = 1.0 - wx1
    wy1 = py - y0
    wy0 = 1.0 - wy1

    def take(ix, iy):
        inb = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        ixc = ix.clamp(0, W - 1).long()
        iyc = iy.clamp(0, H - 1).long()
        idx = (iyc * W + ixc).reshape(B, 1, h * w).expand(B, C, h * w)
        vals = torch.gather(src, 2, idx).reshape(B, C, h, w)
        return vals * inb[:, None].to(img.dtype)

    def weight(a, b):
        return (a * b)[:, None].to(img.dtype)

    out = (
        take(x0, y0) * weight(wx0, wy0)
        + take(x1, y0) * weight(wx1, wy0)
        + take(x0, y1) * weight(wx0, wy1)
        + take(x1, y1) * weight(wx1, wy1)
    )
    return out.permute(0, 2, 3, 1)


def _coords(x: torch.Tensor, flow: torch.Tensor):
    """Pixel coordinates grid + flow, float32 [B, H, W] each."""
    B, H, W, _ = x.shape
    f = flow.float()
    gx = torch.arange(W, dtype=torch.float32, device=x.device).view(1, 1, W)
    gy = torch.arange(H, dtype=torch.float32, device=x.device).view(1, H, 1)
    return gx + f[..., 0], gy + f[..., 1]


def _unaligned(px: torch.Tensor, py: torch.Tensor, H: int, W: int):
    """torch's align_corners=False remap of the reference's ``2x/(W-1)-1``
    normalization: pixel ``x·W/(W-1) − 0.5``."""
    return px * (W / max(W - 1, 1)) - 0.5, py * (H / max(H - 1, 1)) - 0.5


def backwarp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``torch_warp``: warp ``x`` [B, H, W, C] back by ``flow`` [B, H, W, 2]
    (dx, dy), align_corners=False numerics."""
    B, H, W, _ = x.shape
    px, py = _coords(x, flow)
    return _gather_bilinear(x, *_unaligned(px, py, H, W))


def backwarp_masked(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``WarpingLayer_no_div``: ``backwarp``, zero where the remapped sample
    does not lie fully inside [0, W-1]×[0, H-1]."""
    B, H, W, _ = x.shape
    px, py = _coords(x, flow)
    ex, ey = _unaligned(px, py, H, W)
    out = _gather_bilinear(x, ex, ey)
    inb = (ex >= 0) & (ex <= W - 1) & (ey >= 0) & (ey <= H - 1)
    return out * inb[..., None].to(x.dtype)


def warp_align_corners(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """EEMFlow+'s ``warp``: backwarp with align_corners=True (exact pixel
    coordinates)."""
    return _gather_bilinear(x, *_coords(x, flow))


def _scaled_coords(x: torch.Tensor, flow: torch.Tensor, sx: float, sy: float):
    """Pixel coordinates grid + flow·(sx, sy), float32 [B, H, W] each."""
    B, H, W, _ = x.shape
    f = flow.float()
    gx = torch.arange(W, dtype=torch.float32, device=x.device).view(1, 1, W)
    gy = torch.arange(H, dtype=torch.float32, device=x.device).view(1, H, 1)
    return gx + f[..., 0] * sx, gy + f[..., 1] * sy


def pwc_warp(x: torch.Tensor, flow: torch.Tensor, height_im: int, width_im: int, div_flow: float) -> torch.Tensor:
    """IRR-PWC's ``WarpingLayer``: ``x`` [B, H, W, C] back by ``flow``
    [B, H, W, 2] given in input-image pixels × ``div_flow``, zero where the
    sample lies outside [0, W-1]×[0, H-1]."""
    B, H, W, _ = x.shape
    px, py = _scaled_coords(x, flow, (W - 1) / max(width_im - 1, 1) / div_flow,
                            (H - 1) / max(height_im - 1, 1) / div_flow)
    out = _gather_bilinear(x, px, py)
    inb = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    return out * inb[..., None].to(x.dtype)


def flownet_warp(x: torch.Tensor, flow: torch.Tensor, height_im: int, width_im: int, div_flow: float) -> torch.Tensor:
    """FlowNet's ``WarpingLayer``: ``x`` [B, H, W, C] back by ``flow``
    scaled by ``(W−1)/(width_im·div_flow)``, zero padding, no mask."""
    B, H, W, _ = x.shape
    return _gather_bilinear(x, *_scaled_coords(x, flow, (W - 1) / (width_im * div_flow),
                                               (H - 1) / (height_im * div_flow)))
