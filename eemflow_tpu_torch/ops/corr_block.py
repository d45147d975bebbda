"""All-pairs correlation pyramid and its multi-scale windowed lookup
(counterpart of ``eemflow_tpu/ops/corr_block.py:29-78, 192-285``;
reference ``model/corr.py:12-60``).

  * ``build_corr_pyramid`` — the all-pairs correlation ⟨f1(y,x), f2(Y,X)⟩/√C
    as one ``torch.matmul`` per level against the average-pooled *feature
    map* (correlation is linear in f2, so pooling the features equals
    pooling the response maps), viewed as a batch of (Hl, Wl) maps, one
    per query pixel;
  * ``lookup_corr_pyramid`` — per iteration, a (2r+1)×(2r+1) window
    sampled bilinearly with zero padding at ``coords / 2^level`` from each
    level, concatenated to [B, H, W, levels·(2r+1)²].

The JAX package's quirks are kept:

  * the flat window index is x-major, ``(x_off+r)·(2r+1) + (y_off+r)``,
    because the reference feeds the meshgrid's first component to the
    sampler's x axis;
  * a level axis of size 1 maps every tap to pixel 0 with weight 1 (the
    reference's grid_sample round trip);
  * a level too small to pool (an axis under 2) is repeated as the next
    level, so the channel count stays fixed.

``fast=True`` (serving mode): bf16 operands, float32 accumulation, the
volumes stored bf16; the lookup then rounds its tap weights and its
x-contracted intermediate to bf16, as the JAX bf16 path does.  The lookup
is plain tensor code: a gather of the four cells around each tap, the x
taps combined first and the y taps second, as the JAX contraction orders
them.  The stacked variants (``stacked_lookup``) are not ported.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def build_corr_pyramid(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, fast: bool = False
) -> List[torch.Tensor]:
    """fmap1, fmap2 NHWC [B, H, W, C] → ``num_levels`` volumes
    [B·H·W, Hl, Wl, 1], float32 (bf16 when ``fast``)."""
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B, H * W, C).float()
    if fast:
        f1 = f1.to(torch.bfloat16).float()
    inv_sqrt_c = 1.0 / torch.sqrt(torch.tensor(float(C), dtype=torch.float32))
    inv_sqrt_c = inv_sqrt_c.to(fmap1.device)
    pyramid: List[torch.Tensor] = []
    # pooled in float32 in either mode, NCHW for avg_pool2d
    f2l = fmap2.float().permute(0, 3, 1, 2)
    for _ in range(num_levels):
        Hl, Wl = f2l.shape[2:]
        f2m = f2l.reshape(B, C, Hl * Wl)
        if fast:
            # products of bf16 values are exact in float32, so a float32
            # matmul of the rounded operands is bf16 × bf16 → f32
            f2m = f2m.to(torch.bfloat16).float()
        corr = torch.matmul(f1, f2m) * inv_sqrt_c
        if fast:
            corr = corr.to(torch.bfloat16)
        pyramid.append(corr.reshape(B * H * W, Hl, Wl, 1))
        if Hl >= 2 and Wl >= 2:
            f2l = F.avg_pool2d(f2l, 2, 2)
    return pyramid


def _axis_taps(pos: torch.Tensor, offs: torch.Tensor, size: int, fast: bool):
    """Bilinear taps of ``pos[q] + offs[t]`` on an axis of ``size`` cells:
    (index of the lower cell, clamped, [N, n, 2]) and (its weight and the
    upper cell's, zero for a cell outside the axis, [N, n, 2])."""
    if size == 1:
        pos = torch.zeros_like(pos)
        offs = torch.zeros_like(offs)
    p = pos[:, None] + offs[None, :]
    i0 = torch.floor(p)
    f = p - i0
    idx = torch.stack([i0, i0 + 1.0], dim=-1)
    w = torch.stack([1.0 - f, f], dim=-1)
    inside = (idx >= 0) & (idx <= size - 1)
    w = torch.where(inside, w, torch.zeros_like(w))
    if fast:
        w = w.to(torch.bfloat16).float()
    return idx.clamp(0, size - 1).long(), w


def lookup_corr_pyramid(pyramid: List[torch.Tensor], coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """coords NHWC [B, H, W, 2] (x, y) at level-0 resolution →
    [B, H, W, levels·(2r+1)²] float32."""
    B, H, W, _ = coords.shape
    n = 2 * radius + 1
    N = B * H * W
    dev = coords.device
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    cx = coords[..., 0].reshape(N).float()
    cy = coords[..., 1].reshape(N).float()
    fast = pyramid[0].dtype == torch.bfloat16
    q = torch.arange(N, device=dev)[:, None, None, None, None]
    out = []
    for lvl, corr in enumerate(pyramid):
        c = corr[..., 0]
        Hl, Wl = c.shape[1:]
        scale = torch.tensor(0.5 ** lvl, dtype=torch.float32, device=dev)
        ix, wx = _axis_taps(cx * scale, offs, Wl, fast)  # [N, n(x), 2]
        iy, wy = _axis_taps(cy * scale, offs, Hl, fast)  # [N, n(y), 2]
        # the four cells of tap (i, j): [N, n(x), n(y), 2(y), 2(x)]
        vals = c[q, iy[:, None, :, :, None], ix[:, :, None, None, :]].float()
        tmp = (vals * wx[:, :, None, None, :]).sum(-1)  # x taps first
        if fast:
            tmp = tmp.to(torch.bfloat16).float()
        win = (tmp * wy[:, None, :, :]).sum(-1)  # [N, n(x), n(y)]
        out.append(win.reshape(B, H, W, n * n))
    return torch.cat(out, dim=-1)
