"""All-pairs correlation pyramid and its multi-scale windowed lookup
(counterpart of ``eemflow_tpu/ops/corr_block.py:29-285``;
reference ``model/corr.py:12-60``).

  * ``build_corr_pyramid`` — the all-pairs correlation ⟨f1(y,x), f2(Y,X)⟩/√C
    as one ``torch.matmul`` per level against the average-pooled *feature
    map* (correlation is linear in f2, so pooling the features equals
    pooling the response maps), viewed as a batch of (Hl, Wl) maps, one
    per query pixel;
  * ``lookup_corr_pyramid`` — per iteration, a (2r+1)×(2r+1) window
    sampled bilinearly with zero padding at ``coords / 2^level`` from each
    level, concatenated to [B, H, W, levels·(2r+1)²];
  * ``build_corr_stack`` / ``lookup_corr_stack`` (ERAFT's
    ``stacked_lookup``) — the levels zero-padded to level 0's extent and
    stacked once, [N, L, H0, W0], then every level's window in one gather
    over the stack; ``lookup_corr_pyramid_stacked`` is the two in one call.

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
them.

The JAX package contracts dense tap matrices (``_tap_matrix``, one row of
[size] weights a tap) on the TPU's matrix unit; a tap has two nonzero
weights, so the port gathers the two cells an axis instead
(``_axis_taps``), the same weights in the same order of sums.  The stacked
lookup is one gather and two sums for all levels where the per-level one
takes one of each a level: fewer operations for the host to issue, the
same function.  Its window stays float32 whatever the stack's dtype, as
JAX's stacked lookup casts the stack.
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


def build_corr_stack(pyramid: List[torch.Tensor]):
    """Zero-pad every pyramid level to level 0's extent and stack them:
    → ([N, L, H0, W0], [(Hl, Wl), ...]).  Build it once when the pyramid
    serves several lookups (``models.eraft.raft_refine``)."""
    H0, W0 = pyramid[0].shape[1:3]
    stack = torch.stack(
        [F.pad(c[..., 0], (0, W0 - c.shape[2], 0, H0 - c.shape[1])) for c in pyramid], dim=1
    )
    return stack, [tuple(c.shape[1:3]) for c in pyramid]


# per (level shapes, radius, device): the levels' scales, last cells,
# size-1 flags and offsets into a flattened stack, made once (a fresh copy
# to the card each lookup costs the host)
_STACK_CONSTS: dict = {}


def _stack_consts(level_shapes, H0: int, W0: int, radius: int, device):
    key = (tuple(level_shapes), H0, W0, radius, device)
    consts = _STACK_CONSTS.get(key)
    if consts is None:
        consts = _STACK_CONSTS[key] = _make_stack_consts(level_shapes, H0, W0, radius, device)
    return consts


@torch.inference_mode(False)  # normal tensors, which training may save
def _make_stack_consts(level_shapes, H0: int, W0: int, radius: int, device) -> dict:
    L = len(level_shapes)
    hs = [h for h, _ in level_shapes]
    ws = [w for _, w in level_shapes]
    as_t = lambda v, dtype=torch.float32: torch.tensor(v, dtype=dtype, device=device)[:, None]
    return {
        "scale": as_t([0.5 ** l for l in range(L)]),
        "x_last": as_t([w - 1 for w in ws]), "y_last": as_t([h - 1 for h in hs]),
        "x_one": as_t([w == 1 for w in ws], torch.bool), "y_one": as_t([h == 1 for h in hs], torch.bool),
        "base": as_t([l * H0 * W0 for l in range(L)], torch.long),
        "offs": torch.arange(-radius, radius + 1, dtype=torch.float32, device=device),
    }


def _stack_taps(pos: torch.Tensor, consts: dict, last: torch.Tensor, one: torch.Tensor):
    """``_axis_taps`` for every level at once: ``pos`` [N] at level 0 →
    (lower cells, clamped, [N, L, n, 2]; their weights and the upper
    cells', zero outside the level's extent).  A size-1 axis maps every
    tap to cell 0 with weight 1."""
    p = pos[:, None, None] * consts["scale"] + consts["offs"]  # [N, L, n]
    p = torch.where(one, torch.zeros_like(p), p)
    i0 = torch.floor(p)
    f = p - i0
    idx = torch.stack([i0, i0 + 1.0], dim=-1)
    w = torch.stack([1.0 - f, f], dim=-1)
    w = torch.where((idx >= 0) & (idx <= last[..., None]), w, torch.zeros_like(w))
    return torch.minimum(idx.clamp(min=0), last[..., None]).long(), w


def lookup_corr_stack(stack: torch.Tensor, level_shapes, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The windowed lookup over a zero-padded level stack [N, L, H0, W0]
    (``level_shapes`` the levels' own extents): coords NHWC [B, H, W, 2]
    (x, y) at level 0 → [B, H, W, L·(2r+1)²] float32, equal to
    ``lookup_corr_pyramid`` on the levels.  A padded cell only ever meets a
    zero weight."""
    B, H, W, _ = coords.shape
    n = 2 * radius + 1
    N = B * H * W
    L, H0, W0 = stack.shape[1:]
    consts = _stack_consts(level_shapes, H0, W0, radius, stack.device)
    ix, wx = _stack_taps(coords[..., 0].reshape(N).float(), consts, consts["x_last"], consts["x_one"])
    iy, wy = _stack_taps(coords[..., 1].reshape(N).float(), consts, consts["y_last"], consts["y_one"])
    # the four cells of tap (i, j) in the flattened stack: [N, L, n(x), n(y), 2(y), 2(x)]
    cell = (consts["base"][..., None, None, None] + iy[:, :, None, :, :, None] * W0
            + ix[:, :, :, None, None, :])
    vals = stack.reshape(N, L * H0 * W0).gather(1, cell.reshape(N, -1)).float().reshape(N, L, n, n, 2, 2)
    tmp = (vals * wx[:, :, :, None, None, :]).sum(-1)  # x taps first
    win = (tmp * wy[:, :, None, :, :]).sum(-1)  # [N, L, n(x), n(y)]
    return win.reshape(B, H, W, L * n * n)


def lookup_corr_pyramid_stacked(pyramid: List[torch.Tensor], coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """``lookup_corr_pyramid``'s result through the level stack (built on
    every call: build it once with ``build_corr_stack`` where the pyramid
    is reused)."""
    stack, shapes = build_corr_stack(pyramid)
    return lookup_corr_stack(stack, shapes, coords, radius)
