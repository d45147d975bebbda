"""E-RAFT — event RAFT (counterpart of ``eemflow_tpu/models/eraft.py:32-229``;
reference ``model/eraft.py:39-217``).

An instance-norm feature encoder (``fnet``, 256 channels) and a
batch-norm context encoder (``cnet``, 128 + 128), the all-pairs
correlation pyramid, then ``iters`` refinements of {multi-scale lookup →
motion encoder → SepConvGRU → Δflow}, each followed by the convex 8×
upsample.  ``coords1`` is detached at the start of every iteration, as
the reference's ``.detach()``.

``forward(ev1, ev2)`` takes NHWC [B, H, W, bins], replicate-pads to a
multiple of ``pad_rate`` in "chairs" mode (bottom rows only; 720×1280 →
736×1280, a 92×160 grid at 1/8) and returns ``((ev1, ev2), flows)`` with
``flows`` [iters, B, H, W, 2] unpadded (``[1, ...]`` when
``upsample_all=False``: the eval mode, in which the mask head and the
upsample run once, on the final net, and the last prediction is the
same).

``fused_update=True`` (eval only) runs the update block without its mask
head as kernel K5 (``ops/update_block.py``, ``kernels/update_block.py``),
twice per iteration, at every grid size; ``fused_dtype="bf16"`` rounds its
conv operands to bf16.  The JAX package runs its fused kernels only when
``upsample_all=False`` and its row tiling fits the grid height
(``tiles_ok``), falling back to the module path otherwise, which at
720×1280 (a 92-row grid) it always does; here K5 runs whenever
``fused_update`` is set and the model is not training, and with
``upsample_all=True`` the mask head runs after it in every iteration.
The module path and K5 compute the same function.  ``stacked_lookup=True``
stacks the correlation levels once, before the iterations, and looks all
of them up in one gather an iteration (``ops/corr_block.lookup_corr_stack``;
the same function, fewer operations for the host to issue), on either
path, in eval and in training.  K5's weights are built
once per dtype and model placement (``FusedUpdate``: its kernel layout
follows in-place edits of the parameters).  On the CPU its plain version
gives the module path's gradients; on the card K5 refuses to run under
grad while a parameter requires it.

The context encoder's BatchNorm normalises with the batch's statistics and
updates its running ones in training mode (``model.train()``, the JAX
``train=True``) and uses the running ones in eval mode
(``models/raft_core.BatchNorm``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from eemflow_tpu_torch.kernels import COMPUTE_DTYPES
from eemflow_tpu_torch.models.raft_core import BasicEncoder, BasicUpdateBlock
from eemflow_tpu_torch.ops.corr_block import (
    build_corr_pyramid, build_corr_stack, lookup_corr_pyramid, lookup_corr_stack,
)
from eemflow_tpu_torch.ops.pad import InputPadder
from eemflow_tpu_torch.ops.update_block import FusedUpdate, make_fused_update
from eemflow_tpu_torch.ops.upsample import convex_upsample_flow


def coords_grid(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """[B, H, W, 2] (x, y) pixel coordinate grid (reference ``model_utils.py:24-27``)."""
    ys, xs = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=device),
        torch.arange(wd, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=-1)[None].expand(batch, ht, wd, 2)


class ERAFT(nn.Module):
    def __init__(
        self,
        n_first_channels: int = 5,
        iters: int = 12,
        hidden_dim: int = 128,
        context_dim: int = 128,
        corr_levels: int = 4,
        corr_radius: int = 4,
        pad_rate: int = 32,
        upsample_all: bool = True,
        corr_fast: bool = False,
        stacked_lookup: bool = False,
        fused_update: bool = False,
        fused_dtype: str = "float32",
        siamese_stack: bool = False,
    ):
        super().__init__()
        if fused_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"fused_dtype must be one of {sorted(COMPUTE_DTYPES)}")
        self.iters = iters
        self.hidden_dim = hidden_dim
        self.context_dim = context_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.pad_rate = pad_rate
        self.upsample_all = upsample_all
        self.corr_fast = corr_fast
        self.stacked_lookup = stacked_lookup
        self.fused_update = fused_update
        self.fused_dtype = fused_dtype
        self.siamese_stack = siamese_stack
        # K5's weights by dtype, dropped when the model is moved
        self._fused: Dict[torch.dtype, FusedUpdate] = {}

        self.fnet = BasicEncoder(256, "instance", n_first_channels)
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch", n_first_channels)
        self.update_block = BasicUpdateBlock(hidden_dim, corr_levels, corr_radius)

    def _apply(self, *args, **kwargs):
        self._fused.clear()
        return super()._apply(*args, **kwargs)

    def forward(
        self,
        events1: torch.Tensor,
        events2: torch.Tensor,
        iters: Optional[int] = None,
        flow_init: Optional[torch.Tensor] = None,
        train: bool = False,
    ):
        n_iters = self.iters if iters is None else iters
        B, H, W, _ = events1.shape
        padder = InputPadder((H, W), mode="chairs", eval_pad_rate=self.pad_rate)
        im1, im2 = padder.pad_nchw(
            events1.permute(0, 3, 1, 2).contiguous(), events2.permute(0, 3, 1, 2).contiguous()
        )
        if self.siamese_stack:
            fmaps = self.fnet(torch.cat([im1, im2], dim=0))
            fmap1, fmap2 = fmaps[:B], fmaps[B:]
        else:
            fmap1, fmap2 = self.fnet(im1), self.fnet(im2)
        pyramid = build_corr_pyramid(
            fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 3, 1), self.corr_levels, fast=self.corr_fast
        )
        cnet = self.cnet(im1)
        net = torch.tanh(cnet[:, : self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim :])

        h8, w8 = im1.shape[2] // 8, im1.shape[3] // 8
        coords0 = coords_grid(B, h8, w8, device=im1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init

        fused = None
        if self.fused_update and not train:
            dtype = COMPUTE_DTYPES[self.fused_dtype]
            if dtype not in self._fused:
                self._fused[dtype] = make_fused_update(self.update_block, dtype)
            fused = self._fused[dtype]
        flows = raft_refine(
            self.update_block, pyramid, net, inp, coords0, coords1, n_iters,
            self.corr_radius, upsample_all=self.upsample_all,
            stacked_lookup=self.stacked_lookup, fused_apply=fused,
        )
        return (events1, events2), padder.unpad(flows)


def raft_refine(update_block, pyramid, net, inp, coords0, coords1, n_iters, radius,
                upsample_all: bool = True, stacked_lookup: bool = False, fused_apply=None,
                extra_args: tuple = ()) -> torch.Tensor:
    """The RAFT refinement loop (a Python loop over the iterations).  net and
    inp are NCHW, coords NHWC.  Returns the upsampled predictions
    [iters, B, 8h, 8w, 2], or [1, ...] of the final iterate when
    ``upsample_all=False``.  ``stacked_lookup``: the level stack is built
    here, once, and every iteration looks it up.  ``fused_apply(net, inp,
    corr, flow)`` (NHWC) replaces the update block without its mask head.
    ``extra_args`` follow the flow in every call of the update block (GMA's
    and SKFlow's attention map)."""
    if stacked_lookup:
        stack, shapes = build_corr_stack(pyramid)
        lookup = lambda c: lookup_corr_stack(stack, shapes, c, radius)
    else:
        lookup = lambda c: lookup_corr_pyramid(pyramid, c, radius)
    preds = []
    if fused_apply is not None:
        # NHWC for K5, converted once outside the loop
        net = net.permute(0, 2, 3, 1).contiguous()
        inp = inp.permute(0, 2, 3, 1).contiguous()
    for _ in range(n_iters):
        coords1 = coords1.detach()
        # the lookup is float32; the update block runs at the carry's dtype
        # (bf16 under mixed precision), the coordinates stay float32
        corr = lookup(coords1).to(net.dtype)
        flow = (coords1 - coords0).to(net.dtype)
        if fused_apply is not None:
            net, delta = fused_apply(net, inp, corr, flow)
            up_mask = None
            if upsample_all:
                up_mask = update_block.upsample_mask(net.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            net, up_mask, delta = update_block(
                net, inp, corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), *extra_args,
                compute_mask=upsample_all,
            )
            delta = delta.permute(0, 2, 3, 1)
            if up_mask is not None:
                up_mask = up_mask.permute(0, 2, 3, 1)
        coords1 = coords1 + delta.to(coords1.dtype)
        if upsample_all:
            preds.append(convex_upsample_flow(coords1 - coords0, up_mask))
    if not upsample_all:
        final = net if fused_apply is None else net.permute(0, 3, 1, 2)
        up_mask = update_block.upsample_mask(final).permute(0, 2, 3, 1)
        preds.append(convex_upsample_flow(coords1 - coords0, up_mask))
    return torch.stack(preds, dim=0)

