"""GMA — RAFT + Global Motion Aggregation (counterpart of
``eemflow_tpu/models/gma.py:41-171``; reference ``model/GMA/network.py``
``RAFTGMA`` and ``model/GMA/gma.py``).

E-RAFT's skeleton (an instance-norm ``fnet``, a batch-norm ``cnet``, the
all-pairs correlation pyramid, the SepConvGRU refinement loop) plus a
single-head content self-attention over the context features: its
[B, HW, HW] map is computed once, before the loop (``GMAAttention``: a 1×1
``to_qk``, ``dim_head**-0.5`` on q, the softmax over the last axis), and in
every iteration it aggregates the motion features over the whole grid
(``GMAAggregate``: a 1×1 ``to_v``, then ``fmap + gamma·(attn @ v)``).  The
GRU input is ``[inp, motion, motion_global]``, 384 channels.

The HREM entry point runs the content-only attention (heads 1, no position
terms): the relative position tables a released checkpoint carries are
never read, and the loader drops them (``GMA_DROP``).  The gate ``gamma``
starts at zero, as flax's ``nn.initializers.zeros``: at a zero gate the
aggregation adds nothing, and the golden checkpoints carry it at zero, so
their AEEs never exercise the attention.

The matmuls run in float32 (the CLIs turn TF32 off, as JAX's
``Precision.HIGHEST``).  Attribute names are the reference's
(``att.to_qk``, ``update_block.aggregator.to_v``,
``update_block.aggregator.gamma``, ``update_block.mask.0/2``), so a
released checkpoint loads with a strict ``load_state_dict``.  ``forward``
takes and returns what ``models.eraft.ERAFT.forward`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.models.eraft import coords_grid, raft_refine
from eemflow_tpu_torch.models.raft_core import BasicEncoder, BasicMotionEncoder, FlowHead, SepConvGRU
from eemflow_tpu_torch.ops.corr_block import build_corr_pyramid
from eemflow_tpu_torch.ops.pad import InputPadder

# checkpoint keys with no live forward path (the relative position tables)
GMA_DROP = ("att.pos_emb.",)


class GMAAttention(nn.Module):
    """Content self-attention map (reference ``gma.py:34-78``, heads 1):
    NCHW [B, C, H, W] → [B, HW, HW], each row a softmax."""

    def __init__(self, dim: int = 128, dim_head: int = 128):
        super().__init__()
        self.dim_head = dim_head
        self.to_qk = nn.Conv2d(dim, 2 * dim_head, 1, bias=False)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        q, k = self.to_qk(fmap).flatten(2).chunk(2, dim=1)  # [B, D, HW] each
        q = q * (self.dim_head ** -0.5)
        return torch.softmax(q.transpose(1, 2) @ k, dim=-1)


class GMAAggregate(nn.Module):
    """Attention-weighted global aggregation with a learned residual gate
    (reference ``gma.py:81-115``): NCHW in and out."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.to_v = nn.Conv2d(dim, dim, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        B, C, H, W = fmap.shape
        v = self.to_v(fmap).flatten(2)  # [B, C, HW]
        out = (v @ attn.transpose(1, 2)).view(B, C, H, W)
        return fmap + self.gamma * out


class GMAUpdateBlock(nn.Module):
    """RAFT's update block with the global motion term in the GRU's input
    (reference ``GMA/update.py:112-139``).  ``forward(..., compute_mask=
    False)`` skips the mask head, which ``upsample_mask`` runs on its own,
    as ``raft_core.BasicUpdateBlock``."""

    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.aggregator = GMAAggregate(128)
        self.gru = SepConvGRU(hidden_dim, input_dim=128 + 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1, padding=0),
        )

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask(net)

    def forward(
        self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor, flow: torch.Tensor,
        attention: torch.Tensor, compute_mask: bool = True,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        delta_flow = self.flow_head(net)
        up_mask = self.upsample_mask(net) if compute_mask else None
        return net, up_mask, delta_flow


class RAFTGMA(nn.Module):
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
        cnet_norm: str = "batch",
    ):
        super().__init__()
        self.iters = iters
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.pad_rate = pad_rate
        self.upsample_all = upsample_all
        self.corr_fast = corr_fast
        self.cnet_split = (hidden_dim, context_dim)
        self.fnet = BasicEncoder(256, "instance", n_first_channels)
        self.cnet = BasicEncoder(hidden_dim + context_dim, cnet_norm, n_first_channels)
        self.att = GMAAttention(context_dim, context_dim)
        self.update_block = self.make_update_block(hidden_dim, corr_levels, corr_radius)

    def make_update_block(self, hidden_dim: int, corr_levels: int, corr_radius: int) -> nn.Module:
        return GMAUpdateBlock(hidden_dim, corr_levels, corr_radius)

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
        fmap1, fmap2 = self.fnet(im1), self.fnet(im2)
        pyramid = build_corr_pyramid(
            fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 3, 1), self.corr_levels, fast=self.corr_fast
        )
        cnet = self.cnet(im1)
        net, inp = cnet.split(self.cnet_split, dim=1)
        net, inp = torch.tanh(net), F.relu(inp)
        attention = self.att(inp)

        h8, w8 = im1.shape[2] // 8, im1.shape[3] // 8
        coords0 = coords_grid(B, h8, w8, device=im1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        flows = raft_refine(
            self.update_block, pyramid, net, inp, coords0, coords1, n_iters, self.corr_radius,
            upsample_all=self.upsample_all, extra_args=(attention,),
        )
        return (events1, events2), padder.unpad(flows)
