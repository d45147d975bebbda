"""SKFlow — super-kernel update blocks with GMA's global aggregation
(counterpart of ``eemflow_tpu/models/skflow.py:27-146``; reference
``model/SKflow/models/sk_decoder.py`` and ``SKflow/update.py``).

E-RAFT's skeleton; the update block replaces plain convs by ``PCBlock``s,
residual depthwise large-kernel mixers between pointwise FFNs
(``update.py:8-32``), aggregates the motion features with GMA's attention
map, and its GRU is itself a ``PCBlock`` over ``[net, inp, motion,
motion_global]`` (512 channels).  ``k_conv=(1, 15)`` means two *square*
depthwise convs, 1×1 then 15×15, each ``(k - 1)/2`` padded; the updater's
are (1, 7).  Every GELU is the exact (erf) one.  The mid width of a
``PCBlock`` is ``int(1.5·c_in)``; the motion encoder gives 126 + 2
channels.  The refinement starts at ``coords0`` (no ``flow_init``).

Attribute names are the reference's (``conv_list.0/1``, ``ffn1.0/2``,
``pw``, ``ffn2.0/2``, ``update_block.mask.0/2``), so a released checkpoint
loads strictly once its dead relative position tables are dropped
(``models.gma.GMA_DROP``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.models.gma import RAFTGMA, GMAAggregate


def _ffn(c_in: int, mid: int, c_out: int) -> nn.Sequential:
    """1×1 conv, exact GELU, 1×1 conv (keys ``.0`` and ``.2``)."""
    return nn.Sequential(nn.Conv2d(c_in, mid, 1), nn.GELU(), nn.Conv2d(mid, c_out, 1))


class PCBlock(nn.Module):
    """Residual depthwise large-kernel mixer (reference ``update.py:8-32``):
    NCHW [B, c_in, H, W] → [B, c_out, H, W]."""

    def __init__(self, c_in: int, c_out: int, k_conv: Sequence[int] = (1, 15)):
        super().__init__()
        mid = int(1.5 * c_in)
        self.ffn1 = _ffn(c_in, mid, c_in)
        self.conv_list = nn.ModuleList(nn.Conv2d(c_in, c_in, k, 1, k // 2, groups=c_in) for k in k_conv)
        self.pw = nn.Conv2d(c_in, c_in, 1)
        self.ffn2 = _ffn(c_in, mid, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(x + self.ffn1(x))
        for conv in self.conv_list:
            x = F.gelu(x + conv(x))
        x = F.gelu(x + self.pw(x))
        return self.ffn2(x)


class SKMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4, k_conv: Sequence[int] = (1, 15)):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = PCBlock(cor_planes, 256, k_conv)
        self.convc2 = PCBlock(256, 192, k_conv)
        self.convf1 = nn.Conv2d(2, 128, 1)
        self.convf2 = PCBlock(128, 64, k_conv)
        self.conv = PCBlock(256, 128 - 2, k_conv)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = self.convc2(F.gelu(self.convc1(corr)))
        flo = self.convf2(self.convf1(flow))
        out = self.conv(torch.cat([cor, flo], dim=1))
        return torch.cat([out, flow], dim=1)


class SKUpdateBlock(nn.Module):
    """``forward(..., compute_mask=False)`` skips the mask head, which
    ``upsample_mask`` runs on its own (the eval mode's final net)."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4, k_conv: Sequence[int] = (1, 15),
                 updater_conv: Sequence[int] = (1, 7)):
        super().__init__()
        self.encoder = SKMotionEncoder(corr_levels, corr_radius, k_conv)
        self.aggregator = GMAAggregate(128)
        self.gru = PCBlock(4 * 128, 128, updater_conv)
        self.flow_head = PCBlock(128, 2, k_conv)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1),
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
        net = self.gru(torch.cat([net, inp, motion, motion_global], dim=1))
        delta_flow = self.flow_head(net)
        up_mask = self.upsample_mask(net) if compute_mask else None
        return net, up_mask, delta_flow


class SKFlow(RAFTGMA):
    """The reference's ``SK_Decoder`` on E-RAFT's encoders: ``RAFTGMA`` with
    ``SKUpdateBlock``, ``pad_rate`` 8, the context split fixed at 128/128
    and no ``flow_init``.  ``hidden_dim`` is a field that nothing reads, as
    in JAX."""

    def __init__(
        self,
        n_first_channels: int = 5,
        iters: int = 12,
        hidden_dim: int = 128,
        corr_levels: int = 4,
        corr_radius: int = 4,
        pad_rate: int = 8,
        upsample_all: bool = True,
        corr_fast: bool = False,
        cnet_norm: str = "batch",
    ):
        super().__init__(n_first_channels, iters, 128, 128, corr_levels, corr_radius, pad_rate, upsample_all,
                         corr_fast, cnet_norm)
        self.hidden_dim = hidden_dim

    def make_update_block(self, hidden_dim: int, corr_levels: int, corr_radius: int) -> nn.Module:
        return SKUpdateBlock(corr_levels, corr_radius)

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, iters: Optional[int] = None,
                train: bool = False):
        return super().forward(events1, events2, iters, train=train)
