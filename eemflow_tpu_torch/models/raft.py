"""The original image RAFT (counterpart of ``eemflow_tpu/models/raft.py``;
reference ``model/raft.py:27-147``), kept for the image baselines.

E-RAFT's network and refinement loop (``models.eraft.raft_refine``) on
inputs normalised to [-1, 1] by ``2·x/255 − 1`` and replicate-padded to a
multiple of ``pad_rate`` (8) in "sintel" mode (centred).  Flax infers the
first conv's input channels from the batch; here ``n_first_channels``
fixes them (3 for images; the HREM CLIs set the data's voxel bins).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from eemflow_tpu_torch.models.eraft import coords_grid, raft_refine
from eemflow_tpu_torch.models.raft_core import BasicEncoder, BasicUpdateBlock
from eemflow_tpu_torch.ops.corr_block import build_corr_pyramid
from eemflow_tpu_torch.ops.pad import InputPadder

class RAFT(nn.Module):
    """forward(image1, image2 [B, H, W, C]) → ((image1, image2) normalised,
    flows [iters, B, H, W, 2]), or [1, ...] with ``upsample_all=False``."""

    def __init__(
        self,
        n_first_channels: int = 3,
        iters: int = 12,
        hidden_dim: int = 128,
        context_dim: int = 128,
        corr_levels: int = 4,
        corr_radius: int = 4,
        pad_rate: int = 8,
        upsample_all: bool = True,
        corr_fast: bool = False,
        normalize_input: bool = True,
    ):
        super().__init__()
        self.iters = iters
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.pad_rate = pad_rate
        self.upsample_all = upsample_all
        self.corr_fast = corr_fast
        self.normalize_input = normalize_input
        self.fnet = BasicEncoder(256, "instance", n_first_channels)
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch", n_first_channels)
        self.update_block = BasicUpdateBlock(hidden_dim, corr_levels, corr_radius)

    def forward(
        self,
        image1: torch.Tensor,
        image2: torch.Tensor,
        iters: Optional[int] = None,
        flow_init: Optional[torch.Tensor] = None,
        train: bool = False,
    ):
        n_iters = self.iters if iters is None else iters
        B, H, W, _ = image1.shape
        if self.normalize_input:
            image1 = 2 * (image1 / 255.0) - 1.0
            image2 = 2 * (image2 / 255.0) - 1.0
        padder = InputPadder((H, W), mode="sintel", eval_pad_rate=self.pad_rate)
        im1, im2 = padder.pad_nchw(
            image1.permute(0, 3, 1, 2).contiguous(), image2.permute(0, 3, 1, 2).contiguous()
        )
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
        flows = raft_refine(
            self.update_block, pyramid, net, inp, coords0, coords1, n_iters,
            self.corr_radius, upsample_all=self.upsample_all,
        )
        return (image1, image2), padder.unpad(flows)
