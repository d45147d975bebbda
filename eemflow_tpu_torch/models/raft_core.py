"""RAFT-lineage shared blocks (counterpart of
``eemflow_tpu/models/raft_core.py:27-161``), NCHW ``nn.Module``s.

  * ``ResidualBlock``/``BasicEncoder`` — reference ``model/extractor.py``:
    a 7×7/2 stem and three residual stages (64, 96, 128) down to 1/8, norm
    one of group, batch, instance or none, a 1×1 output head;
  * ``BasicMotionEncoder``/``SepConvGRU``/``FlowHead``/``BasicUpdateBlock``
    — reference ``model/update.py``: correlation and flow → 128 motion
    channels, a 1×5 then 5×1 ConvGRU, the flow head, and the
    convex-upsample mask head with its ×0.25 gradient-balance scale.

Attribute names are the reference's, so a released checkpoint loads with a
strict ``load_state_dict``: a strided block's ``downsample`` is a
``Sequential`` of its 1×1 conv and ``norm3``, and ``norm3`` is also
registered on its own, so both key spellings appear; the mask head is the
``Sequential`` ``mask`` (keys ``mask.0``, ``mask.2``).  ``BatchNorm`` is flax's ``nn.BatchNorm`` as
the JAX package trains it (see the class).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.models.layers import InstanceNorm


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` (JAX
    ``raft_core.make_norm``) with torch's parameter and buffer names.

    In training mode (``model.train()``, as the JAX ``train=True``) the
    batch's statistics normalise, and the running ones move a tenth of the
    way to the batch's mean and *biased* variance; torch's ``BatchNorm2d``
    would take the unbiased one.  Statistics and normalisation are float32
    whatever the input's dtype, and the result is cast back to it: flax
    promotes a bf16 input and bf16 scale and bias to float32 alike, and the
    running statistics stay float32.  In eval mode the running statistics
    normalise, in float32 likewise."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
                self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
            stats = (None, None)
        else:
            stats = (self.running_mean, self.running_var)
        y = F.batch_norm(x32, *stats, self.weight.float(), self.bias.float(), self.training, 0.0, self.eps)
        return y.to(x.dtype)


def make_norm(norm_fn: str, channels: int) -> nn.Module:
    """The requested norm over ``channels`` (``nn.Sequential()`` for none)."""
    if norm_fn == "group":
        return nn.GroupNorm(channels // 8, channels, eps=1e-5)
    if norm_fn == "batch":
        return BatchNorm(channels)
    if norm_fn == "instance":
        return InstanceNorm(channels)
    if norm_fn == "none":
        return nn.Sequential()
    raise ValueError(f"unknown norm {norm_fn!r}")


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        if stride != 1:
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride), self.norm3)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """[B, n_first_channels, H, W] → [B, output_dim, H/8, W/8]."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch", n_first_channels: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(n_first_channels, 64, 7, 2, 3)
        self.norm1 = make_norm(norm_fn, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn), ResidualBlock(64, 64, norm_fn))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2), ResidualBlock(96, 96, norm_fn))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2), ResidualBlock(128, 128, norm_fn))
        self.conv2 = nn.Conv2d(128, output_dim, 1)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The reference's init (``model/extractor.py``): He-normal convs
        (fan out), norms at scale 1 and bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)) and m.weight is not None:
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """1×5 then 5×1 separable ConvGRU (reference ``update.py:33-60``)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for convz, convr, convq in (
            (self.convz1, self.convr1, self.convq1),
            (self.convz2, self.convr2, self.convq2),
        ):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1, padding=0)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    """The update block.  ``forward(..., compute_mask=False)`` skips the
    convex-upsample mask head, which ``upsample_mask`` runs on its own: in
    eval mode the refinement loop runs it once, on the final net (the JAX
    ``mask()``; the name ``mask`` is the head's ``Sequential``)."""

    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, input_dim=128 + hidden_dim)
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
        compute_mask: bool = True,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta_flow = self.flow_head(net)
        up_mask = self.upsample_mask(net) if compute_mask else None
        return net, up_mask, delta_flow
