"""Shared NN building blocks (counterpart of ``eemflow_tpu/models/layers.py:25-132``).

NCHW ``nn.Module``s named as the reference names them: a conv+LeakyReLU
block is ``nn.Sequential(conv, LeakyReLU)``, so its conv's parameters are
``<name>.0.weight`` / ``<name>.0.bias`` — the keys of a released
``.pth.tar`` and, after the ``kernel`` → ``weight`` rewrite, of the JAX
param tree.  Padding is torch's symmetric ``(k−1)·d/2``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def leaky_relu01(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def conv2d(
    in_channels: int,
    features: int,
    kernel_size: int = 3,
    stride: int = 1,
    padding: Optional[int] = None,
    dilation: int = 1,
    groups: int = 1,
    bias: bool = True,
) -> nn.Conv2d:
    """torch Conv2d with the JAX package's default (symmetric) padding."""
    if padding is None:
        padding = ((kernel_size - 1) * dilation) // 2
    return nn.Conv2d(
        in_channels, features, kernel_size, stride, padding,
        dilation=dilation, groups=groups, bias=bias,
    )


class ConvRelu(nn.Sequential):
    """conv + LeakyReLU(0.1) — reference ``EEMFlow.py:26-30`` convrelu."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = None,
        dilation: int = 1,
        groups: int = 1,
    ):
        super().__init__(
            conv2d(in_channels, features, kernel_size, stride, padding, dilation, groups),
            nn.LeakyReLU(0.1),
        )


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet channel shuffle of an NCHW tensor (reference
    ``EEMFlow.py:51-57``): the same channel permutation as the JAX
    package's NHWC ``reshape(.., g, C/g) → swap`` form."""
    B, C, H, W = x.shape
    return x.view(B, groups, C // groups, H, W).transpose(1, 2).reshape(B, C, H, W)


class InstanceNorm(nn.InstanceNorm2d):
    """torch ``InstanceNorm2d`` with its defaults — no affine, eps 1e-5, the
    biased variance over H, W per sample and channel, no running stats —
    which is what the JAX ``InstanceNorm`` (``layers.py:123-132``) rebuilt."""

    def __init__(self, channels: int):
        super().__init__(channels)
