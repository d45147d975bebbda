"""EEMFlow — the paper's efficient meshflow/optical-flow network (counterpart
of ``eemflow_tpu/models/eemflow.py:1-175, 372-437``).

Architecture (reference ``model/EEMFlow/EEMFlow.py:71-183``): a 3-stage
stride-2 conv pyramid (bins→16→32→64, LeakyReLU 0.1); average pooling of
each level to the coarse grid (32/16/8); per level a 53-channel local
correlation (kernel K2 on the card, the three levels in one launch that
reads the pooled NCHW features in place) next to a 16-channel ``rconv``, then a
7-conv grouped, channel-shuffled decoder; a 1×1 fuse of the three flows;
one bilinear upsample (align_corners=False) of the coarse flow of the
padded frame straight to (H, W), without unpadding — as the reference
and the JAX package do.

``forward(ev1, ev2)`` takes NHWC [B, H, W, bins] and returns
``((ev1, ev2), [flow [B, H, W, 2]])`` like the JAX model.  The pyramid
convs sit at the top level under the reference's names (``pconv1_1`` …);
the JAX package nests them under a ``pyramid`` submodule
(``compat.from_jax`` maps between the two).  ``index`` is the reference's
correlation index buffer, kept so a released checkpoint loads strictly;
the displacements computed are ``corr_indices``.

The 49-entry mask committed in the reference (``EEMFlow.py:85-94``) gives
65 decoder inputs against decoders built for 69, so ``INDEX_53``, the
53-entry diamond of EEMFlow+ (``EEMFlow+.py:89-97``), is the default.

Eval-only fused modes (counterpart of ``eemflow_tpu/models/eemflow.py:
184-216, 227-277, 401-413``), same parameters, same float32 math:
``fast_pyramid`` runs each level's stride-1 convs and its pool as one
call of kernel K3 (``kernels/fused_convs.py``; ``fast_pyramid_dtype="bf16"``
rounds the conv operands to bf16), the stride-2 convs stay cuDNN convs;
``fast_head`` runs the whole coarse stage as one call of kernel K4
(``ops/coarse_head.py``; ``fast_head_impl="plain"`` runs its PyTorch twin
instead, the measurement control).  ``train=True`` takes the standard
path; K4's weights are packed detached, so ``fast_head`` refuses to run
under grad while a parameter requires it.  The packed weights are kept on
the model and dropped when it is moved: K3's chains in a ``PackCache``,
repacked when a parameter they were made from changes in place (its
version counter) or is replaced; K4's in one ``HeadWeights``, which
repacks itself after an in-place edit.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.kernels import COMPUTE_DTYPES
from eemflow_tpu_torch.kernels.fused_convs import fused_convs, pack_chain
from eemflow_tpu_torch.models.layers import ConvRelu, channel_shuffle, conv2d
from eemflow_tpu_torch.ops.coarse_head import IMPLS, HeadWeights, coarse_head
from eemflow_tpu_torch.ops.correlation import local_correlation_levels
from eemflow_tpu_torch.ops.pack_cache import PackCache
from eemflow_tpu_torch.ops.pad import InputPadder
from eemflow_tpu_torch.ops.upsample import upsample_flow_to

INDEX_49 = (
    1, 3, 5, 7,
    9, 11, 13, 15, 17,
    19, 21, 22, 23, 25,
    27, 29, 30, 31, 32, 33, 35,
    37, 38, 39, 40, 41, 42, 43,
    45, 47, 48, 49, 50, 51, 53,
    55, 57, 58, 59, 61,
    63, 65, 67, 69, 71,
    73, 75, 77, 79,
)

INDEX_53 = (
    0, 2, 4, 6, 8,
    10, 12, 14, 16,
    18, 20, 21, 22, 23, 24, 26,
    28, 29, 30, 31, 32, 33, 34,
    36, 38, 39, 40, 41, 42, 44,
    46, 47, 48, 49, 50, 51, 52,
    54, 56, 57, 58, 59, 60, 62,
    64, 66, 68, 70,
    72, 74, 76, 78, 80,
)

# avg-pool factor per pyramid level: every level lands on the H/64 × W/64 grid
POOLS = (32, 16, 8)
# the stride-1 convs of each pyramid level (what ``fast_pyramid`` fuses)
LEVEL_CHAINS = (("pconv1_2",), ("pconv2_2", "pconv2_3"), ("pconv3_2", "pconv3_3"))


class Decoder(nn.Module):
    """7-conv flow decoder with grouped convs + channel shuffle
    (reference ``EEMFlow.py:37-69``)."""

    def __init__(self, in_channels: int, groups: int, mid: int = 100):
        super().__init__()
        self.groups = groups
        self.conv1 = ConvRelu(in_channels, mid)
        self.conv2 = ConvRelu(mid, mid, groups=groups)
        self.conv3 = ConvRelu(mid, mid, groups=groups)
        self.conv4 = ConvRelu(mid, mid, groups=groups)
        self.conv5 = ConvRelu(mid, 64)
        self.conv6 = ConvRelu(64, 32)
        self.conv7 = conv2d(32, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        x = self.conv1(x)
        for conv in (self.conv2, self.conv3, self.conv4):
            x = conv(x)
            if g > 1:
                x = channel_shuffle(x, g)
        return self.conv7(self.conv6(self.conv5(x)))


class EEMFlow(nn.Module):
    """Flagship model.  ``siamese_stack``: run both event frames through
    the pyramid and pools as one 2B batch (per-frame results identical;
    fewer, larger launches; the JAX package's ``--fast``).  ``fast_pyramid``
    (which wins over ``siamese_stack``) and ``fast_head``: the eval-only
    fused modes of the module docstring, the port's ``--fast``
    (``models/registry.FAST_EVAL_KWARGS``)."""

    def __init__(
        self,
        groups: int = 5,
        n_first_channels: int = 5,
        out_mesh_size: bool = False,
        corr_indices: Sequence[int] = INDEX_53,
        max_displacement: int = 4,
        pad_rate: int = 64,
        siamese_stack: bool = False,
        fast_pyramid: bool = False,
        fast_pyramid_dtype: str = "float32",
        fast_head: bool = False,
        fast_head_impl: str = "kernel",
    ):
        super().__init__()
        if fast_pyramid_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"fast_pyramid_dtype must be one of {sorted(COMPUTE_DTYPES)}")
        if fast_head_impl not in IMPLS:
            raise ValueError(f"fast_head_impl must be one of {IMPLS}")
        self.groups = groups
        self.out_mesh_size = out_mesh_size
        self.corr_indices = tuple(int(i) for i in corr_indices)
        self.max_displacement = max_displacement
        self.pad_rate = pad_rate
        self.siamese_stack = siamese_stack
        self.fast_pyramid = fast_pyramid
        self.fast_pyramid_dtype = fast_pyramid_dtype
        self.fast_head = fast_head
        self.fast_head_impl = fast_head_impl
        # packed weights of the fused modes, following the parameters
        self._fast_cache = PackCache()

        self.pconv1_1 = ConvRelu(n_first_channels, 16, stride=2)
        self.pconv1_2 = ConvRelu(16, 16)
        self.pconv2_1 = ConvRelu(16, 32, stride=2)
        self.pconv2_2 = ConvRelu(32, 32)
        self.pconv2_3 = ConvRelu(32, 32)
        self.pconv3_1 = ConvRelu(32, 64, stride=2)
        self.pconv3_2 = ConvRelu(64, 64)
        self.pconv3_3 = ConvRelu(64, 64)
        self.register_buffer("index", torch.tensor(self.corr_indices, dtype=torch.long))

        cin = len(self.corr_indices) + 16
        self.rconv_1 = ConvRelu(16, 16)
        self.rconv_2 = ConvRelu(32, 16)
        self.rconv_3 = ConvRelu(64, 16)
        self.decoder_1 = Decoder(cin, groups)
        self.decoder_2 = Decoder(cin, groups)
        self.decoder_3 = Decoder(cin, groups)
        self.out_conv = conv2d(6, 2, kernel_size=1, padding=0)

    def pyramid(self, x: torch.Tensor):
        """Shared 3-stage stride-2 pyramid (reference ``EEMFlow.py:75-82``),
        each level average-pooled to the coarse grid."""
        f1 = self.pconv1_2(self.pconv1_1(x))
        f2 = self.pconv2_3(self.pconv2_2(self.pconv2_1(f1)))
        f3 = self.pconv3_3(self.pconv3_2(self.pconv3_1(f2)))
        return tuple(F.avg_pool2d(f, k) for f, k in zip((f1, f2, f3), POOLS))

    def _apply(self, *args, **kwargs):
        self._fast_cache.clear()
        return super()._apply(*args, **kwargs)

    def _fast_pyramid(self, x: torch.Tensor):
        """Eval pyramid: cuDNN stride-2 convs, and each level's stride-1
        convs + pool as one K3 call, reading the same parameters as
        ``pyramid``.  Only the pooled grids come out: the last level's full
        output feeds nothing."""
        dtype = COMPUTE_DTYPES[self.fast_pyramid_dtype]
        chains = [
            ([getattr(self, n)[0].weight for n in names], [getattr(self, n)[0].bias for n in names])
            for names in LEVEL_CHAINS
        ]
        packs = [None] * len(chains)
        if x.device.type == "cuda":
            packs = self._fast_cache.get(
                ("pyramid", x.device, dtype),
                [t for ws, bs in chains for t in ws + bs],
                lambda: [pack_chain(ws, bs, dtype == torch.bfloat16, x.device) for ws, bs in chains],
            )
        pooled = []
        f = x
        for lvl, (stem, pool) in enumerate(zip((self.pconv1_1, self.pconv2_1, self.pconv3_1), POOLS)):
            f, p = fused_convs(
                stem(f), *chains[lvl], pool=pool, compute_dtype=dtype,
                emit_full=lvl < len(POOLS) - 1, packed=packs[lvl],
            )
            pooled.append(p)
        return tuple(pooled)

    def _head_weights(self) -> HeadWeights:
        # built once per placement: HeadWeights repacks itself after an edit
        return self._fast_cache.get(
            "head", (), lambda: HeadWeights(dict(self.named_parameters()), self.groups)
        )

    def _corrs(self, p1, p2):
        """The levels' NCHW pooled features → their NCHW correlations, all
        three through one call of the NHWC op (counterpart of the JAX
        forward's ``eemflow.py:325-331``): on the card one K2 launch that
        reads the permuted views in place and writes channels-first."""
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        cvs = local_correlation_levels(
            [(nhwc(a), nhwc(b)) for a, b in zip(p1, p2)], self.max_displacement, self.corr_indices
        )
        return [cv.permute(0, 3, 1, 2) for cv in cvs]

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, train: bool = False):
        B, H, W, _ = events1.shape
        out_size = (16, 16) if (train and self.out_mesh_size) else (H, W)

        padder = InputPadder((H, W), mode="chairs", eval_pad_rate=self.pad_rate)
        ev1, ev2 = padder.pad_nchw(
            events1.permute(0, 3, 1, 2).contiguous(),
            events2.permute(0, 3, 1, 2).contiguous(),
        )
        if self.fast_pyramid and not train:
            p1 = self._fast_pyramid(ev1)
            p2 = self._fast_pyramid(ev2)
        elif self.siamese_stack:
            pooled = self.pyramid(torch.cat([ev1, ev2], dim=0))
            p1 = [p[:B] for p in pooled]
            p2 = [p[B:] for p in pooled]
        else:
            p1 = self.pyramid(ev1)
            p2 = self.pyramid(ev2)

        if self.fast_head and not train:
            nhwc = lambda ps: [p.permute(0, 2, 3, 1) for p in ps]
            out = coarse_head(
                nhwc(p1), nhwc(p2), self._head_weights(), self.groups,
                self.corr_indices, self.max_displacement, impl=self.fast_head_impl,
            )
            return (events1, events2), [upsample_flow_to(out, out_size)]

        rconvs = (self.rconv_1, self.rconv_2, self.rconv_3)
        decoders = (self.decoder_1, self.decoder_2, self.decoder_3)
        flows = [
            dec(torch.cat([cv, rconv(a)], dim=1))
            for cv, a, rconv, dec in zip(self._corrs(p1, p2), p1, rconvs, decoders)
        ]
        out = self.out_conv(torch.cat(flows, dim=1))
        flow_up = upsample_flow_to(out.permute(0, 2, 3, 1), out_size)
        return (events1, events2), [flow_up]
