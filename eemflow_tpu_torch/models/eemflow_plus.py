"""EEMFlow+ ("EEMFlow_cdc") — the paper's coarse-to-fine variant with
self-guided, content-aware flow upsampling (counterpart of
``eemflow_tpu/models/eemflow_plus.py``; reference
``model/EEMFlow/EEMFlow+.py:74-234`` + ``model/EEMFlow/cdc_utils.py``).

A six-level pyramid (the three stride-2 conv stages of EEMFlow, then three
average pools by 2); from the coarsest level (1/64) to 1/4: upsample the
previous flow with the SGU (``cdc_model``: warp the guide features,
predict an inter-flow and a blend mask, refine the bilinear-upsampled
flow by backwarp blending), warp the second frame's features
(align_corners=True), a 53-channel local correlation (kernel K2, one
launch a level: five a forward, each level needing the previous one's
flow), and a grouped, channel-shuffled 7-conv decoder residual.  Returns
five predictions (coarse → fine), each upsampled to the input size with
its magnitudes rescaled.

``forward(ev1, ev2)`` takes NHWC [B, H, W, bins] and returns
``((ev1, ev2), [flow [B, H, W, 2] × 5])`` like the JAX model; inside it
runs NCHW.  The modules keep the reference's torch names (``pconv*`` at
the top level, ``conv_1x1.{2..5}``, ``rconv{2..6}``, ``decoder{2..6}``,
``cdc_model.dense_estimator_mask.conv_last.0``), so a released checkpoint
loads strictly once its dead parameters are dropped
(``EEMFLOW_PLUS_DROP``: the deconvs ``up3``–``up6``, ``conv_1x1.0``/``.1``
and the SGU's ``upsample_output_conv``, never called in the forward).
``n_first_channels`` is the input's bins (5 for HREM; the JAX module
infers it).

Eval-only fused modes (JAX ``:196``, ``:239``, ``:292``; same parameters):
``fast_pyramid`` runs each level's stride-1 convs (and level 3's pool) as
one call of K3; ``fast_decoders`` each decoder as one K3 chain, its convs
2-4 grouped and each followed by its channel shuffle (JAX makes them
dense and folds the shuffles into the next conv,
``ops/coarse_head.decoder_dense_kernels``; the port's K3 takes them as
they are); ``fast_sgu`` the SGU's densely connected estimator as one K3
concat chain.  ``fast_dtype="bf16"`` rounds the conv operands to bf16.
Every chain runs on K3's tensor-core kernel; a chain whose buffers do not
fit one launch's shared memory runs one conv a launch
(``kernels.fused_convs.plan_chain``: the SGU and the decoders do).
As in JAX, a level shorter than a chain's halo (6 rows for the SGU, 7 for
a decoder) runs the standard modules: model semantics, not a fallback;
at 720×1280 every level is tall enough.  On the card the fused modes
refuse a parameter that requires grad (``kernels.refuse_grad``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.kernels import COMPUTE_DTYPES
from eemflow_tpu_torch.kernels.fused_convs import fused_convs, pack_chain
from eemflow_tpu_torch.models.eemflow import INDEX_53, Decoder
from eemflow_tpu_torch.models.layers import ConvRelu, conv2d
from eemflow_tpu_torch.ops.correlation import local_correlation_levels
from eemflow_tpu_torch.ops.pack_cache import PackCache
from eemflow_tpu_torch.ops.pad import InputPadder
from eemflow_tpu_torch.ops.upsample import upsample2d_flow_as
from eemflow_tpu_torch.ops.warp import backwarp, backwarp_masked, warp_align_corners

# torch checkpoint keys with no live forward path (see the module docstring)
EEMFLOW_PLUS_DROP = ("up3", "up4", "up5", "up6", "conv_1x1.0", "conv_1x1.1",
                     "cdc_model.upsample_output_conv")
# input channels of the reference's conv_1x1 entries 2..5 (levels 2..5)
CONV1X1_IN = {2: 32, 3: 64, 4: 64, 5: 64}
SGU_HALO = 6  # convs of the SGU's dense estimator
DECODER_HALO = 7  # convs of a decoder


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


class FlowEstimatorDense(nn.Module):
    """Densely connected 5-conv estimator + linear head (reference
    ``cdc_utils.py:109-145``): each conv's output is concatenated in front
    of its input."""

    def __init__(self, ch_in: int = 64, f_channels: Sequence[int] = (32, 32, 32, 16, 8), ch_out: int = 3):
        super().__init__()
        n = ch_in
        for i, f in enumerate(f_channels):
            setattr(self, f"conv{i + 1}", ConvRelu(n, f))
            n += f
        self.n_convs = len(f_channels)
        self.conv_last = nn.Sequential(conv2d(n, ch_out))

    def chain(self):
        """(OIHW weights, biases) of the six convs, in order."""
        convs = [getattr(self, f"conv{i + 1}")[0] for i in range(self.n_convs)] + [self.conv_last[0]]
        return [c.weight for c in convs], [c.bias for c in convs]

    def forward(self, x: torch.Tensor):
        for i in range(self.n_convs):
            x = torch.cat([getattr(self, f"conv{i + 1}")(x), x], dim=1)
        return x, self.conv_last(x)


class CDCModel(nn.Module):
    """The self-guided upsampler, SGU (reference ``cdc_utils.py:105-174``).
    NCHW flow and features.  ``fast``: the dense estimator as one K3 concat
    chain (eval only) where the grid is at least ``SGU_HALO`` rows tall."""

    def __init__(self, fast: bool = False, fast_dtype: str = "float32"):
        super().__init__()
        self.fast = fast
        self.fast_dtype = fast_dtype
        self.dense_estimator_mask = FlowEstimatorDense()
        self._fast_cache = PackCache()

    def _apply(self, *args, **kwargs):
        self._fast_cache.clear()
        return super()._apply(*args, **kwargs)

    def _fast_estimator(self, feat: torch.Tensor):
        if feat.shape[2] < SGU_HALO:
            return None
        ws, bs = self.dense_estimator_mask.chain()
        dtype = COMPUTE_DTYPES[self.fast_dtype]
        n = len(ws)
        relus = (True,) * (n - 1) + (False,)
        concat = (True,) * (n - 1) + (False,)
        packed = None
        if feat.device.type == "cuda":
            packed = self._fast_cache.get(
                ("sgu", feat.device, dtype), ws + bs,
                lambda: pack_chain(ws, bs, dtype == torch.bfloat16, feat.device, concat=concat, relus=relus),
            )
        out, _ = fused_convs(feat.float(), ws, bs, None, dtype, True, relus, concat, packed)
        return out.to(feat.dtype)

    def estimate(self, flow_init, feature_1, feature_2, fused: bool = True):
        """(flow_init at the features' size, the estimator's 3-channel
        output); ``fused=False`` (training) keeps the standard modules."""
        fh, fw = feature_1.shape[2:]
        if tuple(flow_init.shape[2:]) != (fh, fw):
            flow_init = _nchw(upsample2d_flow_as(_nhwc(flow_init), (fh, fw), if_rate=True))
        f2w = _nchw(backwarp_masked(_nhwc(feature_2), _nhwc(flow_init)))
        feat = torch.cat([feature_1, f2w], dim=1)
        x_out = self._fast_estimator(feat) if self.fast and fused else None
        if x_out is None:
            _, x_out = self.dense_estimator_mask(feat)
        return flow_init, x_out

    def forward(self, flow_init, feature_1, feature_2, fused: bool = True):
        flow_init, x_out = self.estimate(flow_init, feature_1, feature_2, fused)
        inter_flow = x_out[:, :2]
        inter_mask = torch.sigmoid(x_out[:, 2:3])
        warped = _nchw(backwarp(_nhwc(flow_init), _nhwc(inter_flow)))
        return warped * (1 - inter_mask) + flow_init * inter_mask


class CFP(nn.Module):
    """Confidence-gated flow propagation (reference ``cdc_utils.py:179-210``):
    ``softmax((proj·C^-0.5) @ projᵀ) @ flow`` over the projected guide
    feature.  The gating mask is commented out upstream, so it is not an
    input here, as in the JAX module."""

    def __init__(self, channels: int = 32):
        super().__init__()
        self.self_corr = nn.Linear(channels, channels)

    def forward(self, feat: torch.Tensor, flow_init: torch.Tensor) -> torch.Tensor:
        B, C, H, W = feat.shape
        proj = self.self_corr(feat.reshape(B, C, H * W).transpose(1, 2))
        attn = torch.softmax((proj * (C ** -0.5)) @ proj.transpose(1, 2), dim=-1)
        flow = flow_init.reshape(B, 2, H * W).transpose(1, 2)
        return (attn @ flow).transpose(1, 2).reshape(B, 2, H, W)


class CDCCFPModel(CDCModel):
    """``cdc_cfp_model`` (reference ``cdc_utils.py:211-288``, dead code
    upstream; ``EEMFlowPlus(cdc_variant="cfp")``): the SGU whose upsample
    blends the inter-flow-warped flow with a CFP-propagated one::

        flow_up = (backwarp(flow, inter_flow) + cfp) · ½ · (1−mask) + flow·mask
    """

    def __init__(self):
        super().__init__()
        self.cfp = CFP()

    def forward(self, flow_init, feature_1, feature_2, fused: bool = True):
        flow_init, x_out = self.estimate(flow_init, feature_1, feature_2, fused)
        inter_flow = x_out[:, :2]
        inter_mask = torch.sigmoid(x_out[:, 2:3])
        flow_add = self.cfp(feature_2, flow_init)
        warped = _nchw(backwarp(_nhwc(flow_init), _nhwc(inter_flow)))
        return (warped + flow_add) * 0.5 * (1 - inter_mask) + flow_init * inter_mask


class EEMFlowPlus(nn.Module):
    """forward(ev1, ev2 [B, H, W, bins]) → ((ev1, ev2), [flow6 … flow2],
    each [B, H, W, 2]).  ``siamese_stack``: both frames through the pyramid
    and each level's 1×1 convs as one 2B batch (per-frame results
    identical).  The fused modes: see the module docstring."""

    def __init__(
        self,
        groups: int = 3,
        n_first_channels: int = 5,
        corr_indices: Sequence[int] = INDEX_53,
        max_displacement: int = 4,
        cdc_variant: str = "sgu",
        pad_rate: int = 64,
        fast_pyramid: bool = False,
        fast_decoders: bool = False,
        fast_sgu: bool = False,
        fast_dtype: str = "float32",
        siamese_stack: bool = False,
    ):
        super().__init__()
        if cdc_variant not in ("sgu", "cfp"):
            raise ValueError("cdc_variant must be 'sgu' or 'cfp'")
        if fast_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"fast_dtype must be one of {sorted(COMPUTE_DTYPES)}")
        if fast_sgu and cdc_variant != "sgu":
            raise ValueError("fast_sgu fuses the sgu variant's estimator only")
        self.groups = groups
        self.corr_indices = tuple(int(i) for i in corr_indices)
        self.max_displacement = max_displacement
        self.pad_rate = pad_rate
        self.fast_pyramid = fast_pyramid
        self.fast_decoders = fast_decoders
        self.fast_dtype = fast_dtype
        self.siamese_stack = siamese_stack
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
        # conv + LeakyReLU(0.1): the reference builds these with cdc_utils.conv,
        # whose isReLU defaults to True (cdc_utils.py:9-30)
        self.conv_1x1 = nn.ModuleDict(
            {str(l): ConvRelu(c, 32, kernel_size=1, padding=0) for l, c in CONV1X1_IN.items()}
        )
        cin = len(self.corr_indices) + 32 + 2
        for l in (2, 3, 4, 5, 6):
            setattr(self, f"rconv{l}", ConvRelu(32 if l == 2 else 64, 32))
            setattr(self, f"decoder{l}", Decoder(cin, groups, mid=96))
        self.cdc_model = (
            CDCModel(fast=fast_sgu, fast_dtype=fast_dtype) if cdc_variant == "sgu" else CDCCFPModel()
        )

    def _apply(self, *args, **kwargs):
        self._fast_cache.clear()
        return super()._apply(*args, **kwargs)

    def _dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.fast_dtype]

    def pyramid(self, x: torch.Tensor):
        """The shared 3-stage stride-2 pyramid (1/2, 1/4, 1/8)."""
        f1 = self.pconv1_2(self.pconv1_1(x))
        f2 = self.pconv2_3(self.pconv2_2(self.pconv2_1(f1)))
        f3 = self.pconv3_3(self.pconv3_2(self.pconv3_1(f2)))
        return f1, f2, f3

    def _chain(self, key, params, make, device, pool=None):
        """(OIHW weights, biases, flags, packed or None) of a fused chain:
        ``make()`` gives the weights, biases and the ``fused_convs`` flags
        (``relus``, ``groups``, ``shuffle``); made once per placement and
        kept while ``params`` are."""
        dtype = self._dtype()

        def build():
            ws, bs, flags = make()
            packed = None
            if device.type == "cuda":
                packed = pack_chain(ws, bs, dtype == torch.bfloat16, device, pool, groups=flags.get("groups"),
                                    shuffle=flags.get("shuffle"), relus=flags.get("relus"))
            return ws, bs, flags, packed

        return self._fast_cache.get((key, device, dtype), params, build)

    def _fast_pyr(self, x: torch.Tensor):
        """Eval pyramid: cuDNN stride-2 convs, each level's stride-1 convs as
        one K3 call; level 3 also emits the first pool (by 2).  Returns the
        1/4 and 1/8 features and the 1/16 pooled ones."""
        dtype = self._dtype()
        out = []
        f = x
        for stem, names, pool in ((self.pconv1_1, ("pconv1_2",), None),
                                  (self.pconv2_1, ("pconv2_2", "pconv2_3"), None),
                                  (self.pconv3_1, ("pconv3_2", "pconv3_3"), 2)):
            ws = [getattr(self, n)[0].weight for n in names]
            bs = [getattr(self, n)[0].bias for n in names]
            ws, bs, _, packed = self._chain(names, ws + bs, lambda ws=ws, bs=bs: (ws, bs, {}), x.device, pool)
            g = stem(f)
            f, pooled = fused_convs(g.float(), ws, bs, pool, dtype, True, packed=packed)
            f = f.to(g.dtype)
            out.append(f)
        return out[1], out[2], pooled.to(x.dtype)

    def _fast_decoder(self, name: str, x: torch.Tensor):
        """The decoder as one K3 chain (convs 2-4 grouped, each followed by
        its shuffle), or None on a grid shorter than its halo (the standard
        module runs there)."""
        if x.shape[2] < DECODER_HALO:
            return None
        dec = getattr(self, name)

        def make():
            convs = [dec.conv1, dec.conv2, dec.conv3, dec.conv4, dec.conv5, dec.conv6]
            ws = [c[0].weight for c in convs] + [dec.conv7.weight]
            bs = [c[0].bias for c in convs] + [dec.conv7.bias]
            g = (1, self.groups, self.groups, self.groups, 1, 1, 1)
            return ws, bs, {"relus": (True,) * 6 + (False,), "groups": g, "shuffle": g}

        ws, bs, flags, packed = self._chain(name, list(dec.parameters()), make, x.device)
        out, _ = fused_convs(x.float(), ws, bs, None, self._dtype(), True, packed=packed, **flags)
        return out.to(x.dtype)

    def _decode(self, name: str, x: torch.Tensor, fast: bool):
        out = self._fast_decoder(name, x) if fast and self.fast_decoders else None
        return getattr(self, name)(x) if out is None else out

    def _corr(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        """NCHW correlation of one level: one K2 launch on the card, which
        writes it channels-first."""
        (cv,) = local_correlation_levels([(_nhwc(f1), _nhwc(f2))], self.max_displacement, self.corr_indices)
        return _nchw(cv)

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, train: bool = False):
        B, H, W, _ = events1.shape
        fast = not train
        padder = InputPadder((H, W), mode="chairs", eval_pad_rate=self.pad_rate)
        im1, im2 = padder.pad_nchw(_nchw(events1).contiguous(), _nchw(events2).contiguous())

        if self.fast_pyramid and fast:
            f12, f13, f14 = self._fast_pyr(im1)
            f22, f23, f24 = self._fast_pyr(im2)
        elif self.siamese_stack:
            _, f2s, f3s = self.pyramid(torch.cat([im1, im2], dim=0))
            f4s = F.avg_pool2d(f3s, 2)
            (f12, f22), (f13, f23), (f14, f24) = (t.split(B) for t in (f2s, f3s, f4s))
        else:
            _, f12, f13 = self.pyramid(im1)
            _, f22, f23 = self.pyramid(im2)
            f14, f24 = F.avg_pool2d(f13, 2), F.avg_pool2d(f23, 2)
        f15, f25 = F.avg_pool2d(f14, 2), F.avg_pool2d(f24, 2)
        f16, f26 = F.avg_pool2d(f15, 2), F.avg_pool2d(f25, 2)

        # level 6, the coarsest
        flow7 = f16.new_zeros((B, 2) + tuple(f16.shape[2:]))
        flow = self._decode("decoder6", torch.cat([self._corr(f16, f26), self.rconv6(f16), flow7], dim=1), fast)
        flows = [flow]
        for l, (f1, f2) in zip((5, 4, 3, 2), ((f15, f25), (f14, f24), (f13, f23), (f12, f22))):
            c1x1 = self.conv_1x1[str(l)]
            if self.siamese_stack:
                g1, g2 = c1x1(torch.cat([f1, f2], dim=0)).split(B)
            else:
                g1, g2 = c1x1(f1), c1x1(f2)
            flow_up = self.cdc_model(flow, g1, g2, fast)
            f2w = _nchw(warp_align_corners(_nhwc(f2), _nhwc(flow_up)))
            x = torch.cat([self._corr(f1, f2w), getattr(self, f"rconv{l}")(f1), flow_up], dim=1)
            flow = self._decode(f"decoder{l}", x, fast) + flow_up
            flows.append(flow)
        preds = [upsample2d_flow_as(_nhwc(f), (H, W), if_rate=True) for f in flows]
        return (events1, events2), preds
