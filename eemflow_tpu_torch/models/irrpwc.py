"""IRR-PWC and the PWC-Net variant family (counterpart of
``eemflow_tpu/models/irrpwc.py:37-559``; reference ``model/IRRPWC/``:
pwcnet_irr.py, pwc_modules.py, irr_modules.py, IRR_PWC.py and the
pwcnet{,_bi,_occ,_occ_bi,_irr_bi,_irr_occ,_irr_occ_bi}.py files).

A 6-level stride-2 conv pyramid (bins→16→32→64→96→128→196, coarse first);
at each of the 5 coarsest levels the second view's features are warped by
the upsampled flow (``ops/warp.pwc_warp``, the flow kept in input pixels ×
``div_flow``), a 9×9 cost volume (mean over C, LeakyReLU 0.1) is taken —
kernel K2 on the card (``ops/correlation.local_correlation_levels``, one
launch a direction and level, reading the NCHW features through NHWC
views), its plain version on the CPU — and a densely connected estimator
(+448 channels through its five convs) and a dilated context network
refine the flow.  Every prediction is upsampled to the input size
(align_corners=True) and divided by ``div_flow``.

  * ``PWCNet`` (``irrpwc``): iterative residual — ONE estimator, ONE
    context network and per-level 1×1 reducers (196/128/96/64/32 → 32),
    the flow rescaled to the level's local units around them
    (``rescale_flow``: W/width_im, not the warp's (W−1)/(width_im−1));
  * ``PWCFamilyNet`` (``pwcnet*``): ``irr`` as above, or one estimator a
    level that *replaces* the flow and a context network at the output
    level only; ``bi`` a backward direction through the same estimators;
    ``occ`` mirrored occlusion estimators (the non-irr ``occ_bi`` feeds x1
    to its backward occlusion arm, the reference's quirk);
  * ``IRRPWCOcc`` (``irrpwc_occ``): both directions, flow and occlusion,
    kernel-prediction refinement (``RefineFlow``/``RefineOcc``) on warped
    differences at every level, then the occlusion maps shuffle-upsampled
    (``OccUpsampleNetwork``) through the two finest levels, with a 1×1
    reducer a level (``conv_1x1_fine_{i}``: the JAX package's documented
    deviation from the reference, whose shared reducer cannot take both
    widths).

The refinement's 3×3 kernels: a softmax of −feat² over 9 taps kept on the
last axis (the taps of a pixel adjacent in memory), each target channel's
replicate-padded 3×3 neighbourhood (dy-major) weighed by them.
``RefineFlow``'s ‖diff‖₂ is ``torch.linalg.vector_norm``, whose gradient
at a zero vector is 0 (the reference's ``torch.norm``'s too); JAX's
``jnp.linalg.norm`` gives NaN there, so JAX cannot train ``irrpwc_occ`` on
event grids that are zero at most pixels — a deliberate difference.

Attribute names are the reference's (``feature_pyramid_extractor.convs.
L.S.0``, ``flow_estimators.convN.0`` / ``conv_last.0`` —
``flow_estimators.L.`` when not ``irr`` —, ``context_networks.convs.i.0``,
``conv_1x1.L.0``), so a released checkpoint loads with a strict
``load_state_dict``.  ``forward(ev1, ev2, train=False)`` takes NHWC
[B, H, W, bins] and returns ``(maps, preds)``: ``preds`` the forward flows
[B, H, W, 2] coarse → fine; ``maps`` the occlusion logits [B, H, W, 1]
(``(occ_f, occ_b | None)``) when the model has them, else the inputs.
Under mixed precision every activation keeps the parameters' dtype; the
warps' coordinates are float32 and the bilinear resizes interpolate in
float32 (``ops/upsample.resize_bilinear``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.models.layers import ConvRelu, conv2d, leaky_relu01
from eemflow_tpu_torch.ops.correlation import local_correlation_levels
from eemflow_tpu_torch.ops.upsample import resize_bilinear
from eemflow_tpu_torch.ops.warp import pwc_warp

SEARCH_RANGE = 4
DIM_CORR = (2 * SEARCH_RANGE + 1) ** 2  # 81
DENSE = 448  # channels the dense estimator's five convs add: 128+128+96+64+32
PYRAMID = (16, 32, 64, 96, 128, 196)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def upsample_as(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize (align_corners=True) of an NCHW tensor to ``size``."""
    return nchw(resize_bilinear(nhwc(x), tuple(size), align_corners=True))


def warp(x: torch.Tensor, flow: torch.Tensor, height_im: int, width_im: int, div_flow: float) -> torch.Tensor:
    """``pwc_warp`` of NCHW ``x`` by NCHW ``flow``."""
    return nchw(pwc_warp(nhwc(x), nhwc(flow), height_im, width_im, div_flow))


def cost_volume(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The 9×9 mean cost volume of NCHW features, LeakyReLU'd, NCHW
    [B, 81, H, W]: one K2 launch on the card (its output channels-first)."""
    corr = local_correlation_levels([(nhwc(x1), nhwc(x2))], SEARCH_RANGE)[0]
    return leaky_relu01(nchw(corr))


_SCALES: dict = {}


def _scale2(flow: torch.Tensor, su: float, sv: float) -> torch.Tensor:
    """``flow`` [B, 2, H, W] times (su, sv) per channel, the pair a constant
    in the flow's dtype made once (as JAX rounds it to the flow's dtype)."""
    key = (su, sv, flow.dtype, flow.device)
    scale = _SCALES.get(key)
    if scale is None:
        with torch.inference_mode(False):  # a normal tensor, which training may save
            scale = _SCALES[key] = torch.tensor([su, sv], dtype=flow.dtype, device=flow.device).view(1, 2, 1, 1)
    return flow * scale


def rescale_flow(flow: torch.Tensor, div_flow: float, width_im: int, height_im: int, to_local: bool = True):
    """Reference ``pwc_modules.py:151-155``: a flow in input pixels ×
    ``div_flow`` to the level's own pixels (W/width_im/div_flow), or back."""
    H, W = flow.shape[2:]
    if to_local:
        return _scale2(flow, W / width_im / div_flow, H / height_im / div_flow)
    return _scale2(flow, width_im * div_flow / W, height_im * div_flow / H)


class FeatureExtractor(nn.Module):
    """Stride-2 conv pyramid, returned coarsest first (reference
    ``pwc_modules.py:88-107``)."""

    def __init__(self, num_chs: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Sequential(ConvRelu(ci, co, stride=2), ConvRelu(co, co)) for ci, co in zip(num_chs[:-1], num_chs[1:])
        )

    def forward(self, x: torch.Tensor):
        pyramid = []
        for conv in self.convs:
            x = conv(x)
            pyramid.append(x)
        return pyramid[::-1]


class FlowEstimatorDense(nn.Module):
    """Densely connected estimator (reference ``pwc_modules.py:157-175``;
    ``out_ch=1`` is its ``OccEstimatorDense``): returns (the last dense
    features, ``ch_in`` + 448 wide; the estimate)."""

    def __init__(self, ch_in: int, out_ch: int = 2):
        super().__init__()
        c = ch_in
        for i, f in enumerate((128, 128, 96, 64, 32)):
            setattr(self, f"conv{i + 1}", ConvRelu(c, f))
            c += f
        self.conv_last = nn.Sequential(conv2d(c, out_ch))

    def forward(self, x: torch.Tensor):
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5):
            x = torch.cat([conv(x), x], dim=1)
        return x, self.conv_last(x)


class ContextNetwork(nn.Module):
    """Dilated refinement, dilations 1, 2, 4, 8, 16, 1 (reference
    ``pwc_modules.py:212-228``)."""

    def __init__(self, ch_in: int, out_ch: int = 2):
        super().__init__()
        mods, c = [], ch_in
        for f, d in ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1)):
            mods.append(ConvRelu(c, f, dilation=d))
            c = f
        mods.append(nn.Sequential(conv2d(c, out_ch)))
        self.convs = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """NCHW [B, C, H, W] → [B, C, H, W, 9]: each pixel's replicate-padded
    3×3 neighbourhood, dy-major (torch ``ReplicationPad2d`` + ``Unfold``,
    reference ``irr_modules.py:70-103``)."""
    H, W = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    return torch.stack([xp[:, :, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)], dim=-1)


class RefineKernel(nn.Module):
    """The core of ``RefineFlow``/``RefineOcc`` (reference
    ``irr_modules.py:64-137``): a conv stack predicts 9 logits a pixel;
    each output channel is the softmax(−feat²)-weighted 3×3 neighbourhood
    of the target's channel."""

    def __init__(self, ch_in: int):
        super().__init__()
        mods, c = [], ch_in
        for f in (128, 128, 64, 64, 32, 32):
            mods.append(ConvRelu(c, f))
            c = f
        mods.append(nn.Sequential(conv2d(c, 9)))
        self.convs = nn.Sequential(*mods)

    def forward(self, target: torch.Tensor, feat_in: torch.Tensor) -> torch.Tensor:
        feat = nhwc(self.convs(feat_in)).contiguous()  # the 9 taps on the last axis
        kernel = torch.softmax(-(feat * feat), dim=-1)
        return (unfold3x3(target) * kernel[:, None]).sum(-1)


class RefineFlow(nn.Module):
    """Kernel refinement of a flow: feat = [flow − mean(flow), ‖diff‖₂,
    feature] (reference ``irr_modules.py:64-103``)."""

    def __init__(self, feat_ch: int):
        super().__init__()
        self.kernel = RefineKernel(2 + 1 + feat_ch)

    def forward(self, flow, diff_img, feature):
        flow_m = flow - flow.mean(dim=(2, 3), keepdim=True)
        norm2 = torch.linalg.vector_norm(diff_img, dim=1, keepdim=True)
        return self.kernel(flow, torch.cat([flow_m, norm2, feature], dim=1))


class RefineOcc(nn.Module):
    """Kernel refinement of an occlusion map: feat = [occ, feat1, feat2]
    (reference ``irr_modules.py:106-137``)."""

    def __init__(self, feat_ch: int):
        super().__init__()
        self.kernel = RefineKernel(1 + 2 * feat_ch)

    def forward(self, occ, feat1, feat2):
        return self.kernel(occ, torch.cat([occ, feat1, feat2], dim=1))


class OccUpsampleNetwork(nn.Module):
    """Occlusion shuffle-upsample (reference ``irr_modules.py:30-57``):
    nearest ×2 (then bilinear, align_corners=False, to the guide's size
    when that is not exactly twice), a conv, three residual blocks scaled
    by 0.1 with shared weights, an end conv added back, and an output conv
    (LeakyReLU'd) added to the upsampled map."""

    def __init__(self, ch_in: int, feat_dim: int = 32):
        super().__init__()
        self.init_conv = ConvRelu(1 + ch_in, feat_dim)
        self.res_convs = nn.Sequential(ConvRelu(feat_dim, feat_dim), nn.Sequential(conv2d(feat_dim, feat_dim)))
        self.res_end_conv = ConvRelu(feat_dim, feat_dim)
        self.out_convs = ConvRelu(feat_dim, 1)

    def forward(self, occ: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        occ = occ.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        if occ.shape[2:] != x.shape[2:]:
            occ = nchw(resize_bilinear(nhwc(occ), tuple(x.shape[2:]), align_corners=False))
        h = self.init_conv(torch.cat([occ, x], dim=1))
        r = h
        for _ in range(3):
            r = r + self.res_convs(r) * 0.1
        h = h + self.res_end_conv(r)
        return self.out_convs(h) + occ


def _full_res(flow: torch.Tensor, H: int, W: int, div_flow: float) -> torch.Tensor:
    """A level's flow → the NHWC prediction at the input size, ÷div_flow."""
    return resize_bilinear(nhwc(flow), (H, W), align_corners=True) * (1.0 / div_flow)


class PWCNet(nn.Module):
    """IRR-PWC (reference ``pwcnet_irr.py``), the ``irrpwc`` registry name."""

    def __init__(self, n_first_channels: int = 5, div_flow: float = 0.05, output_level: int = 4):
        super().__init__()
        self.div_flow = div_flow
        self.output_level = output_level
        self.feature_pyramid_extractor = FeatureExtractor((n_first_channels,) + PYRAMID)
        self.flow_estimators = FlowEstimatorDense(DIM_CORR + 32 + 2)
        self.context_networks = ContextNetwork(DIM_CORR + 32 + 2 + DENSE + 2)
        self.conv_1x1 = nn.ModuleList(ConvRelu(c, 32, kernel_size=1, padding=0) for c in PYRAMID[::-1][:5])

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, train: bool = False):
        B, H, W, _ = events1.shape
        x1_pyr = self.feature_pyramid_extractor(nchw(events1))
        x2_pyr = self.feature_pyramid_extractor(nchw(events2))
        div = self.div_flow
        flow = x1_pyr[0].new_zeros((B, 2) + tuple(x1_pyr[0].shape[2:]))
        preds = []
        for l, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            if l == 0:
                x2_warp = x2
            else:
                flow = upsample_as(flow, x1.shape[2:])
                x2_warp = warp(x2, flow, H, W, div)
            corr = cost_volume(x1, x2_warp)
            flow = rescale_flow(flow, div, W, H, to_local=True)
            x_intm, flow_res = self.flow_estimators(torch.cat([corr, self.conv_1x1[l](x1), flow], dim=1))
            flow = flow + flow_res
            flow = flow + self.context_networks(torch.cat([x_intm, flow], dim=1))
            flow = rescale_flow(flow, div, W, H, to_local=False)
            preds.append(_full_res(flow, H, W, div))
            if l == self.output_level:
                break
        return (events1, events2), preds


class IRRPWCOcc(nn.Module):
    """IRR-PWC with both directions, occlusion and kernel refinement
    (reference ``IRR_PWC.py:14-198``), the ``irrpwc_occ`` registry name.

    ``maps`` = (occ_f, occ_b) at the finest level (after the occlusion
    upsampling), ``preds`` = the forward flows, one a level (7)."""

    def __init__(self, n_first_channels: int = 5, div_flow: float = 0.05, output_level: int = 4):
        super().__init__()
        self.div_flow = div_flow
        self.output_level = output_level
        num_chs = (n_first_channels,) + PYRAMID
        self.feature_pyramid_extractor = FeatureExtractor(num_chs)
        self.flow_estimators = FlowEstimatorDense(DIM_CORR + 32 + 2, 2)
        self.context_networks = ContextNetwork(DIM_CORR + 32 + 2 + DENSE + 2, 2)
        self.occ_estimators = FlowEstimatorDense(DIM_CORR + 32 + 1, 1)
        self.occ_context_networks = ContextNetwork(DIM_CORR + 32 + 1 + DENSE + 1, 1)
        self.occ_shuffle_upsample = OccUpsampleNetwork(3 + 3 + 2 + 2)
        self.refine_flow = RefineFlow(32)
        self.refine_occ = RefineOcc(32)
        # levels 0..3 reduce to 32 channels; level 4's features are 32 wide
        self.conv_1x1 = nn.ModuleList(ConvRelu(c, 32, kernel_size=1, padding=0) for c in PYRAMID[::-1][:4])
        # one reducer a level past the output level: the pyramid's finer
        # conv levels, then the raw input
        fine = list(num_chs[::-1][output_level + 1:])
        for i, c in enumerate(fine):
            setattr(self, f"conv_1x1_fine_{i}", ConvRelu(c, 3, kernel_size=1, padding=0))
        self.n_fine = len(fine)

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, train: bool = False):
        B, H, W, _ = events1.shape
        div = self.div_flow
        ev1, ev2 = nchw(events1), nchw(events2)
        x1_pyr = self.feature_pyramid_extractor(ev1) + [ev1]
        x2_pyr = self.feature_pyramid_extractor(ev2) + [ev2]
        h0, w0 = x1_pyr[0].shape[2:]
        flow_f = ev1.new_zeros((B, 2, h0, w0))
        flow_b = torch.zeros_like(flow_f)
        occ_f = ev1.new_zeros((B, 1, h0, w0))
        occ_b = torch.zeros_like(occ_f)
        preds = []
        for l, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            size = x1.shape[2:]
            if l <= self.output_level:
                if l > 0:
                    flow_f, flow_b = upsample_as(flow_f, size), upsample_as(flow_b, size)
                    occ_f, occ_b = upsample_as(occ_f, size), upsample_as(occ_b, size)
                    x2_warp, x1_warp = warp(x2, flow_f, H, W, div), warp(x1, flow_b, H, W, div)
                else:
                    x2_warp, x1_warp = x2, x1
                corr_f, corr_b = cost_volume(x1, x2_warp), cost_volume(x2, x1_warp)
                if l < len(self.conv_1x1):
                    x1_1, x2_1 = self.conv_1x1[l](x1), self.conv_1x1[l](x2)
                else:
                    x1_1, x2_1 = x1, x2
                flow_f = rescale_flow(flow_f, div, W, H, to_local=True)
                flow_b = rescale_flow(flow_b, div, W, H, to_local=True)

                def arm(est, ctx, corr, feat, prev):
                    x_intm, res = est(torch.cat([corr, feat, prev], dim=1))
                    new = prev + res
                    return new + ctx(torch.cat([x_intm, new], dim=1))

                flow_cont_f = arm(self.flow_estimators, self.context_networks, corr_f, x1_1, flow_f)
                flow_cont_b = arm(self.flow_estimators, self.context_networks, corr_b, x2_1, flow_b)
                occ_cont_f = arm(self.occ_estimators, self.occ_context_networks, corr_f, x1_1, occ_f)
                occ_cont_b = arm(self.occ_estimators, self.occ_context_networks, corr_b, x2_1, occ_b)

                # kernel refinement on warped-image differences
                img1_r, img2_r = upsample_as(ev1, size), upsample_as(ev2, size)
                img2_warp = warp(img2_r, rescale_flow(flow_cont_f, div, W, H, False), H, W, div)
                img1_warp = warp(img1_r, rescale_flow(flow_cont_b, div, W, H, False), H, W, div)
                flow_f = self.refine_flow(flow_cont_f.detach(), img1_r - img2_warp, x1_1)
                flow_b = self.refine_flow(flow_cont_b.detach(), img2_r - img1_warp, x2_1)
                flow_f = rescale_flow(flow_f, div, W, H, to_local=False)
                flow_b = rescale_flow(flow_b, div, W, H, to_local=False)

                x2_1_warp, x1_1_warp = warp(x2_1, flow_f, H, W, div), warp(x1_1, flow_b, H, W, div)
                occ_f = self.refine_occ(occ_cont_f.detach(), x1_1, x1_1 - x2_1_warp)
                occ_b = self.refine_occ(occ_cont_b.detach(), x2_1, x2_1 - x1_1_warp)
                preds.append(_full_res(flow_f, H, W, div))
            else:
                flow_f, flow_b = upsample_as(flow_f, size), upsample_as(flow_b, size)
                preds.append(_full_res(flow_f, H, W, div))
                x2_warp, x1_warp = warp(x2, flow_f, H, W, div), warp(x1, flow_b, H, W, div)
                flow_b_warp, flow_f_warp = warp(flow_b, flow_f, H, W, div), warp(flow_f, flow_b, H, W, div)
                reducer = getattr(self, f"conv_1x1_fine_{l - self.output_level - 1}")
                x1_in, x2_in = reducer(x1), reducer(x2)
                x1_w_in, x2_w_in = reducer(x1_warp), reducer(x2_warp)
                occ_f = self.occ_shuffle_upsample(occ_f, torch.cat([x1_in, x2_w_in, flow_f, flow_b_warp], dim=1))
                occ_b = self.occ_shuffle_upsample(occ_b, torch.cat([x2_in, x1_w_in, flow_b, flow_f_warp], dim=1))
        return (nhwc(occ_f), nhwc(occ_b)), preds


class PWCFamilyNet(nn.Module):
    """The PWC variant family in one module (reference
    ``model/IRRPWC/pwcnet*.py``); the flags as the JAX ``PWCFamilyNet``'s:

      * ``irr=False``: an estimator a level (level 0 sees the bare cost
        volume, deeper levels cost volume + features + flow), each
        *replacing* the flow, the context network at the output level only,
        the flow passed between levels un-rescaled (``pwcnet.py``);
      * ``irr=True``: one shared estimator and context network, per-level
        1×1 reducers, ``rescale_flow`` around them, residual updates
        (``pwcnet_irr_*.py``);
      * ``bi``: a backward direction through the same estimators;
      * ``occ``: mirrored occlusion estimators (``out_ch=1``).

    ``maps`` = (occ_f, occ_b | None) at the input size when ``occ``, else
    the inputs; ``preds`` = the forward flows, one a level (5)."""

    def __init__(self, n_first_channels: int = 5, div_flow: float = 0.05, output_level: int = 4,
                 irr: bool = False, bi: bool = False, occ: bool = False):
        super().__init__()
        self.div_flow, self.output_level = div_flow, output_level
        self.irr, self.bi, self.occ = irr, bi, occ
        self.feature_pyramid_extractor = FeatureExtractor((n_first_channels,) + PYRAMID)
        n_lv = output_level + 1
        chs = PYRAMID[::-1]
        if irr:
            self.flow_estimators = FlowEstimatorDense(DIM_CORR + 32 + 2, 2)
            self.context_networks = ContextNetwork(DIM_CORR + 32 + 2 + DENSE + 2, 2)
            self.conv_1x1 = nn.ModuleList(ConvRelu(c, 32, kernel_size=1, padding=0) for c in chs[:n_lv])
            if occ:
                self.occ_estimators = FlowEstimatorDense(DIM_CORR + 32 + 1, 1)
                self.occ_context_networks = ContextNetwork(DIM_CORR + 32 + 1 + DENSE + 1, 1)
        else:
            def ch_in(l, out_ch):
                return DIM_CORR if l == 0 else DIM_CORR + chs[l] + out_ch

            self.flow_estimators = nn.ModuleList(FlowEstimatorDense(ch_in(l, 2), 2) for l in range(n_lv))
            self.context_networks = ContextNetwork(ch_in(n_lv - 1, 2) + DENSE + 2, 2)
            if occ:
                self.occ_estimators = nn.ModuleList(FlowEstimatorDense(ch_in(l, 1), 1) for l in range(n_lv))
                self.context_networks_occ = ContextNetwork(ch_in(n_lv - 1, 1) + DENSE + 1, 1)

    def _modules_at(self, l: int):
        """(flow estimator, flow context | None, occ estimator, occ context
        | None) of level ``l``."""
        last = l == self.output_level
        if self.irr:
            return (self.flow_estimators, self.context_networks,
                    getattr(self, "occ_estimators", None), getattr(self, "occ_context_networks", None))
        return (self.flow_estimators[l], self.context_networks if last else None,
                self.occ_estimators[l] if self.occ else None,
                self.context_networks_occ if self.occ and last else None)

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, train: bool = False):
        B, H, W, _ = events1.shape
        div = self.div_flow
        x1_pyr = self.feature_pyramid_extractor(nchw(events1))
        x2_pyr = self.feature_pyramid_extractor(nchw(events2))
        h0, w0 = x1_pyr[0].shape[2:]
        flow_f = x1_pyr[0].new_zeros((B, 2, h0, w0))
        flow_b = torch.zeros_like(flow_f)
        occ_f = x1_pyr[0].new_zeros((B, 1, h0, w0))
        occ_b = torch.zeros_like(occ_f)
        preds = []
        for l, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            if l == 0:
                x2_warp, x1_warp = x2, x1
            else:
                flow_f = upsample_as(flow_f, x1.shape[2:])
                x2_warp = warp(x2, flow_f, H, W, div)
                if self.occ:
                    occ_f = upsample_as(occ_f, x1.shape[2:])
                if self.bi:
                    flow_b = upsample_as(flow_b, x2.shape[2:])
                    x1_warp = warp(x1, flow_b, H, W, div)
                    if self.occ:
                        occ_b = upsample_as(occ_b, x2.shape[2:])
            corr_f = cost_volume(x1, x2_warp)
            corr_b = cost_volume(x2, x1_warp) if self.bi else None
            if self.irr:
                flow_f = rescale_flow(flow_f, div, W, H, to_local=True)
                x1_in = self.conv_1x1[l](x1)
                if self.bi:
                    flow_b = rescale_flow(flow_b, div, W, H, to_local=True)
                    x2_in = self.conv_1x1[l](x2)
            else:
                x1_in, x2_in = x1, x2
            use_feat = self.irr or l > 0

            def arm(est, ctx, corr, feat, prev):
                x_intm, out = est(torch.cat([corr, feat, prev], dim=1) if use_feat else corr)
                # only the irr variants are residual; the others replace
                # the field with the estimator's output
                new = prev + out if self.irr else out
                if ctx is not None:
                    new = new + ctx(torch.cat([x_intm, new], dim=1))
                return new

            est, ctx, occ_est, occ_ctx = self._modules_at(l)
            flow_f = arm(est, ctx, corr_f, x1_in, flow_f)
            if self.bi:
                flow_b = arm(est, ctx, corr_b, x2_in, flow_b)
            if self.occ:
                occ_f = arm(occ_est, occ_ctx, corr_f, x1_in, occ_f)
                if self.bi:
                    # the non-irr occ_bi variant feeds x1 to the backward
                    # occlusion arm (reference pwcnet_occ_bi.py:103)
                    occ_b = arm(occ_est, occ_ctx, corr_b, x2_in if self.irr else x1_in, occ_b)
            if self.irr:
                flow_f = rescale_flow(flow_f, div, W, H, to_local=False)
                if self.bi:
                    flow_b = rescale_flow(flow_b, div, W, H, to_local=False)
            preds.append(_full_res(flow_f, H, W, div))
            if l == self.output_level:
                break
        if self.occ:
            maps = (resize_bilinear(nhwc(occ_f), (H, W), align_corners=True),
                    resize_bilinear(nhwc(occ_b), (H, W), align_corners=True) if self.bi else None)
        else:
            maps = (events1, events2)
        return maps, preds
