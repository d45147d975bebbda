"""The FlowNet1S family and IRR-FlowNet (counterpart of
``eemflow_tpu/models/flownet1s.py``; reference ``model/IRRPWC/
flownet1s*.py``, ``IRR_FlowNet.py`` and ``flownet_modules.py``).

  * ``FlowNet1S(irr=False)`` (``flownet1s``): FlowNetS on the channel
    concatenation of both views — a 64/128/256 stride-2 stem (7×7, 5×5,
    5×5), the encoder tail to 1/64 (``conv6`` 1024 wide) and a decoder of
    transposed convs (``layers.Deconv``, k=4 s=2 p=1) predicting at 1/64 …
    1/4; five predictions, coarse → fine;
  * ``FlowNet1S(irr=True)`` (``flownet1s_irr``, ``_bi``, ``_occ``,
    ``_occ_bi``): a shared 32/64/128 stem a view, the encoder tail and
    decoder applied ``num_iters`` times to [conv3 of view 1, conv3 of view
    2 warped by the accumulated finest flow] (``ops/warp.flownet_warp``,
    which scales by (W−1)/(width_im·div_flow) and has no mask), each
    iteration's decoder outputs added to the last; ``bi`` a backward
    direction through the same core, ``occ`` a mirrored occlusion decoder;
    one prediction an iteration;
  * ``IRRFlowNet`` (``irr_flownet``): the irr+bi+occ loop plus, each
    iteration, ``RefineFlow``/``RefineOcc`` (``models/irrpwc.py``) on
    warped-image differences at conv2's resolution, residual on the last
    iteration's refined estimate, and the occlusion maps shuffle-upsampled
    to the input size (``OccUpsampleNetwork``).

``_cat_as`` concatenates each decoder stage to the encoder feature's size:
adaptive average pooling where the reference's *lexicographic* list
comparison ``[h, w] < [th, tw]`` says the target is smaller, bilinear
(align_corners=True) otherwise.  There is no correlation, so on the card
this line reaches kernel K1 only (``--device_voxelize``).

Attribute names are the reference's (the inverse of the JAX
``flownet1s_alias``): ``_flownets._conv3_1.0``, ``_flownets._deconv5.0``,
``_flownets._predict_flow6``, ``_flownets._upsample_flow6_to_5`` and their
``_occ`` twins; the stem sits inside ``_flownets`` in the plain net and at
the top level (``_conv1.0`` …) in the irr nets.  ``forward(ev1, ev2,
train=False)`` takes NHWC [B, H, W, bins] and returns ``(maps, preds)``:
``preds`` NHWC [B, H, W, 2] at the input size ÷``div_flow``; ``maps`` the
occlusion logits [B, H, W, 1] (``(occ_f, occ_b | None)``) when the net has
them, else the inputs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.models.irrpwc import OccUpsampleNetwork, RefineFlow, RefineOcc, nchw, nhwc, upsample_as
from eemflow_tpu_torch.models.layers import Deconv, conv2d
from eemflow_tpu_torch.ops.upsample import resize_bilinear
from eemflow_tpu_torch.ops.warp import flownet_warp


def conv_relu(cin: int, cout: int, k: int, s: int) -> nn.Sequential:
    """conv + LeakyReLU(0.1) (the conv is index '0')."""
    return nn.Sequential(conv2d(cin, cout, k, s), nn.LeakyReLU(0.1))


def deconv_relu(cin: int, cout: int) -> nn.Sequential:
    """The reference's ``deconv(nonlinear=True)``: a bias-free transposed
    conv + LeakyReLU(0.1)."""
    return nn.Sequential(Deconv(cin, cout, bias=False), nn.LeakyReLU(0.1))


def warp(x: torch.Tensor, flow: torch.Tensor, height_im: int, width_im: int, div_flow: float) -> torch.Tensor:
    """``flownet_warp`` of NCHW ``x`` by NCHW ``flow``."""
    return nchw(flownet_warp(nhwc(x), nhwc(flow), height_im, width_im, div_flow))


def _cat_as(tensors, ref: torch.Tensor) -> torch.Tensor:
    """``concatenate_as`` (reference ``flownet_modules.py:35-55``): each
    tensor to ``ref``'s size — adaptive average pooling when ``[h, w] <
    [th, tw]`` compares lexicographically, else bilinear (align_corners=
    True) — then concatenated on channels."""
    h, w = ref.shape[2:]
    outs = []
    for t in tensors:
        th, tw = t.shape[2:]
        if (th, tw) == (h, w):
            outs.append(t)
        elif [h, w] < [th, tw]:
            outs.append(F.adaptive_avg_pool2d(t, (h, w)))
        else:
            outs.append(upsample_as(t, (h, w)))
    return torch.cat(outs, dim=1)


class _FlowNetSCore(nn.Module):
    """The encoder tail (conv3_1 … conv6_1) and the flow decoder, with the
    occlusion decoder when ``occ``, and the plain net's stem when
    ``stem_in`` (its input channels) is given.  ``c2_ch`` is the width of
    the conv2 features the last decoder stage concatenates."""

    def __init__(self, c2_ch: int, occ: bool = False, stem_in: int = 0):
        super().__init__()
        self.occ = occ
        if stem_in:
            self._conv1 = conv_relu(stem_in, 64, 7, 2)
            self._conv2 = conv_relu(64, 128, 5, 2)
            self._conv3 = conv_relu(128, 256, 5, 2)
        self._conv3_1 = conv_relu(256, 256, 3, 1)
        self._conv4 = conv_relu(256, 512, 3, 2)
        self._conv4_1 = conv_relu(512, 512, 3, 1)
        self._conv5 = conv_relu(512, 512, 3, 2)
        self._conv5_1 = conv_relu(512, 512, 3, 1)
        self._conv6 = conv_relu(512, 1024, 3, 2)
        self._conv6_1 = conv_relu(1024, 1024, 3, 1)
        for tag, oc in (("flow", 2),) + ((("occ", 1),) if occ else ()):
            mid = "" if tag == "flow" else "_occ"
            # a decoder stage's input: the encoder feature, the deconv, the
            # upsampled prediction
            cat5, cat4, cat3 = 512 + 512 + oc, 512 + 256 + oc, 256 + 128 + oc
            cat2 = c2_ch + 64 + oc
            for n, cin in ((6, 1024), (5, cat5), (4, cat4), (3, cat3), (2, cat2)):
                setattr(self, f"_predict_{tag}{n}", conv2d(cin, oc))
                if n > 2:
                    setattr(self, f"_upsample_{tag}{n}_to_{n - 1}", Deconv(oc, oc, bias=False))
            for n, cin, cout in ((5, 1024, 512), (4, cat5, 256), (3, cat4, 128), (2, cat3, 64)):
                setattr(self, f"_deconv{mid}{n}", deconv_relu(cin, cout))

    def _decode(self, tag: str, conv2, conv3_1, conv4_1, conv5_1, conv6_1):
        mid = "" if tag == "flow" else "_occ"
        m = lambda name: getattr(self, name)  # noqa: E731
        p6 = m(f"_predict_{tag}6")(conv6_1)
        c5 = _cat_as((conv5_1, m(f"_deconv{mid}5")(conv6_1), m(f"_upsample_{tag}6_to_5")(p6)), conv5_1)
        p5 = m(f"_predict_{tag}5")(c5)
        c4 = _cat_as((conv4_1, m(f"_deconv{mid}4")(c5), m(f"_upsample_{tag}5_to_4")(p5)), conv4_1)
        p4 = m(f"_predict_{tag}4")(c4)
        c3 = _cat_as((conv3_1, m(f"_deconv{mid}3")(c4), m(f"_upsample_{tag}4_to_3")(p4)), conv3_1)
        p3 = m(f"_predict_{tag}3")(c3)
        c2 = _cat_as((conv2, m(f"_deconv{mid}2")(c3), m(f"_upsample_{tag}3_to_2")(p3)), conv2)
        return m(f"_predict_{tag}2")(c2), p3, p4, p5, p6

    def forward(self, conv2: torch.Tensor, conv3: torch.Tensor):
        """(flows, occs | None), each finest first: p2 … p6."""
        conv3_1 = self._conv3_1(conv3)
        conv4_1 = self._conv4_1(self._conv4(conv3_1))
        conv5_1 = self._conv5_1(self._conv5(conv4_1))
        conv6_1 = self._conv6_1(self._conv6(conv5_1))
        feats = (conv2, conv3_1, conv4_1, conv5_1, conv6_1)
        flows = self._decode("flow", *feats)
        return flows, (self._decode("occ", *feats) if self.occ else None)


def stem(model: nn.Module, x: torch.Tensor):
    """The stem's (conv2, conv3) features of NCHW ``x`` (``model._conv1`` …
    ``_conv3``: the plain net's core, or an irr net's shared stem,
    ``flownet1s_irr.py:100-113``)."""
    c2 = model._conv2(model._conv1(x))
    return c2, model._conv3(c2)


class FlowNet1S(nn.Module):
    """The FlowNet1S variant family (flags as the JAX ``FlowNet1S``'s)."""

    def __init__(self, n_first_channels: int = 5, div_flow: float = 0.05, irr: bool = False, bi: bool = False,
                 occ: bool = False, num_iters: int = 3):
        super().__init__()
        self.div_flow, self.irr, self.bi, self.occ, self.num_iters = div_flow, irr, bi, occ, num_iters
        if irr:
            self._conv1 = conv_relu(n_first_channels, 32, 7, 2)
            self._conv2 = conv_relu(32, 64, 5, 2)
            self._conv3 = conv_relu(64, 128, 5, 2)
            self._flownets = _FlowNetSCore(64, occ)
        else:
            self._flownets = _FlowNetSCore(128, occ, stem_in=2 * n_first_channels)

    def _full(self, f: torch.Tensor, H: int, W: int) -> torch.Tensor:
        return resize_bilinear(nhwc(f), (H, W), align_corners=True) * (1.0 / self.div_flow)

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, train: bool = False):
        B, H, W, _ = events1.shape
        core, div = self._flownets, self.div_flow
        if not self.irr:
            c2, c3 = stem(core, nchw(torch.cat([events1, events2], dim=-1)))
            flows, occs = core(c2, c3)
            preds = [self._full(f, H, W) for f in flows[::-1]]
            if occs is not None:
                return (resize_bilinear(nhwc(occs[0]), (H, W), align_corners=True), None), preds
            return (events1, events2), preds

        c2_1, c3_1 = stem(self, nchw(events1))
        c2_2, c3_2 = stem(self, nchw(events2))
        c3_2_wp, c3_1_wp = c3_2, c3_1
        acc_f = acc_b = occ_acc_f = occ_acc_b = None
        add = lambda acc, new: new if acc is None else tuple(a + n for a, n in zip(acc, new))  # noqa: E731
        preds, occ_out = [], None
        for it in range(self.num_iters):
            flows_f, occs_f = core(c2_1, torch.cat([c3_1, c3_2_wp], dim=1))
            acc_f = add(acc_f, flows_f)
            if self.occ:
                occ_acc_f = add(occ_acc_f, occs_f)
            if self.bi:
                flows_b, occs_b = core(c2_2, torch.cat([c3_2, c3_1_wp], dim=1))
                acc_b = add(acc_b, flows_b)
                if self.occ:
                    occ_acc_b = add(occ_acc_b, occs_b)
            preds.append(self._full(acc_f[0], H, W))
            if self.occ:
                occ_out = (resize_bilinear(nhwc(occ_acc_f[0]), (H, W), align_corners=True),
                           resize_bilinear(nhwc(occ_acc_b[0]), (H, W), align_corners=True) if self.bi else None)
            if it < self.num_iters - 1:
                c3_2_wp = warp(c3_2, upsample_as(acc_f[0], c3_2.shape[2:]), H, W, div)
                if self.bi:
                    c3_1_wp = warp(c3_1, upsample_as(acc_b[0], c3_1.shape[2:]), H, W, div)
        return (occ_out if self.occ else (events1, events2)), preds


class IRRFlowNet(nn.Module):
    """IRR-FlowNet (reference ``IRR_FlowNet.py:140-277``): ``maps`` =
    (occ_f, occ_b) at the input size, ``preds`` = one forward flow an
    iteration.  The refine targets are detached, as JAX stops their
    gradient."""

    def __init__(self, n_first_channels: int = 5, div_flow: float = 0.05, num_iters: int = 3):
        super().__init__()
        self.div_flow, self.num_iters = div_flow, num_iters
        self._conv1 = conv_relu(n_first_channels, 32, 7, 2)
        self._conv2 = conv_relu(32, 64, 5, 2)
        self._conv3 = conv_relu(64, 128, 5, 2)
        self._flownets = _FlowNetSCore(64, occ=True)
        self.refine_flow = RefineFlow(64)
        self.refine_occ = RefineOcc(64)
        self.occ_shuffle_upsample = OccUpsampleNetwork(2 * n_first_channels + 2 + 2)

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, train: bool = False):
        B, H, W, _ = events1.shape
        core, div = self._flownets, self.div_flow
        ev1, ev2 = nchw(events1), nchw(events2)
        c2_1, c3_1 = stem(self, ev1)
        c2_2, c3_2 = stem(self, ev2)
        c3_2_wp, c3_1_wp = c3_2, c3_1
        h2, w2 = c2_1.shape[2:]
        img1_r, img2_r = upsample_as(ev1, (h2, w2)), upsample_as(ev2, (h2, w2))
        prev = None  # the last iteration's refined (flow_f, flow_b, occ_f, occ_b) at conv2's size
        preds = []
        occ_f = occ_b = None
        for it in range(self.num_iters):
            flows_f, occs_f = core(c2_1, torch.cat([c3_1, c3_2_wp], dim=1))
            flows_b, occs_b = core(c2_2, torch.cat([c3_2, c3_1_wp], dim=1))
            est = (flows_f[0], flows_b[0], occs_f[0], occs_b[0])
            if prev is not None:  # residual on the last refined estimate
                est = tuple(e + upsample_as(p, e.shape[2:]) for e, p in zip(est, prev))
            f2_f, f2_b, o2_f, o2_b = (upsample_as(e, (h2, w2)) for e in est)

            img2_wp = warp(img2_r, f2_f, H, W, div)
            img1_wp = warp(img1_r, f2_b, H, W, div)
            flow1_f = self.refine_flow(f2_f.detach(), img1_r - img2_wp, c2_1)
            flow1_b = self.refine_flow(f2_b.detach(), img2_r - img1_wp, c2_2)
            c2_2_wp = warp(c2_2, flow1_f, H, W, div)
            c2_1_wp = warp(c2_1, flow1_b, H, W, div)
            occ1_f = self.refine_occ(o2_f.detach(), c2_1, c2_1 - c2_2_wp)
            occ1_b = self.refine_occ(o2_b.detach(), c2_2, c2_2 - c2_1_wp)
            prev = (flow1_f, flow1_b, occ1_f, occ1_b)

            flow_full_f, flow_full_b = upsample_as(flow1_f, (H, W)), upsample_as(flow1_b, (H, W))
            preds.append(nhwc(flow_full_f) * (1.0 / div))
            im2_wp = warp(ev2, flow_full_f, H, W, div)
            im1_wp = warp(ev1, flow_full_b, H, W, div)
            fb_wp = warp(flow_full_b, flow_full_f, H, W, div)
            ff_wp = warp(flow_full_f, flow_full_b, H, W, div)
            occ_f = self.occ_shuffle_upsample(occ1_f, torch.cat([ev1, im2_wp, flow_full_f, fb_wp], dim=1))
            occ_b = self.occ_shuffle_upsample(occ1_b, torch.cat([ev2, im1_wp, flow_full_b, ff_wp], dim=1))
            if it < self.num_iters - 1:
                c3_2_wp = warp(c3_2, upsample_as(flow_full_f, c3_2.shape[2:]), H, W, div)
                c3_1_wp = warp(c3_1, upsample_as(flow_full_b, c3_1.shape[2:]), H, W, div)
        return (nhwc(occ_f), nhwc(occ_b)), preds
