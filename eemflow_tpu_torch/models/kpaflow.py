"""KPA-Flow — kernel-patch attention flow (counterpart of
``eemflow_tpu/models/kpaflow.py:40-232``; reference ``model/KPAflow/``).

Kernel-patch attention (``PatchWindowAttention``, reference
``module.py:64-149``): the grid is padded and split into sc×sc patches;
every pixel of a patch attends to the 3sc×3sc window of the patch and its
8 neighbours (queries a pixel, keys and values a window position), with an
additive out-of-frame mask and, in the decoder, a distance "focus" kernel
that multiplies the scores; a learned ``gamma`` gates the residual.  The
encoder applies it to both feature maps before the correlation volume
(``trans``, sc_enc = 13, shared by the two maps); the update block
aggregates the motion features with it in every iteration (sc_dec = 19).

The JAX package's arithmetic is kept where it is unusual:

  * the grid is padded by ``sc - dim % sc`` *even when ``dim`` is already a
    multiple of ``sc``*, which adds a whole empty patch;
  * the out-of-frame mask is *added*: ``(fm_k·fm_q − 1)·99``;
  * the focus kernel *multiplies* the masked scores: per axis
    ``max(0, 1 − PReLU(d − 2sc))`` with the PReLU's slope ``w_prelu·0.02``
    (so a far window position scores 0, not −inf);
  * the softmax runs over the window axis (axis 2 of JAX's [B, n, 9sc², sc²];
    the port holds the scores transposed, [B, n, sc², 9sc²], and takes it
    along the last axis: a softmax along another axis ran 65% of the
    forward's device time on the card);
  * each iteration's prediction is ``upflow8(coords1 − coords0)``, not a
    convex upsample (the JAX docstring says "convex-upsampled"; its code,
    which made the golden checkpoint, does not).

At MVSEC's 256×256 crop (a 32×32 grid) the encoder's attention has 3×3
patches of 13 and the decoder's 2×2 of 19; at 720×1280 (``pad_rate`` 8:
no padding, a 90×160 grid) 7×13 and 5×9.

Mixed precision: the decoder's focus kernel is float32 (a constant times
the parameter ``w_prelu``), and JAX promotes the bf16 scores it multiplies
to float32, so the softmax and the aggregation run in float32 there, as in
JAX.  JAX's bf16 step then stops: its loop carries the GRU state, which
the float32 aggregate promotes (``nn.scan`` refuses a carry whose dtype
changes).  The port casts the aggregate to the state's dtype before the
GRU instead, so that the GRU and the state stay bf16.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.models.eraft import coords_grid
from eemflow_tpu_torch.models.raft_core import BasicEncoder, SepConvGRU
from eemflow_tpu_torch.ops.corr_block import build_corr_pyramid, lookup_corr_pyramid
from eemflow_tpu_torch.ops.pad import InputPadder
from eemflow_tpu_torch.ops.upsample import upflow8

# checkpoint keys with no live forward path (the reference's unused buffer)
KPAFLOW_DROP = ("zero",)


def _patchify(x: torch.Tensor, sc: int) -> torch.Tensor:
    """[B, H, W, C] (H, W multiples of sc) → [B, n_patches, sc·sc, C]."""
    B, H, W, C = x.shape
    hs, ws = H // sc, W // sc
    x = x.reshape(B, hs, sc, ws, sc, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, hs * ws, sc * sc, C)


def _unpatchify(x: torch.Tensor, sc: int, hs: int, ws: int) -> torch.Tensor:
    B, n, s2, C = x.shape
    x = x.reshape(B, hs, ws, sc, sc, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, hs * sc, ws * sc, C)


def _window_keys(x: torch.Tensor, sc: int) -> torch.Tensor:
    """[B, Hp, Wp, C], padded by sc on every side → each patch's 3sc×3sc
    window as [B, n_patches, 9·sc·sc, C] (the 9 neighbour patches in
    row-major order, each patch-major)."""
    B, Hp, Wp, C = x.shape
    hs, ws = Hp // sc - 2, Wp // sc - 2
    wins = [_patchify(x[:, dy * sc:(dy + hs) * sc, dx * sc:(dx + ws) * sc, :], sc)
            for dy in range(3) for dx in range(3)]
    return torch.cat(wins, dim=2)


def _window_offsets(sc: int) -> np.ndarray:
    """Each window position's offset (py, px) in [-sc, 2sc) from the query
    patch's origin, in ``_window_keys``' order: [9·sc·sc, 2] float32."""
    i = np.arange(sc)
    pos = [((dy - 1) * sc + iy, (dx - 1) * sc + ix) for dy in range(3) for dx in range(3) for iy in i for ix in i]
    return np.array(pos, np.float32)


# per (H, W, sc, device): the additive out-of-frame mask [1, n, sc², 9sc²]
# and the focus kernel's distances [sc², 9sc²]; made once, outside
# inference mode, so that training may save them
_CONSTS: Dict[tuple, tuple] = {}


def _consts(H: int, W: int, sc: int, device) -> tuple:
    key = (H, W, sc, str(device))
    hit = _CONSTS.get(key)
    if hit is None:
        y_pad, x_pad = sc - H % sc, sc - W % sc
        with torch.inference_mode(False):
            ones = torch.zeros(1, H + y_pad + 2 * sc, W + x_pad + 2 * sc, 1, device=device)
            ones[:, sc:sc + H, sc:sc + W] = 1.0
            fm_k = _window_keys(ones, sc)[..., 0]  # [1, n, 9sc²]
            fm_q = _patchify(ones[:, sc:-sc, sc:-sc], sc)[..., 0]  # [1, n, sc²]
            am = (fm_q[:, :, :, None] * fm_k[:, :, None, :] - 1.0) * 99.0  # [1, n, sc², 9sc²]
            offs = torch.from_numpy(_window_offsets(sc)).to(device)  # [K, 2]
            q = torch.arange(sc * sc, device=device)
            dy = (offs[None, :, 0] - (q // sc)[:, None].float()).abs()  # [sc², K]
            dx = (offs[None, :, 1] - (q % sc)[:, None].float()).abs()
        hit = _CONSTS[key] = (am, dy, dx)
    return hit


class PatchWindowAttention(nn.Module):
    """The machinery of KPAEnc and KPA: patch queries against their
    3sc×3sc window's keys with the out-of-frame mask, and with
    ``use_focus`` the distance focus kernel.  ``forward(feat_qk_src,
    feat_v_src)`` NCHW → NCHW, ``feat_v_src + gamma·out``."""

    def __init__(self, in_qk: int, in_v: int, channels: int, sc: int, use_focus: bool = False):
        super().__init__()
        self.channels = channels
        self.sc = sc
        self.use_focus = use_focus
        self.to_qk = nn.Conv2d(in_qk, 2 * channels, 1, bias=False)
        self.to_v = nn.Conv2d(in_v, channels, 1, bias=False)
        if use_focus:
            self.w_prelu = nn.Parameter(torch.full((1,), 1.0 / ((3 * sc - 1) / 2)))
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, feat_qk_src: torch.Tensor, feat_v_src: torch.Tensor) -> torch.Tensor:
        B, _, H, W = feat_qk_src.shape
        sc = self.sc
        y_pad, x_pad = sc - H % sc, sc - W % sc
        hs, ws = (H + y_pad) // sc, (W + x_pad) // sc
        # 1x1 convs commute with zero padding (no bias)
        q, k = self.to_qk(feat_qk_src).permute(0, 2, 3, 1).chunk(2, dim=-1)
        v = self.to_v(feat_v_src).permute(0, 2, 3, 1)
        q = F.pad(q, (0, 0, 0, x_pad, 0, y_pad))
        kw = _window_keys(F.pad(k, (0, 0, sc, sc + x_pad, sc, sc + y_pad)), sc) * (self.channels ** -0.5)
        vw = _window_keys(F.pad(v, (0, 0, sc, sc + x_pad, sc, sc + y_pad)), sc)  # [B, n, 9sc², C]
        qp = _patchify(q, sc)  # [B, n, sc², C]
        am, dy, dx = _consts(H, W, sc, feat_qk_src.device)
        # queries by window positions, [B, n, sc², 9sc²]: JAX's [B, n, 9sc²,
        # sc²] transposed, so that the softmax over the window runs along the
        # last axis
        scores = qp @ kw.transpose(-1, -2) + am.to(kw.dtype)
        if self.use_focus:
            slope = self.w_prelu * 0.02
            half_ker = 2.0 * sc

            def focus(d):
                a = d - half_ker
                return torch.clamp(1.0 - torch.where(a >= 0, a, a * slope), min=0.0)

            # float32: the bf16 scores are promoted, as in JAX
            scores = scores * (focus(dy) * focus(dx)).float()
        attn = torch.softmax(scores, dim=-1)
        out = attn @ vw.to(attn.dtype)  # [B, n, sc², C]
        out = _unpatchify(out, sc, hs, ws)[:, :H, :W].permute(0, 3, 1, 2)
        return feat_v_src + self.gamma * out


class KPAFlowDec(nn.Module):
    """The update block (reference ``module.py:13-61``): the motion encoder,
    KPA over the motion features, the SepConvGRU and the flow head (no
    upsample mask)."""

    def __init__(self, chnn: int = 128, sc: int = 19, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.C_cor = nn.Sequential(nn.Conv2d(cor_planes, 256, 1), nn.ReLU(inplace=True),
                                   nn.Conv2d(256, 192, 3, padding=1), nn.ReLU(inplace=True))
        self.C_flo = nn.Sequential(nn.Conv2d(2, 128, 7, padding=3), nn.ReLU(inplace=True),
                                   nn.Conv2d(128, 64, 3, padding=1), nn.ReLU(inplace=True))
        self.C_mo = nn.Sequential(nn.Conv2d(192 + 64, 126, 3, padding=1), nn.ReLU(inplace=True))
        self.kpa = PatchWindowAttention(chnn, 128, chnn, sc, use_focus=True)
        self.gru = SepConvGRU(chnn, input_dim=chnn + 128 + chnn)
        self.C_flow = nn.Sequential(nn.Conv2d(chnn, chnn * 2, 3, padding=1), nn.ReLU(inplace=True),
                                    nn.Conv2d(chnn * 2, 2, 3, padding=1))

    def forward(self, net, inp, corr, flow):
        mo = self.C_mo(torch.cat([self.C_cor(corr), self.C_flo(flow)], dim=1))
        feat_mo = torch.cat([mo, flow], dim=1)
        # the aggregate at the state's dtype (float32 from the focus kernel
        # under mixed precision; see the module docstring)
        feat_moa = self.kpa(inp, feat_mo).to(net.dtype)
        net = self.gru(net, torch.cat([inp, feat_mo, feat_moa], dim=1))
        return net, self.C_flow(net)


class KPAFlow(nn.Module):
    """``forward(ev1, ev2)`` NHWC → ``((ev1, ev2), flows [iters, B, H, W,
    2])``, every iteration's ``upflow8`` prediction."""

    def __init__(
        self,
        n_first_channels: int = 5,
        iters: int = 12,
        corr_levels: int = 4,
        corr_radius: int = 4,
        sc_enc: int = 13,
        sc_dec: int = 19,
        pad_rate: int = 8,
        cnet_norm: str = "batch",
    ):
        super().__init__()
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.pad_rate = pad_rate
        self.fnet = BasicEncoder(256, "instance", n_first_channels)
        self.trans = PatchWindowAttention(256, 256, 256, sc_enc)
        self.cnet = BasicEncoder(256, cnet_norm, n_first_channels)
        self.update_block = KPAFlowDec(128, sc_dec, corr_levels, corr_radius)

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, iters: Optional[int] = None,
                train: bool = False):
        n_iters = self.iters if iters is None else iters
        B, H, W, _ = events1.shape
        padder = InputPadder((H, W), mode="chairs", eval_pad_rate=self.pad_rate)
        im1, im2 = padder.pad_nchw(
            events1.permute(0, 3, 1, 2).contiguous(), events2.permute(0, 3, 1, 2).contiguous()
        )
        fmap1, fmap2 = self.fnet(im1), self.fnet(im2)
        fmap1, fmap2 = self.trans(fmap1, fmap1), self.trans(fmap2, fmap2)
        pyramid = build_corr_pyramid(fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 3, 1), self.corr_levels)
        cnet = self.cnet(im1)
        net = torch.tanh(cnet[:, :128])
        inp = F.relu(cnet[:, 128:])

        h8, w8 = im1.shape[2] // 8, im1.shape[3] // 8
        coords0 = coords_grid(B, h8, w8, device=im1.device)
        coords1 = coords0
        preds = []
        for _ in range(n_iters):
            coords1 = coords1.detach()
            corr = lookup_corr_pyramid(pyramid, coords1, self.corr_radius).to(net.dtype)
            flow = (coords1 - coords0).to(net.dtype)
            net, delta = self.update_block(net, inp, corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
            coords1 = coords1 + delta.permute(0, 2, 3, 1).to(coords1.dtype)
            preds.append(upflow8(coords1 - coords0))
        return (events1, events2), padder.unpad(torch.stack(preds, dim=0))
