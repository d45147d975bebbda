"""GMFlow — global matching over transformer features (counterpart of
``eemflow_tpu/models/gmflow.py:44-465``; reference ``model/GMflow/``:
gmflow.py, transformer.py, matching.py, backbone.py, position.py,
utils.py, trident_conv.py).

  1. an instance-norm CNN encoder to 1/8 (``num_scales=2``: to 1/4, then
     one shared 3×3 kernel at strides 1 and 2, ``TridentConv``, for the
     1/4 and 1/8 branches);
  2. the DETR sine position embedding, computed per attention window and
     tiled over the windows when ``splits > 1``;
  3. ``num_transformer_layers`` × (self-attention, then cross-attention and
     FFN) over both views, the two directions stacked in the batch and
     swapped after each layer; single-head attention over ``splits²``
     windows, every second layer on windows shifted by half a window with
     Swin's −100 mask on cross-region pairs;
  4. softmax matching: global (the expected target position under
     softmax(f0·f1ᵀ/√C)) or local within ``corr_radius`` (kernel K2 on the
     card, ``ops/correlation.local_correlation``, multiplied back by C,
     −1e9 outside the frame);
  5. flow propagation by self-attention (features as query and key, the
     flow as value; the key projected from the *query*, the reference's
     quirk), global or in a ``prop_radius`` window;
  6. RAFT's convex 8× upsampling (a 9·u² mask from [flow, features]).

Tokens are NHWC ``[B, H·W, C]``; the encoder is NCHW.  Every LayerNorm
takes flax's epsilon 1e-6 and every GELU is the exact one.  Attention is
written as JAX writes it: a matmul, a softmax over the last axis, a
matmul.  Attribute names are the reference's (``backbone.layer1.0``,
``transformer.layers.N.self_attn.q_proj``, ``cross_attn_ffn.mlp.0/2``,
``feature_flow_attn``, ``upsampler.0/2``), so a released checkpoint loads
with a strict ``load_state_dict``.  ``forward(ev1, ev2, train=False)``
takes NHWC [B, H, W, bins], replicate-pads to a multiple of ``pad_rate``
("chairs"), and returns ``((ev1, ev2), flows)``: ``flows`` [1, B, H, W, 2]
in eval, and in train mode every prediction (per scale: the matching's
bilinear upsample, then the propagation's; the last convex), each
unpadded.  Under mixed precision the activations keep the parameters'
dtype: the embedding, the masks and the grids are cast to it (flax promotes
the features to float32 at the float32 embedding instead, so JAX's "bf16"
step runs the transformer in float32).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.models.layers import InstanceNorm
from eemflow_tpu_torch.ops.correlation import local_correlation
from eemflow_tpu_torch.ops.pad import InputPadder
from eemflow_tpu_torch.ops.upsample import convex_upsample_flow, resize_bilinear
from eemflow_tpu_torch.ops.warp import warp_align_corners

LN_EPS = 1e-6  # flax nn.LayerNorm's default

# constants by shape, dtype and device, made once: remade each forward they
# would cost the host a dozen small launches apiece
_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def _constant(key: tuple, make) -> torch.Tensor:
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):  # a normal tensor, which training may save
            t = _CONSTANTS[key] = make()
    return t


class GMResidualBlock(nn.Module):
    """Bias-free 3×3 convs with instance norms (reference ``backbone.py:
    5-37``); a strided or widening block's shortcut is ``downsample.0``
    (a 1×1 conv with bias) and ``norm3``."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, dilation, dilation, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, dilation, dilation, bias=False)
        self.norm1 = InstanceNorm(planes)
        self.norm2 = InstanceNorm(planes)
        if stride != 1 or in_planes != planes:
            self.norm3 = InstanceNorm(planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride), self.norm3)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class TridentConv(nn.Module):
    """One shared bias-free 3×3 kernel at strides 1 and 2 (reference
    ``trident_conv.py`` ``MultiScaleTridentConv``): high → low resolution."""

    def __init__(self, in_channels: int, features: int, strides: Sequence[int] = (1, 2)):
        super().__init__()
        self.strides = tuple(strides)
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor):
        return [F.conv2d(x, self.weight, None, s, 1) for s in self.strides]


class CNNEncoder(nn.Module):
    """NCHW [B, bins, H, W] → a list of NCHW features, high → low
    resolution: [1/8] (``num_output_scales=1``) or [1/4, 1/8]."""

    def __init__(self, n_first_channels: int = 5, output_dim: int = 128, num_output_scales: int = 1):
        super().__init__()
        self.num_output_scales = num_output_scales
        self.conv1 = nn.Conv2d(n_first_channels, 64, 7, 2, 3, bias=False)
        self.norm1 = InstanceNorm(64)
        self.layer1 = nn.Sequential(GMResidualBlock(64, 64), GMResidualBlock(64, 64))
        self.layer2 = nn.Sequential(GMResidualBlock(64, 96, 2), GMResidualBlock(96, 96))
        stride = 2 if num_output_scales == 1 else 1
        self.layer3 = nn.Sequential(GMResidualBlock(96, 128, stride), GMResidualBlock(128, 128))
        self.conv2 = nn.Conv2d(128, output_dim, 1)
        if num_output_scales > 1:
            self.trident_conv = TridentConv(output_dim, output_dim)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The reference's He-normal (fan out) convs."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.conv2(self.layer3(self.layer2(self.layer1(x))))
        if self.num_output_scales == 1:
            return [x]
        return self.trident_conv(x)


def position_embedding_sine(h: int, w: int, num_pos_feats: int, temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """DETR sine embedding (reference ``position.py``) → [H, W, 2·npf],
    float32, the JAX function's operations in its order."""
    scale = 2 * math.pi
    eps = 1e-6
    ones = torch.ones(h, w, dtype=torch.float32, device=device)
    y_embed = torch.cumsum(ones, 0)
    x_embed = torch.cumsum(ones, 1)
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], -1).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], -1).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


def split_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, H, W, C] → [B·k·k, H/k, W/k, C] (reference ``utils.split_feature``)."""
    B, H, W, C = x.shape
    x = x.reshape(B, k, H // k, k, W // k, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * k * k, H // k, W // k, C)


def merge_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    Bk, h, w, C = x.shape
    x = x.reshape(Bk // (k * k), k, k, h, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(Bk // (k * k), k * h, k * w, C)


def shift_window_attn_mask(h: int, w: int, wh: int, ww: int, sh: int, sw: int,
                           device=None) -> torch.Tensor:
    """Swin's shifted-window mask (reference ``transformer.py:19-44``):
    [k·k, wh·ww, wh·ww], −100 on pairs from different regions, else 0."""
    img = torch.zeros(1, h, w, 1, device=device)
    cnt = 0
    for hlo, hhi in ((0, h - wh), (h - wh, h - sh), (h - sh, h)):
        for wlo, whi in ((0, w - ww), (w - ww, w - sw), (w - sw, w)):
            img[:, hlo:hhi, wlo:whi, :] = cnt
            cnt += 1
    windows = split_windows(img, h // wh).reshape(-1, wh * ww)
    diff = windows[:, None, :] - windows[:, :, None]
    return torch.where(diff != 0, torch.tensor(-100.0, device=device), torch.tensor(0.0, device=device))


def _attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-head attention ``softmax(q·kᵀ/√c + mask)·v``; the mask [n, L,
    L] is added to each group of n consecutive batch entries."""
    c = q.shape[-1]
    scores = q @ k.transpose(-1, -2) / (c ** 0.5)
    if mask is not None:
        n, L, M = mask.shape
        scores = (scores.view(-1, n, L, M) + mask).view(-1, L, M)
    return torch.softmax(scores, dim=-1) @ v


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int = 128, no_ffn: bool = False, ffn_dim_expansion: int = 4,
                 with_shift: bool = False):
        super().__init__()
        self.d_model = d_model
        self.no_ffn = no_ffn
        self.with_shift = with_shift
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        if not no_ffn:
            c = 2 * d_model
            self.mlp = nn.Sequential(
                nn.Linear(c, c * ffn_dim_expansion, bias=False), nn.GELU(),
                nn.Linear(c * ffn_dim_expansion, d_model, bias=False),
            )
            self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, source: torch.Tensor, target: torch.Tensor, h: int, w: int, num_splits: int,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        B, C = source.shape[0], self.d_model
        if num_splits > 1:
            wh, ww = h // num_splits, w // num_splits

            def to_win(t):
                t = t.reshape(B, h, w, C)
                if self.with_shift:
                    t = torch.roll(t, (-(wh // 2), -(ww // 2)), dims=(1, 2))
                return split_windows(t, num_splits).reshape(-1, wh * ww, C)

            msg = _attn(to_win(q), to_win(k), to_win(v), attn_mask if self.with_shift else None)
            msg = merge_windows(msg.reshape(-1, wh, ww, C), num_splits)
            if self.with_shift:
                msg = torch.roll(msg, (wh // 2, ww // 2), dims=(1, 2))
            msg = msg.reshape(B, h * w, C)
        else:
            msg = _attn(q, k, v)
        msg = self.norm1(self.merge(msg))
        if not self.no_ffn:
            msg = self.norm2(self.mlp(torch.cat([source, msg], dim=-1)))
        return source + msg


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int = 128, ffn_dim_expansion: int = 4, with_shift: bool = False):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, True, ffn_dim_expansion, with_shift)
        self.cross_attn_ffn = TransformerLayer(d_model, False, ffn_dim_expansion, with_shift)

    def forward(self, source, target, h, w, num_splits, attn_mask=None):
        source = self.self_attn(source, source, h, w, num_splits, attn_mask)
        return self.cross_attn_ffn(source, target, h, w, num_splits, attn_mask)


class FeatureTransformer(nn.Module):
    def __init__(self, num_layers: int = 6, d_model: int = 128, ffn_dim_expansion: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, ffn_dim_expansion, with_shift=(i % 2 == 1)) for i in range(num_layers)
        )

    def forward(self, feature0: torch.Tensor, feature1: torch.Tensor, num_splits: int):
        """NHWC features → NHWC features, both views."""
        B, H, W, C = feature0.shape
        f0, f1 = feature0.reshape(B, H * W, C), feature1.reshape(B, H * W, C)
        attn_mask = None
        if num_splits > 1:
            wh, ww = H // num_splits, W // num_splits
            attn_mask = _constant(
                ("shift_mask", H, W, num_splits, f0.dtype, f0.device),
                lambda: shift_window_attn_mask(H, W, wh, ww, wh // 2, ww // 2, f0.device).to(f0.dtype),
            )
        # both directions stacked in the batch (reference transformer.py:301-315)
        c0, c1 = torch.cat([f0, f1], dim=0), torch.cat([f1, f0], dim=0)
        for layer in self.layers:
            c0 = layer(c0, c1, H, W, num_splits, attn_mask)
            a, b = c0.chunk(2, dim=0)
            c1 = torch.cat([b, a], dim=0)
        f0, f1 = c0.chunk(2, dim=0)
        return f0.reshape(B, H, W, C), f1.reshape(B, H, W, C)


def _grid(h: int, w: int, dtype, device) -> torch.Tensor:
    """[H·W, 2] (x, y) pixel coordinates."""
    def make():
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
        return torch.stack([gx, gy], dim=-1).reshape(h * w, 2).to(dtype)
    return _constant(("grid", h, w, dtype, device), make)


def global_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor) -> torch.Tensor:
    """Softmax global matching (reference ``matching.py:8-37``): NHWC
    features → the flow [B, H, W, 2]."""
    B, H, W, C = feature0.shape
    corr = feature0.reshape(B, H * W, C) @ feature1.reshape(B, H * W, C).transpose(1, 2) / (C ** 0.5)
    grid = _grid(H, W, corr.dtype, corr.device)
    corresp = torch.softmax(corr, dim=-1) @ grid
    return corresp.reshape(B, H, W, 2) - grid.reshape(H, W, 2)


def _local_targets(h: int, w: int, radius: int, dtype, device):
    """The window's target coordinates sx, sy [H, W, k²] (dy-major, as K2's
    channels) and where they lie inside the frame."""
    def make():
        k = 2 * radius + 1
        offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
        dy, dx = offs.repeat_interleave(k), offs.repeat(k)
        gx = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
        gy = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
        sx, sy = gx + dx, gy + dy
        valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        return torch.stack([sx.expand(h, w, k * k), sy.expand(h, w, k * k), valid.float()]).to(dtype)
    return _constant(("local", h, w, radius, dtype, device), make)


def local_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor, radius: int) -> torch.Tensor:
    """Softmax local matching (reference ``matching.py:40-85``): the
    correlation over the (2r+1)² window (K2 on the card, ÷C) multiplied
    back by C, then ÷√C; −1e9 outside the frame."""
    B, H, W, C = feature0.shape
    corr = local_correlation(feature0, feature1, radius) * C / (C ** 0.5)
    sx, sy, valid = _local_targets(H, W, radius, corr.dtype, corr.device)
    corr = torch.where(valid.bool(), corr, torch.tensor(-1e9, dtype=corr.dtype, device=corr.device))
    prob = torch.softmax(corr, dim=-1)
    corresp = torch.stack([torch.sum(prob * sx, dim=-1), torch.sum(prob * sy, dim=-1)], dim=-1)
    return corresp - _grid(H, W, corr.dtype, corr.device).reshape(H, W, 2)


class FeatureFlowAttention(nn.Module):
    """Flow propagation (reference ``transformer.py:325-430``): the
    features as query and key, the flow as value; ``k_proj`` is applied to
    the projected query, as in the reference."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)

    def forward(self, feature0: torch.Tensor, flow: torch.Tensor, local_window_radius: int = -1) -> torch.Tensor:
        """NHWC features [B, H, W, C] and flow [B, H, W, 2] → the flow."""
        B, H, W, C = feature0.shape
        q = self.q_proj(feature0.reshape(B, H * W, C))
        k = self.k_proj(q)
        if local_window_radius > 0:
            r = local_window_radius
            ks = 2 * r + 1
            kpad = F.pad(k.reshape(B, H, W, C), (0, 0, r, r, r, r))
            vpad = F.pad(flow, (0, 0, r, r, r, r))
            shifts = [(dy, dx) for dy in range(ks) for dx in range(ks)]
            kwin = torch.stack([kpad[:, dy:dy + H, dx:dx + W] for dy, dx in shifts], dim=3)  # [B, H, W, ks², C]
            vwin = torch.stack([vpad[:, dy:dy + H, dx:dx + W] for dy, dx in shifts], dim=3)  # [B, H, W, ks², 2]
            scores = (q.reshape(B, H, W, 1, C) @ kwin.transpose(-1, -2)) / (C ** 0.5)  # [B, H, W, 1, ks²]
            return (torch.softmax(scores, dim=-1) @ vwin).reshape(B, H, W, 2)
        return _attn(q, k, flow.reshape(B, H * W, 2)).reshape(B, H, W, 2)


class GMFlow(nn.Module):
    def __init__(
        self,
        n_first_channels: int = 5,
        num_scales: int = 1,
        feature_channels: int = 128,
        upsample_factor: int = 8,
        num_transformer_layers: int = 6,
        ffn_dim_expansion: int = 1,
        attn_splits_list: Sequence[int] = (2,),
        corr_radius_list: Sequence[int] = (-1,),
        prop_radius_list: Sequence[int] = (-1,),
        pad_rate: int = 32,
    ):
        super().__init__()
        self.num_scales = num_scales
        self.feature_channels = feature_channels
        self.upsample_factor = upsample_factor
        self.attn_splits_list = tuple(attn_splits_list)
        self.corr_radius_list = tuple(corr_radius_list)
        self.prop_radius_list = tuple(prop_radius_list)
        self.pad_rate = pad_rate
        self.backbone = CNNEncoder(n_first_channels, feature_channels, num_scales)
        self.transformer = FeatureTransformer(num_transformer_layers, feature_channels, ffn_dim_expansion)
        self.feature_flow_attn = FeatureFlowAttention(feature_channels)
        self.upsampler = nn.Sequential(
            nn.Conv2d(2 + feature_channels, 256, 3, 1, 1), nn.ReLU(inplace=True),
            nn.Conv2d(256, upsample_factor ** 2 * 9, 1),
        )

    def _position(self, h: int, w: int, splits: int, dtype, device) -> torch.Tensor:
        """[H, W, C] embedding: per window, tiled over the windows."""
        def make():
            npf = self.feature_channels // 2
            if splits > 1:
                pos = position_embedding_sine(h // splits, w // splits, npf, device=device)
                pos = merge_windows(pos[None].expand(splits * splits, -1, -1, -1), splits)[0]
            else:
                pos = position_embedding_sine(h, w, npf, device=device)
            return pos.to(dtype)
        return _constant(("pos", h, w, splits, self.feature_channels, dtype, device), make)

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, train: bool = False):
        B, H, W, _ = events1.shape
        padder = InputPadder((H, W), mode="chairs", eval_pad_rate=self.pad_rate)
        img0, img1 = padder.pad_nchw(
            events1.permute(0, 3, 1, 2).contiguous(), events2.permute(0, 3, 1, 2).contiguous()
        )
        hp, wp = img0.shape[2:]
        nhwc = lambda fs: [f.permute(0, 2, 3, 1) for f in fs[::-1]]  # low → high resolution
        f0_list, f1_list = nhwc(self.backbone(img0)), nhwc(self.backbone(img1))

        def full_res(flow, factor):
            return padder.unpad(resize_bilinear(flow, (hp, wp), align_corners=True) * factor)

        flow = None
        preds = []
        for scale_idx in range(self.num_scales):
            feature0, feature1 = f0_list[scale_idx], f1_list[scale_idx]
            factor = self.upsample_factor * 2 ** (self.num_scales - 1 - scale_idx)
            fh, fw = feature0.shape[1:3]
            if scale_idx > 0:
                flow = resize_bilinear(flow, (fh, fw), align_corners=True) * 2
            if flow is not None:
                flow = flow.detach()
                feature1 = warp_align_corners(feature1, flow)

            splits = self.attn_splits_list[scale_idx]
            corr_radius = self.corr_radius_list[scale_idx]
            pos = self._position(fh, fw, splits, feature0.dtype, feature0.device)
            feature0, feature1 = self.transformer(feature0 + pos, feature1 + pos, splits)

            if corr_radius == -1:
                flow_pred = global_correlation_softmax(feature0, feature1)
            else:
                flow_pred = local_correlation_softmax(feature0, feature1, corr_radius)
            flow = flow + flow_pred if flow is not None else flow_pred
            if train:
                preds.append(full_res(flow, factor))

            flow = self.feature_flow_attn(feature0, flow.detach(), self.prop_radius_list[scale_idx])
            if scale_idx < self.num_scales - 1:
                if train:
                    preds.append(full_res(flow, factor))
                continue
            # convex upsampling, the mask from [flow, features]
            concat = torch.cat([flow, feature0], dim=-1).permute(0, 3, 1, 2)
            mask = self.upsampler(concat).permute(0, 2, 3, 1)
            preds.append(padder.unpad(convex_upsample_flow(flow, mask, factor=self.upsample_factor)))
        return (events1, events2), torch.stack(preds, dim=0)
