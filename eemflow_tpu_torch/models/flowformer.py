"""FlowFormer — latent cost tokens and a recurrent transformer decoder
(counterpart of ``eemflow_tpu/models/flowformer.py:68-527``; reference
``model/flowformer/FlowFormer/LatentCostFormer/``: transformer.py,
encoder.py, decoder.py, attention.py, twins.py, gru.py, gma.py).

  1. instance-norm RAFT encoders for the features and the context (256
     channels, 1/8), ``models/raft_core.BasicEncoder``;
  2. the all-pairs cost volume (no √C), one H1×W1 cost map per source
     pixel, x-major as the einsum ``bxyc,buvc->bxyuv`` lays it out;
  3. ``CostPerceiverEncoder``: each cost map patch-embedded (three 6×6/2
     convs to 1/8, a linear sine embedding of the patch centres fused by a
     1×1 FFN), K=8 latent tokens (a ``normal(1.0)`` parameter)
     cross-attending to it, then ``encoder_depth`` rounds of
     self-attention across the K tokens of a pixel and "vertical"
     attention across the pixels of a token (a 7×7-window twins block,
     padded to whole windows and attending over the padded tokens without
     a mask, then a global block against 4×-subsampled keys and values
     that share one LayerNorm), both with the linear sine embedding on q
     and k and a 64-channel projection of the context on their input; a
     residual around the rounds;
  4. ``MemoryDecoder``: ``decoder_depth`` steps of {the 9×9 cost patch at
     ``coords1`` (the x offset on the outer window axis), a flow token,
     cross-attention to the memory (k and v projected once), GMA's update
     block over [global 64 + local 81] cost features, the convex 8×
     upsample}.

Multi-head attention (``_mha``) scales by ``(dim/heads)^-0.5`` and is
written as JAX writes it: a matmul, a softmax over the last axis, a
matmul.  Every LayerNorm takes flax's epsilon 1e-6 and every GELU is the
exact one.  Attribute names are the reference's
(``memory_encoder.cost_perceiver_encoder.vertical_encoder_layers.N.
local_block.mlp.fc1``, ``memory_decoder.decoder_layer.cross_attend.k``,
``ffn.0/3``), so a released checkpoint loads strictly once the decoder
GMA attention's relative position tables, which its content-only forward
never reads, are dropped (``FLOWFORMER_DROP``).  ``forward(ev1, ev2)``
takes NHWC [B, H, W, bins], replicate-pads to a multiple of ``pad_rate``
("chairs") and returns ``((ev1, ev2), flows)``, ``flows`` [decoder_depth,
B, H, W, 2] unpadded, in eval as in training (JAX has no final-only mode
for it).  The aggregation gate ``gamma`` starts at 0, as flax's.  Under
mixed precision the activations keep the parameters' dtype; the
coordinates stay float32 and the embeddings made from them are cast.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.models.eraft import coords_grid
from eemflow_tpu_torch.models.gma import GMAAggregate, GMAAttention
from eemflow_tpu_torch.models.raft_core import BasicEncoder, BasicMotionEncoder, FlowHead, SepConvGRU
from eemflow_tpu_torch.ops.pad import InputPadder
from eemflow_tpu_torch.ops.upsample import convex_upsample_flow
from eemflow_tpu_torch.ops.warp import _gather_bilinear

# checkpoint keys with no live forward path: the decoder GMA attention's
# relative position tables (reference gma.py:54, content-only forward)
FLOWFORMER_DROP = ("memory_decoder.att.pos_emb.",)

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def linear_position_embedding_sine(coord: torch.Tensor, dim: int, normalize_factor: float = 1.0 / 200) -> torch.Tensor:
    """reference ``attention.py:141-145``: coord [..., 2] (x, y) → [..., dim]."""
    freq = torch.arange(dim // 4, dtype=torch.float32, device=coord.device)
    x = coord[..., -2:-1] * 3.14 * normalize_factor
    y = coord[..., -1:] * 3.14 * normalize_factor
    return torch.cat([torch.sin(x * freq), torch.cos(x * freq), torch.sin(y * freq), torch.cos(y * freq)], dim=-1)


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int = 8) -> torch.Tensor:
    """Multi-head attention (reference ``attention.py:36-61``): [B, L, D]
    tokens, ``(D/heads)^-0.5`` on the full q·k product."""
    B, Lq, D = q.shape
    hd = D // num_heads
    heads = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, hd).transpose(1, 2)
    scores = heads(q) @ heads(k).transpose(-1, -2) * hd ** -0.5
    return (torch.softmax(scores, dim=-1) @ heads(v)).transpose(1, 2).reshape(B, Lq, D)


def _ffn(dim: int) -> nn.Sequential:
    """Linear, exact GELU, (dropout at rate 0), Linear: keys ``.0`` and ``.3``."""
    return nn.Sequential(nn.Linear(dim, dim), nn.GELU(), nn.Identity(), nn.Linear(dim, dim))


class PatchEmbed(nn.Module):
    """Cost-map patch embedding (reference ``encoder.py:25-82``, patch 8)."""

    def __init__(self, embed_dim: int = 64, in_chans: int = 1):
        super().__init__()
        d = embed_dim
        self.embed_dim = d
        self.proj = nn.Sequential(
            nn.Conv2d(in_chans, d // 4, 6, 2, 2), nn.ReLU(inplace=True),
            nn.Conv2d(d // 4, d // 2, 6, 2, 2), nn.ReLU(inplace=True),
            nn.Conv2d(d // 2, d, 6, 2, 2),
        )
        self.ffn_with_coord = nn.Sequential(
            nn.Conv2d(2 * d, 2 * d, 1), nn.ReLU(inplace=True), nn.Conv2d(2 * d, 2 * d, 1),
        )
        self.norm = nn.LayerNorm(2 * d, eps=LN_EPS)

    def forward(self, cost_maps: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """cost_maps NHWC [N, H2, W2, heads] → tokens [N, H3·W3, 2·embed], (H3, W3)."""
        x = cost_maps.permute(0, 3, 1, 2)
        pad_b, pad_r = (8 - x.shape[2] % 8) % 8, (8 - x.shape[3] % 8) % 8
        x = self.proj(F.pad(x, (0, pad_r, 0, pad_b)))
        N, d, H3, W3 = x.shape
        coords = coords_grid(1, H3, W3, device=x.device) * 8 + 4  # patch centres in feature pixels
        pe = linear_position_embedding_sine(coords, d).to(x.dtype).permute(0, 3, 1, 2)
        x = self.ffn_with_coord(torch.cat([x, pe.expand(N, -1, -1, -1)], dim=1))
        return self.norm(x.flatten(2).transpose(1, 2)), (H3, W3)


class EncoderCrossAttention(nn.Module):
    """The encoder's input layer (reference ``encoder.py:199-247``): the
    latent tokens cross-attend to the cost tokens; ``proj`` takes the
    attention output alone."""

    def __init__(self, dim: int, tgt_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(tgt_dim, dim)
        self.v = nn.Linear(tgt_dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = _ffn(dim)

    def forward(self, query: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        x = query + self.proj(_mha(self.q(self.norm1(query)), self.k(tgt), self.v(tgt)))
        return x + self.ffn(self.norm2(x))


class DecoderCrossAttention(nn.Module):
    """The decoder's cross-attention (reference ``decoder.py:29-93``): the
    queries carry the flow position's embedding; ``proj`` takes [attention
    output, shortcut].  ``k`` and ``v`` are applied to the memory once, by
    the decoder, before its loop."""

    def __init__(self, dim: int = 64, mem_dim: int = 128):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(mem_dim, dim)
        self.v = nn.Linear(mem_dim, dim)
        self.proj = nn.Linear(2 * dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = _ffn(dim)

    def forward(self, query, key, value, pos_enc):
        q = self.q(self.norm1(query) + pos_enc)
        x = query + self.proj(torch.cat([_mha(q, key, value), query], dim=-1))
        return x + self.ffn(self.norm2(x))


class SelfAttentionLayer(nn.Module):
    """Self-attention across the K latent tokens of one source pixel
    (reference ``encoder.py:146-196``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = _ffn(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        x = x + self.proj(_mha(self.q(y), self.k(y), self.v(y)))
        return x + self.ffn(self.norm2(x))


class _ContextAttention(nn.Module):
    """What the two twins attentions share: the context projection
    repeated over the K latent tokens and concatenated to the q/k input."""

    def __init__(self, dim: int, vert_c_dim: int, context_dim: int):
        super().__init__()
        self.dim = dim
        self.context_proj = nn.Linear(context_dim, vert_c_dim)
        self.proj = nn.Linear(dim, dim)

    def _inputs(self, x, size, context):
        """x [B·K, H·W, C], context tokens [B, H·W, context_dim] → x and the
        q/k input [B·K, H, W, C + vert_c_dim], NHWC."""
        H, W = size
        BK, B = x.shape[0], context.shape[0]
        c = self.context_proj(context)
        c = c[:, None].expand(B, BK // B, H * W, c.shape[-1]).reshape(BK, H, W, -1)
        xm = x.reshape(BK, H, W, self.dim)
        return xm, torch.cat([xm, c], dim=-1)


class LocallyGroupedAttnRPEContext(_ContextAttention):
    """Attention in 7×7 windows with the linear sine embedding on q and k
    (reference ``twins.py:229-303``); the grid is zero-padded to whole
    windows and the padded tokens take part unmasked.  x is norm1'd by the
    block."""

    def __init__(self, dim: int, vert_c_dim: int = 64, context_dim: int = 256, ws: int = 7, num_heads: int = 8):
        super().__init__(dim, vert_c_dim, context_dim)
        self.ws, self.num_heads = ws, num_heads
        self.q = nn.Linear(dim + vert_c_dim, dim)
        self.k = nn.Linear(dim + vert_c_dim, dim)
        self.v = nn.Linear(dim, dim)

    def forward(self, x, size, context):
        H, W = size
        BK, C, ws = x.shape[0], self.dim, self.ws
        xm, x_qk = self._inputs(x, size, context)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        xp = F.pad(xm, (0, 0, 0, pad_r, 0, pad_b))
        qkp = F.pad(x_qk, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        nh, nw = Hp // ws, Wp // ws

        def windows(t):
            t = t.reshape(BK, nh, ws, nw, ws, t.shape[-1]).permute(0, 1, 3, 2, 4, 5)
            return t.reshape(BK * nh * nw, ws * ws, t.shape[-1])

        coords = coords_grid(1, ws, ws, device=x.device).reshape(1, ws * ws, 2)
        qk = windows(qkp) + linear_position_embedding_sine(coords, qkp.shape[-1]).to(x.dtype)
        o = _mha(self.q(qk), self.k(qk), self.v(windows(xp)), self.num_heads)
        o = o.reshape(BK, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(BK, Hp, Wp, C)[:, :H, :W]
        return self.proj(o.reshape(BK, H * W, C))


class GlobalSubSampleAttnRPEContext(_ContextAttention):
    """Attention against 4×-subsampled keys and values (strided 4×4 convs,
    one LayerNorm for both), the linear sine embedding on q and, at the
    subsampled grid's full-resolution coordinates, on k (reference
    ``twins.py:306-392``)."""

    def __init__(self, dim: int, vert_c_dim: int = 64, context_dim: int = 256, sr_ratio: int = 4,
                 num_heads: int = 8):
        super().__init__(dim, vert_c_dim, context_dim)
        self.sr, self.num_heads = sr_ratio, num_heads
        self.q = nn.Linear(dim + vert_c_dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.sr_key = nn.Conv2d(dim + vert_c_dim, dim, sr_ratio, sr_ratio)
        self.sr_value = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, size, context):
        H, W = size
        BK, C, sr = x.shape[0], self.dim, self.sr
        xm, x_qk = self._inputs(x, size, context)
        pad_b, pad_r = (sr - H % sr) % sr, (sr - W % sr) % sr
        xp = F.pad(xm, (0, 0, 0, pad_r, 0, pad_b))
        qkp = F.pad(x_qk, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        coords = coords_grid(1, Hp, Wp, device=x.device).reshape(1, Hp * Wp, 2)
        enc_q = linear_position_embedding_sine(coords, qkp.shape[-1]).to(x.dtype)
        q = self.q(qkp.reshape(BK, Hp * Wp, -1) + enc_q)
        tokens = lambda t: t.flatten(2).transpose(1, 2)
        ksub = self.norm(tokens(self.sr_key(qkp.permute(0, 3, 1, 2))))
        vsub = self.norm(tokens(self.sr_value(xp.permute(0, 3, 1, 2))))
        Hs, Ws = Hp // sr, Wp // sr
        coords_s = coords_grid(1, Hs, Ws, device=x.device).reshape(1, Hs * Ws, 2) * sr
        k = self.k(ksub + linear_position_embedding_sine(coords_s, C).to(x.dtype))
        o = _mha(q, k, self.v(vsub), self.num_heads)
        o = o.reshape(BK, Hp, Wp, C)[:, :H, :W]
        return self.proj(o.reshape(BK, H * W, C))


class Mlp(nn.Module):
    """timm's ``Mlp`` (keys ``fc1``, ``fc2``), exact GELU."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class TwinsBlock(nn.Module):
    """Pre-norm attention and MLP (reference ``twins.py:750-789``; drop
    path at the shipped rate 0)."""

    def __init__(self, dim: int, attn: nn.Module, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = attn
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, size, context):
        x = x + self.attn(self.norm1(x), size, context)
        return x + self.mlp(self.norm2(x))


class VerticalSelfAttentionLayer(nn.Module):
    """The local 7×7-window block, then the global subsampled block
    (reference ``encoder.py:112-137``)."""

    def __init__(self, dim: int, context_dim: int = 256):
        super().__init__()
        self.local_block = TwinsBlock(dim, LocallyGroupedAttnRPEContext(dim, context_dim=context_dim))
        self.global_block = TwinsBlock(dim, GlobalSubSampleAttnRPEContext(dim, context_dim=context_dim))

    def forward(self, x, size, context):
        return self.global_block(self.local_block(x, size, context), size, context)


class CostPerceiverEncoder(nn.Module):
    """reference ``encoder.py:245-311``."""

    def __init__(self, cost_latent_input_dim: int = 64, cost_latent_token_num: int = 8,
                 cost_latent_dim: int = 128, encoder_depth: int = 3, context_dim: int = 256):
        super().__init__()
        D = cost_latent_dim
        self.patch_embed = PatchEmbed(cost_latent_input_dim)
        self.latent_tokens = nn.Parameter(torch.empty(1, cost_latent_token_num, D))
        self.input_layer = EncoderCrossAttention(D, 2 * cost_latent_input_dim)
        self.encoder_layers = nn.ModuleList(SelfAttentionLayer(D) for _ in range(encoder_depth))
        self.vertical_encoder_layers = nn.ModuleList(
            VerticalSelfAttentionLayer(D, context_dim) for _ in range(encoder_depth)
        )
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The latent tokens' flax initializer, ``normal(1.0)``."""
        nn.init.normal_(self.latent_tokens, std=1.0)

    def forward(self, cost_maps, B, H1, W1, context):
        """cost_maps [B·H1·W1, H1, W1, 1], context tokens [B, H1·W1, C] →
        the cost memory [B·H1·W1, K, D]."""
        tokens, _ = self.patch_embed(cost_maps)
        _, K, D = self.latent_tokens.shape
        x = self.input_layer(self.latent_tokens.expand(B * H1 * W1, K, D), tokens)
        short_cut = x
        for layer, vertical in zip(self.encoder_layers, self.vertical_encoder_layers):
            x = layer(x)
            xv = x.reshape(B, H1 * W1, K, D).transpose(1, 2).reshape(B * K, H1 * W1, D)
            xv = vertical(xv, (H1, W1), context)
            x = xv.reshape(B, K, H1 * W1, D).transpose(1, 2).reshape(B * H1 * W1, K, D)
        return x + short_cut  # cost_encoder_res=True


class MemoryEncoder(nn.Module):
    """reference ``encoder.py:313-368``."""

    def __init__(self, n_first_channels: int = 5, encoder_latent_dim: int = 256, cost_latent_input_dim: int = 64,
                 cost_latent_token_num: int = 8, cost_latent_dim: int = 128, encoder_depth: int = 3):
        super().__init__()
        self.feat_encoder = BasicEncoder(256, "instance", n_first_channels)
        self.channel_convertor = nn.Conv2d(256, encoder_latent_dim, 1, bias=False)
        self.cost_perceiver_encoder = CostPerceiverEncoder(
            cost_latent_input_dim, cost_latent_token_num, cost_latent_dim, encoder_depth,
        )

    def forward(self, im1, im2, context):
        """NCHW images, context tokens [B, H1·W1, 256] → (memory, cost maps
        [B·H1·W1, H1, W1, 1], (H1, W1))."""
        B = im1.shape[0]
        feats = self.channel_convertor(self.feat_encoder(torch.cat([im1, im2], dim=0)))
        H1, W1 = feats.shape[2:]
        f = feats.flatten(2)  # [2B, C, H1·W1]
        corr = f[:B].transpose(1, 2) @ f[B:]  # [B, H1·W1 (x, y), H1·W1 (u, v)]
        cost_maps = corr.reshape(B * H1 * W1, H1, W1, 1)
        memory = self.cost_perceiver_encoder(cost_maps, B, H1, W1, context)
        return memory, cost_maps, (H1, W1)


class FFUpdateBlock(nn.Module):
    """GMA's update block (reference ``gru.py:115-143``) over the 145
    channels of [cost_global (64), cost_forward (81)]; NCHW."""

    def __init__(self, hidden_dim: int = 128, cor_planes: int = 64 + 81):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes=cor_planes)
        self.aggregator = GMAAggregate(128)
        self.gru = SepConvGRU(hidden_dim, input_dim=128 + 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(inplace=True), nn.Conv2d(256, 64 * 9, 1),
        )

    def forward(self, net, inp, corr, flow, attention):
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class MemoryDecoder(nn.Module):
    """reference ``decoder.py:151-263``."""

    def __init__(self, query_latent_dim: int = 64, cost_latent_dim: int = 128, decoder_depth: int = 12):
        super().__init__()
        D = query_latent_dim
        self.decoder_depth = decoder_depth
        self.proj = nn.Conv2d(256, 256, 1)
        self.att = GMAAttention(128, 128)
        self.decoder_layer = nn.ModuleDict({"cross_attend": DecoderCrossAttention(D, cost_latent_dim)})
        self.flow_token_encoder = nn.Sequential(nn.Conv2d(81, D, 1), nn.GELU(), nn.Conv2d(D, D, 1))
        self.update_block = FFUpdateBlock()

    def forward(self, cost_memory, cost_maps, context, size):
        """context NCHW [B, 256, H1, W1] → the upsampled flows, a list."""
        B, H1, W1 = size
        N = B * H1 * W1
        ctx = self.proj(context)
        net, inp = torch.tanh(ctx[:, :128]), torch.relu(ctx[:, 128:])
        attention = self.att(inp)
        cross = self.decoder_layer["cross_attend"]
        mem_k, mem_v = cross.k(cost_memory), cross.v(cost_memory)  # once (decoder.py:64-66)

        coords0 = coords_grid(B, H1, W1, device=context.device)
        coords1 = coords0
        r = 4
        offs = torch.arange(-r, r + 1, dtype=torch.float32, device=context.device)
        flows = []
        for _ in range(self.decoder_depth):
            coords1 = coords1.detach()
            # the 9×9 cost patch at coords1, the x offset on the outer axis
            # (the reference adds its dy meshgrid to x, decoder.py:196-205)
            cx, cy = coords1[..., 0].reshape(N, 1, 1), coords1[..., 1].reshape(N, 1, 1)
            px = (cx + offs[None, :, None]).expand(N, 9, 9)
            py = (cy + offs[None, None, :]).expand(N, 9, 9)
            cost_forward = _gather_bilinear(cost_maps, px, py).reshape(B, H1, W1, 81)

            q = self.flow_token_encoder(cost_forward.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(N, 1, -1)
            pos = linear_position_embedding_sine(coords1.reshape(N, 1, 2), q.shape[-1]).to(q.dtype)
            cost_global = cross(q, mem_k, mem_v, pos).reshape(B, H1, W1, -1)
            corr = torch.cat([cost_global, cost_forward], dim=-1).permute(0, 3, 1, 2).to(net.dtype)
            flow = (coords1 - coords0).permute(0, 3, 1, 2).to(net.dtype)
            net, up_mask, delta = self.update_block(net, inp, corr, flow, attention)
            coords1 = coords1 + delta.permute(0, 2, 3, 1).to(coords1.dtype)
            flows.append(convex_upsample_flow(coords1 - coords0, up_mask.permute(0, 2, 3, 1)))
        return flows


class FlowFormer(nn.Module):
    def __init__(
        self,
        n_first_channels: int = 5,
        encoder_latent_dim: int = 256,
        cost_latent_input_dim: int = 64,
        cost_latent_token_num: int = 8,
        cost_latent_dim: int = 128,
        query_latent_dim: int = 64,
        encoder_depth: int = 3,
        decoder_depth: int = 12,
        pad_rate: int = 32,
    ):
        super().__init__()
        self.pad_rate = pad_rate
        self.context_encoder = BasicEncoder(256, "instance", n_first_channels)
        self.memory_encoder = MemoryEncoder(
            n_first_channels, encoder_latent_dim, cost_latent_input_dim, cost_latent_token_num,
            cost_latent_dim, encoder_depth,
        )
        self.memory_decoder = MemoryDecoder(query_latent_dim, cost_latent_dim, decoder_depth)

    def forward(self, events1: torch.Tensor, events2: torch.Tensor, train: bool = False):
        B, H, W, _ = events1.shape
        padder = InputPadder((H, W), mode="chairs", eval_pad_rate=self.pad_rate)
        im1, im2 = padder.pad_nchw(
            events1.permute(0, 3, 1, 2).contiguous(), events2.permute(0, 3, 1, 2).contiguous()
        )
        context = self.context_encoder(im1)
        memory, cost_maps, (H1, W1) = self.memory_encoder(im1, im2, context.flatten(2).transpose(1, 2))
        flows = self.memory_decoder(memory, cost_maps, context, (B, H1, W1))
        return (events1, events2), torch.stack([padder.unpad(f) for f in flows], dim=0)
