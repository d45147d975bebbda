"""The RAFT update block without its mask head, as two functions of
packed weights (counterpart of ``eemflow_tpu/ops/pallas/update_block.py``):

  * ``motion_encoder_plain`` — convc1 (1×1, 324→256), convc2 (3×3 →192);
    convf1 (7×7, 2→128), convf2 (3×3 →64); conv (3×3, 256→126) over
    [c, f]; ReLU after each; the flow appended → 128 channels;
  * ``gru_flowhead_plain`` — both SepConvGRU stages (1×5 then 5×1, z, r
    and q gates over [h, inp, motion]) and the flow head (3×3 →256, ReLU,
    3×3 →2).

They are the plain PyTorch versions of kernel K5
(``kernels/update_block.py``) and compute the function of the JAX
``motion_encoder_fused``/``gru_flowhead_fused``: every conv pads its input
with zeros ("same"), so neither bias nor a gate's σ(0)=½ leaks in at the
border.  ``dtype=torch.bfloat16`` rounds every conv's operands (input and
weight) to bf16 and accumulates in float32, the JAX bf16 mode.  Tensors
are NHWC [B, H, W, C], as in the JAX functions.

``make_fused_update(update_block, dtype)`` gives ``apply(net, inp, corr,
flow) → (net', Δflow)``: K5 for CUDA tensors, these functions for CPU
tensors.  The plain versions read the parameters themselves, so on the CPU
they give the module path's gradients; K5 has no backward and refuses, under
grad, a parameter or input that requires grad.  Unlike the JAX package, which falls back to the module path when
its row tiling does not fit the grid height (``tiles_ok``), K5 takes any
grid.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from eemflow_tpu_torch.ops.pack_cache import PackCache

MOTION_CONVS = ("convc1", "convc2", "convf1", "convf2", "conv")
GRU_CONVS = ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")
HEAD_CONVS = ("conv1", "conv2")

Weights = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def pack_motion_weights(encoder: nn.Module) -> Weights:
    """``BasicMotionEncoder`` → ((OIHW weight, bias), ...) in the order
    convc1, convc2, convf1, convf2, conv; the parameters themselves, no
    copy."""
    return tuple((getattr(encoder, n).weight, getattr(encoder, n).bias) for n in MOTION_CONVS)


def pack_gru_flowhead_weights(gru: nn.Module, flow_head: nn.Module) -> Weights:
    """``SepConvGRU`` and ``FlowHead`` → ((OIHW weight, bias), ...) in the
    order z1, r1, q1, z2, r2, q2, head conv1, head conv2."""
    mods = [getattr(gru, n) for n in GRU_CONVS] + [getattr(flow_head, n) for n in HEAD_CONVS]
    return tuple((m.weight, m.bias) for m in mods)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float() if dtype != torch.float32 else t.float()


def _conv(x: torch.Tensor, wb: Tuple[torch.Tensor, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """NCHW zero-padded "same" conv with the operands rounded to ``dtype``."""
    w, b = wb
    kh, kw = w.shape[2:]
    return F.conv2d(_round(x, dtype), _round(w, dtype), b.float(), padding=(kh // 2, kw // 2))


def motion_encoder_plain(
    corr: torch.Tensor, flow: torch.Tensor, weights: Weights, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """corr [B, H, W, Cc], flow [B, H, W, 2] → motion [B, H, W, 128] float32."""
    wc1, wc2, wf1, wf2, wo = weights
    corr = corr.permute(0, 3, 1, 2).float()
    flow = flow.permute(0, 3, 1, 2).float()
    c = F.relu(_conv(F.relu(_conv(corr, wc1, dtype)), wc2, dtype))
    f = F.relu(_conv(F.relu(_conv(flow, wf1, dtype)), wf2, dtype))
    o = F.relu(_conv(torch.cat([c, f], dim=1), wo, dtype))
    return torch.cat([o, flow], dim=1).permute(0, 2, 3, 1)


def gru_flowhead_plain(
    net: torch.Tensor, inp: torch.Tensor, motion: torch.Tensor, weights: Weights,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """net, inp, motion [B, H, W, 128] → (net' [B, H, W, 128], Δflow
    [B, H, W, 2]), float32."""
    nchw = lambda t: t.permute(0, 3, 1, 2).float()
    h, x = nchw(net), torch.cat([nchw(inp), nchw(motion)], dim=1)
    for wz, wr, wq in (weights[0:3], weights[3:6]):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_conv(hx, wz, dtype))
        r = torch.sigmoid(_conv(hx, wr, dtype))
        q = torch.tanh(_conv(torch.cat([r * h, x], dim=1), wq, dtype))
        h = (1 - z) * h + z * q
    delta = _conv(F.relu(_conv(h, weights[6], dtype)), weights[7], dtype)
    return h.permute(0, 2, 3, 1), delta.permute(0, 2, 3, 1)


class FusedUpdate:
    """One update block's weights for K5 and its plain version:
    ``__call__(net, inp, corr, flow) → (net', Δflow)``, NHWC.  The plain
    version reads the parameters themselves; the kernel's layout is packed
    per device (``kernels.update_block.pack_update_weights``) and repacked
    when a parameter changes in place (``PackCache``).  A parameter
    replaced by another tensor is not seen: make a new ``FusedUpdate``."""

    def __init__(self, motion: Weights, gru: Weights, dtype: torch.dtype = torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"fused update: dtype must be float32 or bfloat16, got {dtype}")
        self.motion = motion
        self.gru = gru
        self.dtype = dtype
        self._packs = PackCache()

    def tensors(self) -> List[torch.Tensor]:
        """Every weight and bias, motion encoder first."""
        return [t for wb in self.motion + self.gru for t in wb]

    def packed(self, device: torch.device):
        from eemflow_tpu_torch.kernels.update_block import pack_update_weights

        device = torch.device(device)
        return self._packs.get(
            device, self.tensors(),
            lambda: pack_update_weights(self.motion, self.gru, self.dtype == torch.bfloat16, device),
        )

    def __call__(
        self, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor, flow: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        from eemflow_tpu_torch.kernels.update_block import update_gru, update_motion

        motion = update_motion(corr, flow, self)
        return update_gru(net, inp, motion, self)


def make_fused_update(update_block: nn.Module, dtype: torch.dtype = torch.float32) -> FusedUpdate:
    """``BasicUpdateBlock`` → its K5 apply function (mask head excluded: the
    caller runs it once, on the final net)."""
    return FusedUpdate(
        pack_motion_weights(update_block.encoder),
        pack_gru_flowhead_weights(update_block.gru, update_block.flow_head),
        dtype,
    )

