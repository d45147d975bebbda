"""EEMFlow's fused coarse head (counterpart of
``eemflow_tpu/ops/pallas/coarse_head.py:52-258, 275-303``).

The whole coarse stage of EEMFlow — for each of the three pooled levels
the 53-channel local correlation next to ``rconv`` (3×3 → 16), the 7-conv
grouped, channel-shuffled decoder to 2 channels; then the 1×1
``out_conv`` over the 6 channels — as one function of the pooled NHWC
features and the model's coarse-stage parameters.

The pack helpers are the port's own copies of the JAX package's: they
read the port's state-dict names and OIHW weights and give the JAX
layout (HWIO kernels, tap-flattened ``(9·Cin, Cout)`` matrices, grouped
convs made dense block-diagonal, each channel shuffle folded into the
next conv's input channels).  ``coarse_head_plain`` is the twin of
``_sample_math`` (the JAX ``impl="xla"``) on that layout.  The kernel K4
(``kernels/coarse_head.py``) keeps its own layout; ``HeadWeights`` packs
the parameters once per layout and device.  Both packs are detached, so
the fused head refuses, under grad, a parameter that requires grad, on
either device.

``coarse_head(..., impl="kernel")`` sends CPU tensors to the twin and
CUDA tensors to K4; ``impl="plain"`` runs the twin on any device (the
counterpart of the JAX ``fast_head_impl="xla"`` measurement control).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from eemflow_tpu_torch.kernels import refuse_grad
from eemflow_tpu_torch.ops.correlation import local_correlation_plain
from eemflow_tpu_torch.ops.pack_cache import PackCache

# fixed per-level weight ordering (the JAX package's _LEVEL_KEYS)
LEVEL_KEYS = (
    "wr", "br", "w1", "b1", "w2", "b2", "w3", "b3",
    "w4", "b4", "w5", "b5", "w6", "b6", "w7", "b7",
)
IMPLS = ("kernel", "plain")


def conv_names(level: int) -> Tuple[str, ...]:
    """State-dict prefixes of one level's convs: rconv, then conv1..conv7."""
    dec = f"decoder_{level}"
    return (f"rconv_{level}.0",) + tuple(f"{dec}.conv{i}.0" for i in range(1, 7)) + (f"{dec}.conv7",)


def _hwio(params: Mapping[str, torch.Tensor], name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(HWIO kernel, bias) of one conv, float32."""
    w = params[f"{name}.weight"].detach().float()
    return w.permute(2, 3, 1, 0), params[f"{name}.bias"].detach().float()


def _tap_flatten(kernel: torch.Tensor) -> torch.Tensor:
    """(3,3,Cin,Cout) HWIO kernel → (9·Cin, Cout), tap-major row-major."""
    kh, kw, cin, cout = kernel.shape
    return kernel.reshape(kh * kw * cin, cout)


def _dense_from_grouped(kernel: torch.Tensor, groups: int, cin: int) -> torch.Tensor:
    """Grouped-conv kernel (3,3,Cin/g,Cout) → dense (3,3,Cin,Cout) with the
    block-diagonal structure made explicit (zeros off the blocks)."""
    kh, kw, cpg, cout = kernel.shape
    opg = cout // groups
    dense = kernel.new_zeros((kh, kw, cin, cout))
    for g in range(groups):
        dense[:, :, g * cpg : (g + 1) * cpg, g * opg : (g + 1) * opg] = kernel[:, :, :, g * opg : (g + 1) * opg]
    return dense


def _fold_shuffle(kernel: torch.Tensor, groups: int) -> torch.Tensor:
    """Fold a preceding channel_shuffle into this conv's input channels:
    conv(shuffle(x)) == conv'(x), where conv' takes input channel j from
    row σ⁻¹(j) = (j % (C/g))·g + j//(C/g)."""
    cin = kernel.shape[2]
    cpg = cin // groups
    j = np.arange(cin)
    sigma_inv = torch.from_numpy((j % cpg) * groups + j // cpg)
    return kernel[:, :, sigma_inv, :]


def decoder_dense_kernels(
    params: Mapping[str, torch.Tensor], prefix: str, groups: int
) -> Tuple[List[torch.Tensor], List[torch.Tensor], Tuple[bool, ...]]:
    """The decoder under ``prefix`` (``decoder_1`` …) → a plain 7-conv
    chain: (HWIO dense kernels, biases, relu flags), grouped convs made
    dense, the shuffles folded into the next conv's input channels, conv7
    linear."""
    k1, b1 = _hwio(params, f"{prefix}.conv1.0")
    mid = b1.shape[0]
    ks, bs = [k1], [b1]
    for i, fold in ((2, False), (3, True), (4, True)):
        k, b = _hwio(params, f"{prefix}.conv{i}.0")
        if groups != 1:
            k = _dense_from_grouped(k, groups, mid)
            if fold:
                k = _fold_shuffle(k, groups)
        ks.append(k)
        bs.append(b)
    k5, b5 = _hwio(params, f"{prefix}.conv5.0")
    if groups != 1:
        k5 = _fold_shuffle(k5, groups)
    k6, b6 = _hwio(params, f"{prefix}.conv6.0")
    k7, b7 = _hwio(params, f"{prefix}.conv7")
    return ks + [k5, k6, k7], bs + [b5, b6, b7], (True,) * 6 + (False,)


def pack_coarse_head_weights(
    params: Mapping[str, torch.Tensor], groups: int
) -> Tuple[List[Dict[str, torch.Tensor]], torch.Tensor, torch.Tensor]:
    """EEMFlow's rconv/decoder/out_conv parameters (the port's state-dict
    names) in matmul form: (per-level dicts keyed by ``LEVEL_KEYS``, wout
    (6, 2), bout (1, 2)) — the JAX package's layout."""
    levels = []
    for lvl in (1, 2, 3):
        wr, br = _hwio(params, f"rconv_{lvl}.0")
        d = {"wr": _tap_flatten(wr), "br": br.reshape(1, -1)}
        ks, bs, _ = decoder_dense_kernels(params, f"decoder_{lvl}", groups)
        for i, (k, b) in enumerate(zip(ks, bs), start=1):
            d[f"w{i}"], d[f"b{i}"] = _tap_flatten(k), b.reshape(1, -1)
        levels.append(d)
    wout = params["out_conv.weight"].detach().float().reshape(2, 6).t().contiguous()
    bout = params["out_conv.bias"].detach().float().reshape(1, 2)
    return levels, wout, bout


def _conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NHWC x, tap-flattened w (9·Cin, Cout), b (1, Cout) → NHWC, zero pad."""
    cin = x.shape[-1]
    k = w.reshape(3, 3, cin, -1).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), k, b.reshape(-1), padding=1)
    return y.permute(0, 2, 3, 1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _level_flow(f1, f2, wts: Dict[str, torch.Tensor], indices, md) -> torch.Tensor:
    """One coarse level: corr ‖ rconv → decoder → [B, h, w, 2]."""
    cv = local_correlation_plain(f1, f2, md, indices)
    r = _lrelu(_conv3x3(f1, wts["wr"], wts["br"]))
    x = torch.cat([cv, r], dim=-1)
    for i in range(1, 7):
        x = _lrelu(_conv3x3(x, wts[f"w{i}"], wts[f"b{i}"]))
    return _conv3x3(x, wts["w7"], wts["b7"])


def coarse_head_plain(
    f1_levels: Sequence[torch.Tensor],
    f2_levels: Sequence[torch.Tensor],
    levels: Sequence[Dict[str, torch.Tensor]],
    wout: torch.Tensor,
    bout: torch.Tensor,
    indices: Sequence[int],
    max_displacement: int,
) -> torch.Tensor:
    """Plain PyTorch twin of K4 (the JAX ``_sample_math`` over a batch):
    three NHWC feature pairs and the packed weights → [B, h, w, 2]."""
    flows = [
        _level_flow(f1.float(), f2.float(), wts, indices, max_displacement)
        for f1, f2, wts in zip(f1_levels, f2_levels, levels)
    ]
    return torch.cat(flows, dim=-1) @ wout + bout.reshape(-1)


class HeadWeights:
    """One model's coarse-stage parameters, packed once per layout (the
    twin's, the kernel's) and device.  Holds the tensors it was given and
    repacks when one of them changes in place (``PackCache``); a parameter
    replaced by another tensor is not seen: make a new ``HeadWeights``."""

    def __init__(self, params: Mapping[str, torch.Tensor], groups: int):
        keep = ("rconv_", "decoder_", "out_conv.")
        self.params = {k: v for k, v in params.items() if k.startswith(keep)}
        self.groups = groups
        self._packs = PackCache()

    def plain(self, device: torch.device):
        def make():
            levels, wout, bout = pack_coarse_head_weights(self.params, self.groups)
            to = lambda t: t.to(device)
            return [{k: to(v) for k, v in d.items()} for d in levels], to(wout), to(bout)

        return self._packs.get(("plain", torch.device(device)), self.params.values(), make)

    def kernel(self, device: torch.device):
        from eemflow_tpu_torch.kernels.coarse_head import pack_kernel_weights

        return self._packs.get(
            ("kernel", torch.device(device)), self.params.values(),
            lambda: pack_kernel_weights(self.params, self.groups, device),
        )


def coarse_head(
    f1_levels: Sequence[torch.Tensor],
    f2_levels: Sequence[torch.Tensor],
    params: Union[Mapping[str, torch.Tensor], HeadWeights],
    groups: int = 5,
    indices: Sequence[int] = (),
    max_displacement: int = 4,
    impl: str = "kernel",
) -> torch.Tensor:
    """Fused EEMFlow coarse head.  f1_levels/f2_levels: three pooled NHWC
    maps (same h, w; C = 16/32/64).  params: the model's parameters by
    state-dict name, or a ``HeadWeights``.  Returns the pre-upsample flow
    [B, h, w, 2], float32."""
    if impl not in IMPLS:
        raise ValueError(f"coarse_head: impl must be one of {IMPLS}, got {impl!r}")
    hw = params if isinstance(params, HeadWeights) else HeadWeights(params, groups)
    if hw.groups != groups:
        raise ValueError(f"coarse_head: weights packed for groups={hw.groups}, called with {groups}")
    refuse_grad("coarse_head", *hw.params.values())
    indices = tuple(int(i) for i in indices)
    dev = f1_levels[0].device
    if impl == "plain":
        return coarse_head_plain(f1_levels, f2_levels, *hw.plain(dev), indices, max_displacement)
    from eemflow_tpu_torch.kernels.coarse_head import coarse_head_fused

    return coarse_head_fused(f1_levels, f2_levels, hw, indices, max_displacement)
