"""Fused stride-1 conv chain + average pool — the EEMFlow pyramid body
(counterpart of ``eemflow_tpu/ops/pallas/fused_convs.py:39-47, 176-218``).

A chain of 3×3 stride-1 pad-1 convs, each with its own LeakyReLU(0.1)
flag and an optional dense concat (conv i's successor reads
``[out_i, in_i]``, the FlowEstimatorDense pattern), then an optional
average pool by ``pool``.  The port's own arguments ``groups`` and
``shuffle`` make conv i grouped and shuffle its outputs (EEMFlow+'s
decoders, ``models/eemflow.Decoder``); the JAX function takes the same
decoders as dense kernels with the shuffles folded in
(``ops/coarse_head.decoder_dense_kernels``).  Zero padding is exact at every conv's input: a
conv's input is zero outside the image, not the previous conv evaluated
past the border.  ``compute_dtype=torch.bfloat16`` rounds both conv
operands to bf16 and accumulates in float32; biases stay float32.

``fused_convs_pool`` is the public NHWC function of the JAX package; the
port's modules, which hold NCHW, call ``kernels.fused_convs.fused_convs``
(any strides) directly.  Both send a CPU tensor to the plain twin below
and a CUDA tensor to the hand-written kernel (K3).  The
TPU tiling knobs (``tile_rows``, ``variant``, ``interpret``) choose how a
TPU runs the chain, not what it computes, and are not carried over.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from eemflow_tpu_torch.models.layers import channel_shuffle


def chain_channels(
    c_in: int, weights: Sequence[torch.Tensor], concat: Sequence[bool],
    groups: Optional[Sequence[int]] = None,
) -> List[int]:
    """Input channels of every conv and the chain's output channels,
    checked against the OIHW ``weights`` ([Cout, Cin/g, 3, 3] for a conv of
    ``groups`` g): ``[Cin_0, Cin_1, …, C_out]``."""
    if len(weights) < 1:
        raise ValueError("fused_convs_pool: at least one conv")
    groups = groups or (1,) * len(weights)
    chain = [c_in]
    for i, (w, g) in enumerate(zip(weights, groups)):
        if chain[i] % g or w.shape[0] % g or tuple(w.shape[1:]) != (chain[i] // g, 3, 3):
            raise ValueError(
                f"fused_convs_pool: conv {i} weight must be [Cout, {chain[i]}/{g}, 3, 3] with Cout a "
                f"multiple of {g}, got {tuple(w.shape)}"
            )
        chain.append(w.shape[0] + (chain[i] if concat[i] else 0))
    return chain


def _flags(flags: Optional[Sequence[bool]], n: int, default: bool, name: str) -> Tuple[bool, ...]:
    out = tuple(bool(f) for f in flags) if flags is not None else (default,) * n
    if len(out) != n:
        raise ValueError(f"fused_convs_pool: {name} needs {n} flags, got {len(out)}")
    return out


def _counts(counts: Optional[Sequence[int]], n: int, name: str) -> Tuple[int, ...]:
    out = tuple(int(c) for c in counts) if counts is not None else (1,) * n
    if len(out) != n or min(out) < 1:
        raise ValueError(f"fused_convs_pool: {name} needs {n} counts of at least 1, got {counts}")
    return out


def check_args(x_shape, weights, biases, pool, emit_full, relus, concat, groups=None, shuffle=None):
    """The JAX function's checks, and those of the port's ``groups`` and
    ``shuffle``; returns (relus, concat, groups, shuffle, chain)."""
    n = len(weights)
    relus = _flags(relus, n, True, "relus")
    concat = _flags(concat, n, False, "concat")
    groups = _counts(groups, n, "groups")
    shuffle = _counts(shuffle, n, "shuffle")
    if len(biases) != n:
        raise ValueError(f"fused_convs_pool: {n} weights but {len(biases)} biases")
    B, C, H, W = x_shape
    chain = chain_channels(C, weights, concat, groups)
    for i, (w, b) in enumerate(zip(weights, biases)):
        if tuple(b.shape) != (w.shape[0],):
            raise ValueError(f"fused_convs_pool: conv {i} bias must be [{w.shape[0]}]")
        if w.shape[0] % shuffle[i]:
            raise ValueError(f"fused_convs_pool: conv {i}'s {w.shape[0]} outputs cannot be shuffled by {shuffle[i]}")
    if not emit_full and pool is None:
        raise ValueError("fused_convs_pool: nothing to return (emit_full=False and pool=None)")
    if pool is not None and (pool < 1 or H % pool or W % pool):
        raise ValueError(f"fused_convs_pool: H={H} and W={W} must be multiples of pool={pool}")
    return relus, concat, groups, shuffle, chain


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)


def fused_convs_pool_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    pool: Optional[int],
    compute_dtype: torch.dtype = torch.float32,
    emit_full: bool = True,
    relus: Optional[Sequence[bool]] = None,
    concat: Optional[Sequence[bool]] = None,
    groups: Optional[Sequence[int]] = None,
    shuffle: Optional[Sequence[int]] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain PyTorch twin of K3.  x: [B, C, H, W] float32 (any strides);
    weights OIHW ([Cout, Cin/g, 3, 3] for a conv of ``groups`` g; the JAX
    function takes dense kernels only); ``shuffle[i]`` > 1 shuffles conv
    i's output channels (after its LeakyReLU, before its concat).  Returns
    (full [B, C_out, H, W] or None, pooled [B, C_out, H/pool, W/pool] or
    None), float32."""
    relus, concat, groups, shuffle, _ = check_args(tuple(x.shape), weights, biases, pool, emit_full, relus,
                                                   concat, groups, shuffle)
    y = x.float()
    for w, b, relu, cat, g, sh in zip(weights, biases, relus, concat, groups, shuffle):
        out = F.conv2d(_round(y, compute_dtype), _round(w.float(), compute_dtype), b.float(), padding=1, groups=g)
        if relu:
            out = F.leaky_relu(out, 0.1)
        if sh > 1:
            out = channel_shuffle(out, sh)
        y = torch.cat([out, y], dim=1) if cat else out
    pooled = F.avg_pool2d(y, pool) if pool is not None else None
    return (y if emit_full else None), pooled


def fused_convs_pool(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    pool: Optional[int],
    compute_dtype: torch.dtype = torch.float32,
    emit_full: bool = True,
    relus: Optional[Sequence[bool]] = None,
    concat: Optional[Sequence[bool]] = None,
    groups: Optional[Sequence[int]] = None,
    shuffle: Optional[Sequence[int]] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """NHWC x [B, H, W, C]; OIHW weights (``Cin_{i+1} = Cout_i``, plus
    ``Cin_i`` where ``concat[i]``); ``groups`` and ``shuffle`` as the plain
    twin takes them.  Returns (full [B, H, W, C_out] or None, pooled [B,
    H/pool, W/pool, C_out] or None), float32; both are NHWC views of NCHW
    results."""
    from eemflow_tpu_torch.kernels.fused_convs import fused_convs

    full, pooled = fused_convs(
        x.permute(0, 3, 1, 2), weights, biases, pool, compute_dtype, emit_full, relus, concat,
        groups=groups, shuffle=shuffle,
    )
    nhwc = lambda t: None if t is None else t.permute(0, 2, 3, 1)
    return nhwc(full), nhwc(pooled)
