"""Local (windowed) correlation, the op for which the upstream reference
ships a CUDA extension (``SpatialCorrelationSampler``).

Semantics (counterpart of ``eemflow_tpu/ops/correlation.py:26-62``): for
the displacement (dy, dx) ∈ [-md, md]² at channel
``(dy+md)·(2md+1) + (dx+md)`` (dy-major),

    out[b, y, x, j] = (1/C) · Σ_c x[b, y, x, c] · y[b, y+dy, x+dx, c]

with zeros outside the frame; ``indices`` selects the displacements to
compute (EEMFlow's 53-channel diamond).  Inputs and output are NHWC, in
float32 or bf16 (summed in float32, rounded once).

``local_correlation`` (one level) and ``local_correlation_levels`` (up to
three, one launch) send CPU tensors to the plain twin below and CUDA
tensors to the hand-written kernel ``kernels/local_corr.py`` (K2); there
is no fallback from the card to the twin.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def selected_displacements(max_displacement: int, indices: Optional[Sequence[int]]):
    k = 2 * max_displacement + 1
    if indices is None:
        return tuple(range(k * k))
    wanted = tuple(int(i) for i in indices)
    if any(not 0 <= i < k * k for i in wanted):
        raise ValueError(f"correlation indices must lie in [0, {k * k})")
    return wanted


def local_correlation_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    max_displacement: int = 4,
    indices: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Plain PyTorch twin of K2: NHWC x, y [B, H, W, C] → [B, H, W, K].
    Inputs below float32 (bf16) are correlated in float32 and the result
    rounded once to their dtype, the kernel's definition."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return local_correlation_plain(x.float(), y.float(), max_displacement, indices).to(x.dtype)
    B, H, W, C = x.shape
    md = max_displacement
    k = 2 * md + 1
    ypad = F.pad(y, (0, 0, md, md, md, md))
    inv_c = torch.tensor(1.0 / C, dtype=x.dtype)
    outs = []
    for ch in selected_displacements(md, indices):
        dy, dx = ch // k, ch % k
        shifted = ypad[:, dy : dy + H, dx : dx + W, :]
        outs.append((x * shifted).sum(-1) * inv_c)
    return torch.stack(outs, dim=-1)


_index_tensors: dict = {}


def _index_tensor(wanted: tuple, device: torch.device) -> torch.Tensor:
    """``wanted`` as an int64 tensor on ``device``, made once: a fresh copy
    to the card each call would wait for the card."""
    key = (wanted, device)
    t = _index_tensors.get(key)
    if t is None:
        with torch.inference_mode(False):  # a normal tensor, which training may save
            t = _index_tensors[key] = torch.tensor(wanted, device=device)
    return t


def local_correlation_windowed(
    x: torch.Tensor,
    y: torch.Tensor,
    max_displacement: int = 4,
    indices: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """``local_correlation_plain``'s function in another formulation: each
    position's window of ``y`` gathered once (``unfold``), the selected
    displacements taken, and one batched product with ``x`` — a dozen
    tensor ops under autograd where the plain version takes four a
    displacement.  K2's backward differentiates it."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return local_correlation_windowed(x.float(), y.float(), max_displacement, indices).to(x.dtype)
    B, H, W, C = x.shape
    md = max_displacement
    k = 2 * md + 1
    # [B, H, W, C, k (dy), k (dx)] → dy-major displacement channels
    win = F.pad(y, (0, 0, md, md, md, md)).unfold(1, k, 1).unfold(2, k, 1).reshape(B, H, W, C, k * k)
    wanted = selected_displacements(md, indices)
    if wanted != tuple(range(k * k)):
        win = win.index_select(-1, _index_tensor(wanted, x.device))
    inv_c = torch.tensor(1.0 / C, dtype=x.dtype)
    return torch.einsum("bhwc,bhwck->bhwk", x, win) * inv_c


def local_correlation(
    x: torch.Tensor,
    y: torch.Tensor,
    max_displacement: int = 4,
    indices: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """NHWC local correlation: the K2 kernel on the card, the twin on the CPU."""
    from eemflow_tpu_torch.kernels.local_corr import local_corr

    return local_corr(x, y, max_displacement, indices)


def local_correlation_levels(
    pairs: Sequence[tuple],
    max_displacement: int = 4,
    indices: Optional[Sequence[int]] = None,
) -> list:
    """NHWC local correlation of up to three (x, y) levels: one K2 launch
    on the card (inputs read through their strides), the twin per level on
    the CPU."""
    from eemflow_tpu_torch.kernels.local_corr import local_corr_levels

    return local_corr_levels(pairs, max_displacement, indices)
