"""Training loss (counterpart of ``eemflow_tpu/train/loss.py``; reference
``train_mvsec.py:201-227`` ``sequence_loss``).

γ-weighted L1 over the prediction sequence, masked by validity and a
MAX_FLOW = 400 magnitude cut-off (``train_mvsec.py:41``); each prediction's
term is the mean over all elements, masked ones included (torch
``.mean()`` semantics).  The metrics (EPE and the 1/3/5-px rates) are taken
on the last prediction over the valid pixels.  Masking uses sums, not
boolean indexing, so nothing waits on the host.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch

MAX_FLOW = 400.0


def sequence_loss(
    flow_preds: Union[torch.Tensor, List[torch.Tensor]],
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 0.8,
    max_flow: float = MAX_FLOW,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds: [N, B, H, W, 2] stacked or a list of [B, H, W, 2];
    flow_gt: [B, H, W, 2]; valid: [B, H, W]."""
    if isinstance(flow_preds, (list, tuple)):
        flow_preds = torch.stack(list(flow_preds), dim=0)
    n_predictions = flow_preds.shape[0]

    mag = torch.sqrt(torch.sum(flow_gt**2, dim=-1))
    v = (valid >= 0.5) & (mag < max_flow)
    vf = v.to(flow_preds.dtype)[None, ..., None]  # [1, B, H, W, 1]

    weights = gamma ** torch.arange(n_predictions - 1, -1, -1, dtype=flow_preds.dtype,
                                    device=flow_preds.device)
    per_pred = torch.mean(torch.abs(flow_preds - flow_gt[None]) * vf, dim=(1, 2, 3, 4))
    flow_loss = torch.sum(weights * per_pred)

    epe = torch.sqrt(torch.sum((flow_preds[-1] - flow_gt) ** 2, dim=-1))
    n_valid = torch.clamp(torch.sum(v), min=1)
    vF = v.to(epe.dtype)

    def rate(thr):
        return torch.sum((epe < thr) * vF) / n_valid

    metrics = {
        "epe": torch.sum(epe * vF) / n_valid,
        "1px": rate(1.0),
        "3px": rate(3.0),
        "5px": rate(5.0),
    }
    return flow_loss, metrics
