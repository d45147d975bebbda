"""Per-model-family input and loss adapters (counterpart of
``eemflow_tpu/train/adapters.py:56-75, 229-315``), reduced to the family
the port trains.

``two_volume`` is the reference's ``TrainRaftEvents`` contract
(``train_mvsec.py:375-386``, the HREM entry path): ``model(ev_old,
ev_new)``, the γ-weighted sequence loss; the port trains EEMFlow,
EEMFlow+, ERAFT, RAFT, GMA, SKFlow, KPAFlow, GMFlow, FlowFormer and the
IRR-PWC and FlowNet line through it.  The JAX package's other families
(single volume, raw segments, event + image, the UNet, dense-context and
MIMO-UNet reconstruction losses, GMFlowNet's matching loss) wait for their
models (``ROADMAP.md`` section 1 item 7); asking for one raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from eemflow_tpu_torch.models.registry import ALIASES
from eemflow_tpu_torch.train.loss import sequence_loss


class Family:
    """The ``two_volume`` contract."""

    name = "two_volume"

    def model_args(self, batch: Dict[str, torch.Tensor]) -> Tuple:
        """Positional model inputs drawn from the batch."""
        return (batch["event_volume_old"], batch["event_volume_new"])

    def compute_loss(self, outputs, batch, gamma: float = 0.8):
        """(maps, preds) → (loss, metrics)."""
        _, preds = outputs
        return sequence_loss(preds, batch["flow"], batch["valid"], gamma)

    def flow_est(self, outputs) -> torch.Tensor:
        """The final flow prediction (reference ``flow_list[-1]``)."""
        _, preds = outputs
        return preds[-1]


FAMILIES: Dict[str, Family] = {f.name: f for f in [Family()]}

# model registry name → family, for the models the port trains
MODEL_FAMILY: Dict[str, str] = {
    "eemflow": "two_volume", "eemflow_plus": "two_volume", "eraft": "two_volume", "raft": "two_volume",
    "gma": "two_volume", "skflow": "two_volume", "kpaflow": "two_volume", "gmflow": "two_volume",
    "flowformer": "two_volume",
    # the IRR-PWC and FlowNet line (reference model/IRRPWC/*.py)
    "irrpwc": "two_volume", "irrpwc_occ": "two_volume",
    "pwcnet": "two_volume", "pwcnet_bi": "two_volume", "pwcnet_occ": "two_volume", "pwcnet_occ_bi": "two_volume",
    "pwcnet_irr_bi": "two_volume", "pwcnet_irr_occ": "two_volume", "pwcnet_irr_occ_bi": "two_volume",
    "flownet1s": "two_volume", "flownet1s_irr": "two_volume", "flownet1s_irr_bi": "two_volume",
    "flownet1s_irr_occ": "two_volume", "flownet1s_irr_occ_bi": "two_volume", "irr_flownet": "two_volume",
}


def get_family(name_or_family) -> Family:
    """Resolve a family by family name, model registry name (reference CLI
    spellings accepted), or instance."""
    if isinstance(name_or_family, Family):
        return name_or_family
    if name_or_family in FAMILIES:
        return FAMILIES[name_or_family]
    name = ALIASES.get(name_or_family, name_or_family)
    if name in MODEL_FAMILY:
        return FAMILIES[MODEL_FAMILY[name]]
    raise KeyError(
        f"model or family '{name_or_family}' is not ported yet (the port trains {sorted(MODEL_FAMILY)} as "
        f"'two_volume'): the JAX package's other families wait for their models (ROADMAP.md section 1 item 7)"
    )
