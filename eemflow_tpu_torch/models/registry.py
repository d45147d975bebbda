"""Model registry of the port (counterpart of
``eemflow_tpu/models/registry.py:32-100``): ``eemflow``, ``eemflow_plus``,
``eraft``, ``raft`` and the GMA line of baselines, ``gma``, ``skflow`` and
``kpaflow``, so far."""

from __future__ import annotations

import inspect

from eemflow_tpu_torch.models.eemflow import EEMFlow
from eemflow_tpu_torch.models.eemflow_plus import EEMFlowPlus
from eemflow_tpu_torch.models.eraft import ERAFT
from eemflow_tpu_torch.models.gma import RAFTGMA
from eemflow_tpu_torch.models.kpaflow import KPAFlow
from eemflow_tpu_torch.models.raft import RAFT
from eemflow_tpu_torch.models.skflow import SKFlow

MODEL_REGISTRY = {
    "eemflow": EEMFlow, "eemflow_plus": EEMFlowPlus, "eraft": ERAFT, "raft": RAFT,
    "gma": RAFTGMA, "skflow": SKFlow, "kpaflow": KPAFlow,
}

# reference CLI spellings (train_EEMFlow_HREM.py:30-55) → registry names, the
# JAX registry's for the models registered here
ALIASES = {"EEMFlow": "eemflow", "GMA": "gma"}

# parity-safe serving modes per family (same params, the same function in
# another summation order), the CLIs' --fast.  The JAX registry's choice
# (siamese_stack) is a TPU verdict; the port's rests on the card.  EEMFlow's
# 720x1280 B=1 forward (golden weights) on an NVIDIA H100 80GB HBM3 at
# 700.00 W, back to back / on the device (chip_smoke.py phase 4, "--fast
# candidate" lines; the run is named beside these numbers in PERF.md §6):
# standard 3.594 / 3.251 ms, siamese_stack 3.631 / 2.548, fast_head +
# fast_pyramid (kernels K4 and K3) 1.416 / 1.236, all three 1.508 / 1.228;
# the fused flow within 3e-8 of the standard one (mean end-point distance
# 4e-9 px).  None for EEMFlow+ and ERAFT, as in JAX: their fused modes are
# not faster on the card back to back.  EEMFlow+'s forward is bound by the
# host's issue: with K3 on the tensor cores its fused modes save device time
# but no candidate beat the standard forward back to back ("--fast candidate
# EEMFlow+" lines, PERF.md §6).
FAST_EVAL_KWARGS = {"eemflow": {"fast_head": True, "fast_pyramid": True}}


def _ctor(name: str):
    name = ALIASES.get(name, name)
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model '{name}'. Available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def get_model(name: str, **kwargs):
    """Build a model by registry name (kwargs go to the constructor)."""
    return _ctor(name)(**kwargs)


def get_eval_model(name: str, **kwargs):
    """Build a model for evaluation, in eval mode.  Unknown kwargs raise a
    clear error naming the model's fields.  RAFT-lineage models get
    ``upsample_all=False`` unless the caller sets it: the convex upsample
    runs once, on the final iterate, whose prediction is the same."""
    ctor = _ctor(name)
    fields = set(inspect.signature(ctor).parameters)
    unsupported = sorted(k for k in kwargs if k not in fields)
    if unsupported:
        raise ValueError(
            f"model '{name}' does not support: {unsupported} (its fields: {sorted(fields)})"
        )
    if "upsample_all" in fields:
        kwargs.setdefault("upsample_all", False)
    return ctor(**kwargs).eval()


def fast_eval_kwargs(name: str) -> dict:
    """Constructor kwargs for every parity-safe serving mode of the family
    (the CLIs' ``--fast``)."""
    return dict(FAST_EVAL_KWARGS.get(ALIASES.get(name, name), {}))
