"""Model registry of the port (counterpart of
``eemflow_tpu/models/registry.py:32-100``): ``eemflow`` and ``eraft``, so
far."""

from __future__ import annotations

import inspect

from eemflow_tpu_torch.models.eemflow import EEMFlow
from eemflow_tpu_torch.models.eraft import ERAFT

MODEL_REGISTRY = {"eemflow": EEMFlow, "eraft": ERAFT}

# reference CLI spellings (train_EEMFlow_HREM.py:30-55) → registry names
ALIASES = {"EEMFlow": "eemflow"}

# parity-safe serving modes per family (same params, same math): EEMFlow's
# siamese pyramid batch; none for ERAFT, as in the JAX registry
FAST_EVAL_KWARGS = {"eemflow": {"siamese_stack": True}}


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
