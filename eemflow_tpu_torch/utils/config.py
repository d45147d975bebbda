"""Config ingestion (the port's own copy of
``eemflow_tpu/utils/config.py:15-59``; reference JSON schema,
``config/a_meshflow.json``).

``model_kwargs_from_config`` forwards every top-level config key that
names a parameter of the port's model constructor, JSON lists becoming
tuples, so ``{"fused_update": true}`` reaches ``ERAFT(fused_update=True)``.
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Dict

from eemflow_tpu_torch.models.registry import _ctor


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def model_kwargs_from_config(model_name: str, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The model hyperparameters a config carries: each top-level key that
    names a parameter of the model's constructor."""
    fields = set(inspect.signature(_ctor(model_name)).parameters)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields}
