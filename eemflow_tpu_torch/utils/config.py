"""Config ingestion and the run directory (the port's own copy of
``eemflow_tpu/utils/config.py:15-72``; reference JSON schema,
``config/a_meshflow.json``; the run dir layout mirrors the reference's
``helper_functions.create_save_path`` and its config snapshot,
``train_EEMFlow_HREM.py:68-76``).

``model_kwargs_from_config`` forwards every top-level config key that
names a parameter of the port's model constructor, JSON lists becoming
tuples, so ``{"fused_update": true}`` reaches ``ERAFT(fused_update=True)``;
a key that the registry's preset binds (``pwcnet_occ_bi``'s ``bi`` and
``occ``) is left to the preset, as in JAX: the name defines the variant.
"""

from __future__ import annotations

import inspect
import json
import os
from typing import Any, Dict, Optional

from eemflow_tpu_torch.models.registry import _ctor


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def model_kwargs_from_config(model_name: str, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The model hyperparameters a config carries: each top-level key that
    names a parameter of the model's constructor and is not bound by its
    registry preset."""
    ctor = _ctor(model_name)
    fields = set(inspect.signature(ctor).parameters) - set(getattr(ctor, "keywords", {}))
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields}


def create_save_path(save_dir: str, name: str, lr: Optional[float] = None,
                     wdecay: Optional[float] = None) -> str:
    """``{save_dir}/{name}`` (``{name}_lr{lr}_wd{wdecay}`` when ``lr`` is
    given), created if missing."""
    sub = name if lr is None else f"{name}_lr{lr}_wd{wdecay}"
    path = os.path.join(save_dir, sub)
    os.makedirs(path, exist_ok=True)
    return path


def snapshot_config(cfg: Dict[str, Any], save_path: str) -> None:
    """Write the run's config to ``{save_path}/config.json``."""
    with open(os.path.join(save_path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
