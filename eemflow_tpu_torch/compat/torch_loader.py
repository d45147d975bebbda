"""Checkpoint loading (own copy of ``eemflow_tpu/compat/torch_loader.py:
25-47, 413-433``).

The reference wraps weights under ``state_dict`` (or ``model`` for the
upstream E-RAFT releases) and saves them from ``DataParallel``, so every
key carries a ``module.`` prefix; the port's own training checkpoints
(``train/checkpoint.py``, ``epoch_N.pt``) keep them under ``params``.
The port's modules use the reference's attribute names and NCHW layout,
so after unwrapping and stripping, and dropping the keys a family's
forward never reads (EEMFlow+'s ``EEMFLOW_PLUS_DROP``, GMA's and SKFlow's
relative position tables ``GMA_DROP``, KPAFlow's ``zero`` buffer), the dict loads
with ``load_state_dict`` strictly.  RAFT takes ERAFT's layout, as the JAX
``convert_for_model`` gives every model it does not list.  ``load_model_checkpoint`` is that
path, shared by the CLIs (``test_hrem``, ``serve``, ``time_eval``).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def strip_module_prefix(state_dict: Dict[str, object]) -> Dict[str, object]:
    out = {}
    for k, v in state_dict.items():
        out[k[len("module.") :] if k.startswith("module.") else k] = v
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth(.tar) file to a flat {key: np.ndarray} dict (CPU)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt
    if isinstance(ckpt, dict):
        for wrapper in ("state_dict", "model", "params"):
            inner = ckpt.get(wrapper)
            if isinstance(inner, dict):
                sd = inner
                break
    sd = strip_module_prefix(sd)
    return {
        k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
        for k, v in sd.items()
    }


def to_state_dict(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{key: np.ndarray} → {key: torch.Tensor} for ``load_state_dict``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}


CHECKPOINT_SUFFIXES = (".pth", ".pth.tar", ".pt")


def drop_prefixes(model_name: str) -> tuple:
    """Checkpoint key prefixes with no live forward path in the family (the
    JAX ``_model_converters``' drop lists)."""
    from eemflow_tpu_torch.models.registry import ALIASES

    model_name = ALIASES.get(model_name, model_name)
    if model_name == "eemflow_plus":
        from eemflow_tpu_torch.models.eemflow_plus import EEMFLOW_PLUS_DROP

        return EEMFLOW_PLUS_DROP
    if model_name in ("gma", "skflow"):
        from eemflow_tpu_torch.models.gma import GMA_DROP

        return GMA_DROP
    if model_name == "kpaflow":
        from eemflow_tpu_torch.models.kpaflow import KPAFLOW_DROP

        return KPAFLOW_DROP
    return ()


def load_model_checkpoint(model: torch.nn.Module, path: str, model_name: str,
                          log: Callable[[str], None] = print) -> None:
    """Load a released ``.pth``/``.pth.tar`` or the port's ``epoch_N.pt``
    into ``model``, strictly.  The family's dead keys are dropped; a
    checkpoint's correlation ``index`` buffer gives way to the model's own,
    as the JAX CLIs drop it, with one line when the two differ."""
    if not path.endswith(CHECKPOINT_SUFFIXES):
        raise ValueError(f"checkpoint must be a PyTorch {'/'.join(CHECKPOINT_SUFFIXES)} file: {path}")
    drop = drop_prefixes(model_name)
    arrays = {k: v for k, v in load_torch_checkpoint(path).items() if not (drop and k.startswith(drop))}
    sd = to_state_dict(arrays)
    own = model.state_dict().get("index")
    if "index" in sd:
        index = sd.pop("index")
        if own is not None and not torch.equal(index, own.cpu()):
            log(f"checkpoint correlation index ({index.numel()} entries) differs from the "
                f"model's corr_indices ({own.numel()}); using the model's")
    if own is not None:
        sd["index"] = own
    model.load_state_dict(sd)
