"""Checkpoints: parameters, optimizer, schedule and step (counterpart of
``eemflow_tpu/train/checkpoint.py``, which uses orbax).

One ``torch.save`` file per epoch, ``{directory}/epoch_{n}.pt``, the three
newest kept.  Unlike the reference's resume (parameters and epoch only,
``train_EEMFlow_HREM.py:78-87, 127-130``), restoring continues the AdamW
moments and the OneCycle schedule exactly where they stopped.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

MAX_TO_KEEP = 3
_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def _epochs(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def checkpoint_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"epoch_{epoch}.pt")


def save_checkpoint(directory: str, state, epoch: int) -> None:
    """Write ``state`` (a ``train.trainer.TrainState``) as epoch ``epoch``
    and drop all but the ``MAX_TO_KEEP`` newest epochs."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, epoch)
    tmp = path + ".tmp"
    torch.save({
        "step": state.step,
        "params": state.model.state_dict(),
        "optimizer": state.opt.state_dict(),
    }, tmp)
    os.replace(tmp, path)
    for old in _epochs(directory)[:-MAX_TO_KEEP]:
        os.remove(checkpoint_path(directory, old))


def restore_checkpoint(directory: str, state, epoch: Optional[int] = None):
    """Load epoch ``epoch`` (the newest when None) into ``state`` in place.
    Returns (state, epoch), or (state, 0) when there is nothing to restore."""
    if not os.path.isdir(directory):
        return state, 0
    epochs = _epochs(directory)
    if epoch is None:
        if not epochs:
            return state, 0
        epoch = epochs[-1]
    path = checkpoint_path(directory, epoch)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint of epoch {epoch} in {directory} (have {epochs})")
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["params"])
    state.opt.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state, epoch
