"""Carry JAX EEMFlow, EEMFlow+, ERAFT, RAFT, GMA, SKFlow and KPAFlow
variables across to the port.

The inverse of ``torch_state_dict_to_flax`` with ``eemflow_alias``
(``eemflow_tpu/compat/torch_loader.py:57-133``): a nested dict of numpy
arrays (flax ``params``, optionally wrapped as ``{"params": ...}``)
becomes the port's flat ``state_dict``:

  * conv ``kernel`` [kh, kw, I/g, O] (HWIO) → ``weight`` [O, I/g, kh, kw];
  * ``bias`` stays;
  * the JAX ``pyramid`` submodule is dropped from the path
    (``pyramid.pconv1_1.0`` → ``pconv1_1.0``): the reference and the port
    keep the pyramid convs at the model's top level.

The correlation ``index`` buffer is not a JAX param; it is added from
``indices`` so that the result loads strictly.  The RAFT lineage also
carries flax's ``batch_stats`` into the BatchNorm buffers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from eemflow_tpu_torch.models.eemflow import INDEX_53


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def eemflow_state_dict_from_jax(
    params: Mapping, indices: Sequence[int] = INDEX_53
) -> Dict[str, torch.Tensor]:
    if "params" in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        if path[0] == "pyramid":
            path = path[1:]
        a = np.array(leaf, np.float32)  # a writable copy
        if path[-1] == "kernel":
            if a.ndim != 4:
                raise ValueError(f"{'.'.join(path)}: expected an HWIO kernel, got {a.shape}")
            path = path[:-1] + ("weight",)
            a = a.transpose(3, 2, 0, 1)
        elif path[-1] != "bias":
            raise ValueError(f"unexpected EEMFlow param {'.'.join(path)}")
        sd[".".join(path)] = torch.from_numpy(np.ascontiguousarray(a))
    sd["index"] = torch.tensor(list(indices), dtype=torch.long)
    return sd


def _raft_torch_path(path) -> str:
    """A flax module path of a JAX RAFT-line model → the port's attribute
    path (the inverse of ``eraft_alias`` and ``digit_merge_alias``): every
    ``name_N`` → ``name.N`` (``layer1_0`` → ``layer1.0``, ``downsample_0``
    → ``downsample.0``, ``mask_2`` → ``mask.2``, SKFlow's ``conv_list_1``
    and ``ffn1_0``, KPAFlow's ``C_cor_2``)."""
    out = []
    for p in path:
        head, _, idx = p.rpartition("_")
        out += [head, idx] if head and idx.isdigit() else [p]
    return ".".join(out)


def eraft_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables (``{"params": ..., "batch_stats": ...}``) of a RAFT-line
    model (ERAFT, RAFT, GMA, SKFlow, KPAFlow) → the port's ``state_dict``:
    HWIO kernels → OIHW ``weight``, norm ``scale`` → ``weight``,
    ``batch_stats`` mean/var → ``running_mean``/``running_var`` with
    ``num_batches_tracked`` 0, the attention gates (``gamma``, ``w_prelu``)
    as they are; a strided block's ``norm3`` is written under both of its
    torch spellings, ``norm3`` and ``downsample.1``."""
    sd: Dict[str, torch.Tensor] = {}
    leaves = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var", "gamma": "gamma", "w_prelu": "w_prelu"}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            if path[-1] not in leaves:
                raise ValueError(f"unexpected {coll} leaf {'/'.join(path)}")
            a = np.array(leaf, np.float32)
            if path[-1] in ("gamma", "w_prelu"):
                sd[".".join(filter(None, (_raft_torch_path(path[:-1]), path[-1])))] = torch.from_numpy(a)
                continue
            if path[-1] == "kernel":
                if a.ndim != 4:
                    raise ValueError(f"{'/'.join(path)}: expected an HWIO kernel, got {a.shape}")
                a = a.transpose(3, 2, 0, 1)
            mod = _raft_torch_path(path[:-1])
            names = [mod]
            if path[-2] == "norm3":
                names.append(mod[: -len("norm3")] + "downsample.1")
            for m in names:
                sd[f"{m}.{leaves[path[-1]]}"] = torch.from_numpy(np.ascontiguousarray(a))
                if path[-1] == "mean":
                    sd[f"{m}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


# the other RAFT-line models' JAX modules are named as ERAFT's where they
# share a module, and their own as the reference's (digits after "_")
raft_state_dict_from_jax = gma_state_dict_from_jax = eraft_state_dict_from_jax
skflow_state_dict_from_jax = kpaflow_state_dict_from_jax = eraft_state_dict_from_jax


def _eemflow_plus_torch_path(path) -> str:
    """A flax module path of the JAX EEMFlow+ → the port's (the inverse of
    ``eemflow_plus_alias``): ``pyramid`` dropped, ``conv_1x1_{l}`` →
    ``conv_1x1.{l}``, ``conv_last_0`` → ``conv_last.0``."""
    out = []
    for p in path:
        if p == "pyramid":
            continue
        if p.startswith("conv_1x1_"):
            out += ["conv_1x1", p[len("conv_1x1_"):]]
        elif p == "conv_last_0":
            out += ["conv_last", "0"]
        else:
            out.append(p)
    return ".".join(out)


def eemflow_plus_state_dict_from_jax(
    params: Mapping, indices: Sequence[int] = INDEX_53
) -> Dict[str, torch.Tensor]:
    """JAX EEMFlow+ params → the port's ``state_dict``: HWIO conv kernels
    → OIHW ``weight``, the CFP's ``Dense`` kernel [in, out] → ``Linear``
    ``weight`` [out, in], biases as they are, and the ``index`` buffer."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        a = np.array(leaf, np.float32)
        if path[-1] == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{'.'.join(path)}: unexpected kernel shape {a.shape}")
            leaf_name = "weight"
        elif path[-1] == "bias":
            leaf_name = "bias"
        else:
            raise ValueError(f"unexpected EEMFlow+ param {'.'.join(path)}")
        sd[f"{_eemflow_plus_torch_path(path[:-1])}.{leaf_name}"] = torch.from_numpy(np.ascontiguousarray(a))
    sd["index"] = torch.tensor(list(indices), dtype=torch.long)
    return sd
