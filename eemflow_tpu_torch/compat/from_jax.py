"""Carry JAX EEMFlow, EEMFlow+, ERAFT, RAFT, GMA, SKFlow, KPAFlow, GMFlow,
FlowFormer, IRR-PWC/PWC-Net and FlowNet1S/IRR-FlowNet variables across to
the port.

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


def _transformer_torch_path(path) -> str:
    """A flax module path of the JAX GMFlow or FlowFormer → the port's (the
    inverse of ``gmflow_alias`` and ``flowformer_alias``): every ``name_N``
    → ``name.N``, the twins blocks' ``mlp_fc1``/``mlp_fc2`` → ``mlp.fc1``/
    ``mlp.fc2``, and FlowFormer's ``decoder_layer_cross_attend`` with its
    standalone ``_k``/``_v`` projections → ``decoder_layer.cross_attend``
    (``.k``/``.v``)."""
    out = []
    for p in path:
        if p.startswith("decoder_layer_cross_attend"):
            out += ["decoder_layer", "cross_attend"] + ([p[-1]] if p.endswith(("_k", "_v")) else [])
        elif p.startswith("mlp_fc"):
            out += ["mlp", p[len("mlp_"):]]
        else:
            out.append(_raft_torch_path((p,)))
    return ".".join(out)


def transformer_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX GMFlow or FlowFormer params → the port's ``state_dict``: conv
    kernels (HWIO, ``TridentConv``'s ``kernel`` too) → OIHW ``weight``,
    ``Dense`` kernels [in, out] → ``Linear`` ``weight`` [out, in],
    ``LayerNorm`` ``scale`` → ``weight``, biases, the GMA gate ``gamma`` and
    FlowFormer's ``latent_tokens`` as they are."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        a = np.array(leaf, np.float32)
        name = path[-1]
        if name == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{'/'.join(path)}: unexpected kernel shape {a.shape}")
            name = "weight"
        elif name == "scale":
            name = "weight"
        elif name not in ("bias", "gamma", "latent_tokens"):
            raise ValueError(f"unexpected param {'/'.join(path)}")
        sd[f"{_transformer_torch_path(path[:-1])}.{name}".lstrip(".")] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


gmflow_state_dict_from_jax = flowformer_state_dict_from_jax = transformer_state_dict_from_jax


# the JAX OccUpsampleNetwork wraps each of these ConvRelus as ``<name>_0/0``
# where the reference's module is ``<name>.0`` (irr_modules.py:30-57)
_OCC_UPSAMPLE_CONVS = {"init_conv_0": "init_conv", "res_end_conv_0": "res_end_conv", "out_convs_0": "out_convs"}


def _split_indices(p: str) -> list:
    """``convs_0_1`` → ``convs.0.1``, ``conv_last_0`` → ``conv_last.0``:
    every trailing ``_N`` a ``ModuleList``/``Sequential`` index."""
    out = []
    while True:
        head, _, idx = p.rpartition("_")
        if not (head and idx.isdigit()):
            return [p] + out[::-1]
        out.append(idx)
        p = head


def _pwc_torch_path(path) -> list:
    """A flax module path of the JAX IRR-PWC line → the port's (the
    reference's names, the inverse of ``irrpwc_alias``): indices split off
    (``feature_pyramid_extractor/convs_0_1/0`` →
    ``feature_pyramid_extractor.convs.0.1.0``, ``flow_estimators_2`` →
    ``flow_estimators.2``, ``convs_6_0`` → ``convs.6.0``), save for the
    per-level reducers ``conv_1x1_fine_{i}``, which keep their names, and
    the occlusion upsampler's doubly wrapped convs."""
    out = []
    for p in path:
        if p.startswith("conv_1x1_fine_"):
            out.append(p)
        elif p in _OCC_UPSAMPLE_CONVS and out[-1:] == ["occ_shuffle_upsample"]:
            out.append(_OCC_UPSAMPLE_CONVS[p])
        else:
            out += _split_indices(p)
    return out


def _conv_leaf(path, a: np.ndarray, transposed: bool = False):
    """(port leaf name, array) of a conv's ``kernel`` (HWIO → OIHW; a
    ``Deconv``'s [kh, kw, Cin, Cout] → torch's [Cin, Cout, kh, kw], no flip)
    or ``bias``."""
    if path[-1] == "bias":
        return "bias", a
    if path[-1] != "kernel" or a.ndim != 4:
        raise ValueError(f"unexpected param {'/'.join(path)} {a.shape}")
    return "weight", a.transpose((2, 3, 0, 1) if transposed else (3, 2, 0, 1))


def irrpwc_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``PWCNet``, ``IRRPWCOcc`` or ``PWCFamilyNet`` params (any flags)
    → the port's ``state_dict`` of the same model."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        name, a = _conv_leaf(path, np.array(leaf, np.float32))
        sd[".".join(_pwc_torch_path(path[:-1]) + [name])] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def _flownet_torch_path(path, plain: bool) -> list:
    """A flax module path of the JAX FlowNet line → the port's (the inverse
    of ``flownet1s_alias``): ``conv1_0`` → ``_conv1.0`` (under
    ``_flownets`` in the plain net), ``flownets/conv4_1_0`` →
    ``_flownets._conv4_1.0``, ``flownets/flow_decoder/deconv_flow5/0`` →
    ``_flownets._deconv5.0``, ``.../predict_flow6`` →
    ``_flownets._predict_flow6``, ``occ_decoder/deconv_occ5/0`` →
    ``_flownets._deconv_occ5.0``; IRR-FlowNet's refinement and occlusion
    upsampler as in the IRR-PWC line."""
    head = path[0]
    if head in ("refine_flow", "refine_occ", "occ_shuffle_upsample"):
        return _pwc_torch_path(path)
    if head in ("conv1_0", "conv2_0", "conv3_0"):
        return (["_flownets"] if plain else []) + [f"_{head[:-2]}", "0"]
    if head != "flownets":
        raise ValueError(f"unexpected FlowNet module {'/'.join(path)}")
    rest = path[1:]
    if rest[0] in ("flow_decoder", "occ_decoder"):
        mod = rest[1].replace("deconv_flow", "deconv")
        return ["_flownets", f"_{mod}"] + list(rest[2:])
    if not rest[0].endswith("_0"):
        raise ValueError(f"unexpected FlowNet module {'/'.join(path)}")
    return ["_flownets", f"_{rest[0][:-2]}", "0"] + list(rest[1:])


def flownet1s_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``FlowNet1S`` (any flags) or ``IRRFlowNet`` params → the port's
    ``state_dict``.  The plain net (its stem 64 wide, where the irr nets'
    is 32) keeps its stem under ``_flownets``; the decoders' transposed
    convs (``upsample_*``, ``deconv_*``) take torch's [Cin, Cout, kh, kw]."""
    if "params" in params:
        params = params["params"]
    plain = np.shape(params["conv1_0"]["kernel"])[-1] == 64
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        transposed = any(p.startswith(("upsample_", "deconv_")) for p in path)
        name, a = _conv_leaf(path, np.array(leaf, np.float32), transposed)
        sd[".".join(_flownet_torch_path(path[:-1], plain) + [name])] = torch.from_numpy(np.ascontiguousarray(a))
    return sd
