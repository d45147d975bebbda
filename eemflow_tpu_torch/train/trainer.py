"""Training engine (counterpart of ``eemflow_tpu/train/trainer.py:57-233``;
reference ``train_mvsec.py`` ``train_iters``).

One ``train_step`` carries a whole iteration on the device: the optional
raw-event input step (K1 ``voxelize`` per frame, flips; under
``torch.no_grad()``), the forward with ``train=True`` (K2 one launch for
the three correlations, its backward the plain version's autograd), the
family's loss, backward, the global-norm clip, AdamW and the OneCycle
step.  The step's metrics stay on the device; the host reads them only at
log boundaries.

Mixed precision is the JAX package's cast, not autocast: the forward runs
on bf16 copies of the float32 master parameters
(``torch.func.functional_call``) and on inputs cast to bf16, and its
outputs are cast back to float32 before the loss; the gradients reach the
masters through the casts.  (``torch.autocast`` keeps some ops in float32
and would compute another function.)  No loss scaling: bf16 has float32's
exponent range.  BatchNorm (ERAFT's and RAFT's context encoder) keeps its
running statistics float32 and updates them in the forward, from float32
statistics of its input, as flax's ``batch_stats`` (``models.raft_core.
BatchNorm``); ``functional_call`` swaps only the parameters, so the
module's own buffers take the update.

Checkpoints carry parameters, BatchNorm statistics, optimizer, schedule
and step (``train.checkpoint``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from eemflow_tpu_torch.train.adapters import Family, get_family
from eemflow_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    opt: Optimizer


def cast_floating(tree, dtype: torch.dtype):
    """Cast the floating tensors of nested tuples and lists to ``dtype``;
    everything else is kept."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_floating(t, dtype) for t in tree)
    return tree


def seeded_init_(model: torch.nn.Module, seed: int) -> None:
    """Draw every parameter anew from ``seed`` with the modules' own
    initializers (``reset_parameters``), leaving the global RNG as it was:
    the layers first, then each container that has its own (RAFT's
    encoders draw their convs as the reference does), innermost first."""
    mods = [m for m in model.modules() if hasattr(m, "reset_parameters")]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        with torch.no_grad():
            for m in mods:
                if next(m.children(), None) is None:
                    m.reset_parameters()
            for m in reversed(mods):
                if next(m.children(), None) is not None:
                    m.reset_parameters()


def create_train_state(
    model: torch.nn.Module,
    seed: int,
    tx: Callable[..., Optimizer],
    params: Optional[Dict[str, torch.Tensor]] = None,
    device: Union[str, torch.device, None] = None,
) -> TrainState:
    """The model's parameters drawn from ``seed`` (or loaded from the
    ``state_dict`` ``params``), placed on ``device``, with the optimizer
    ``tx`` (``train.optim.make_optimizer``) over them at step 0."""
    if params is None:
        seeded_init_(model, seed)
    else:
        model.load_state_dict(params)
    if device is not None:
        model.to(device)
    model.train()
    return TrainState(step=0, model=model, opt=tx(model.parameters()))


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The numpy arrays of a host batch as tensors on ``device``, floating
    ones as float32 (as JAX's ``device_put`` gives them with 64-bit types
    off).  Always a copy, so that a collate arena may be refilled at once:
    on the card through pinned memory without a host sync."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        if np.issubdtype(v.dtype, np.floating) and v.dtype != np.float32:
            v = v.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.clone()
    return out


def make_train_step(
    gamma: float = 0.8,
    family: Union[str, Family] = "two_volume",
    preprocess: Optional[Callable] = None,
    mixed_precision: bool = False,
) -> Callable:
    """The train step: (state, device batch) → (state, metrics), the state
    updated in place, the metrics device tensors."""
    fam = get_family(family)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        if preprocess is not None:
            with torch.no_grad():
                batch = preprocess(batch)
        model = state.model
        args = fam.model_args(batch)
        if mixed_precision:
            # each parameter once: a module reached under two names (ERAFT's
            # strided blocks hold norm3 also as downsample.1) is one object,
            # whose swapped attribute both names see; functional_call's
            # weight tying would leave the bf16 copies in the model
            params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
            outputs = functional_call(model, params, cast_floating(args, torch.bfloat16), {"train": True},
                                      tie_weights=False)
            outputs = cast_floating(outputs, torch.float32)
        else:
            outputs = model(*args, train=True)
        loss, metrics = fam.compute_loss(outputs, batch, gamma)
        state.opt.zero_grad()
        loss.backward()
        state.opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    return step_fn


class Trainer:
    """Epoch-style loop: ``val_iters`` steps an epoch, a log line every
    ``log_every``, a checkpoint each epoch (reference ``train_iters``,
    ``train_mvsec.py:229-286``).  Metrics accumulate on the device; the
    host reads them only at log boundaries."""

    def __init__(
        self,
        gamma: float = 0.8,
        family: Union[str, Family] = "two_volume",
        preprocess: Optional[Callable] = None,
        mixed_precision: bool = False,
        logger=None,
        checkpoint_dir: Optional[str] = None,
        log_every: int = 10,
    ):
        self.logger = logger
        self.checkpoint_dir = checkpoint_dir
        self.log_every = log_every
        self.train_step = make_train_step(
            gamma, family=family, preprocess=preprocess, mixed_precision=mixed_precision
        )

    def _log(self, line: str) -> None:
        if self.logger is not None:
            self.logger.write_line(line, verbose=True)
        else:
            print(line, flush=True)

    def train_iters(
        self,
        state: TrainState,
        batches: Iterable[Dict[str, torch.Tensor]],
        start_epoch: int = 0,
        val_iters: int = 500,
    ) -> TrainState:
        total_loss = total_epe = 0.0
        iters = 0
        t0 = time.time()
        for batch in batches:
            state, metrics = self.train_step(state, batch)
            iters += 1
            # accumulated on the device: no host sync on the hot path
            total_loss = total_loss + metrics["loss"]
            total_epe = total_epe + metrics["epe"]
            if iters % self.log_every == 0:
                loss_avg = float(total_loss) / iters  # sync point
                epe_avg = float(total_epe) / iters
                dt = time.time() - t0
                self._log(
                    f"iters{iters + start_epoch * val_iters:06d}  {iters:05d}/{val_iters:05d}"
                    f"  loss:{loss_avg:2.6f}  AEE:{epe_avg:2.6f}"
                    f"  steps/s:{iters / dt:.2f}"
                )
                if self.logger is not None:
                    self.logger.write_jsonl({
                        "kind": "train", "epoch": start_epoch + 1,
                        "step": iters + start_epoch * val_iters,
                        "loss": loss_avg, "aee": epe_avg,
                        "steps_per_sec": iters / dt,
                    })
            if iters >= val_iters:
                break
        n = max(iters, 1)
        self._log(
            f"epoch {start_epoch + 1}: mean loss {float(total_loss) / n:2.6f} "
            f"mean AEE {float(total_epe) / n:2.6f}"
        )
        if self.logger is not None:
            self.logger.write_jsonl({
                "kind": "epoch", "epoch": start_epoch + 1,
                "mean_loss": float(total_loss) / n,
                "mean_aee": float(total_epe) / n,
                "n_steps": iters, "wall_s": time.time() - t0,
            })
        if self.checkpoint_dir is not None:
            from eemflow_tpu_torch.train.checkpoint import save_checkpoint

            save_checkpoint(self.checkpoint_dir, state, epoch=start_epoch + 1)
        return state
