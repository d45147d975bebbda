"""Optimizer: global-norm clip, AdamW and the OneCycle schedule
(counterpart of ``eemflow_tpu/train/optim.py``; reference
``train_mvsec.py:178-183``).

``make_optimizer`` gives the JAX optax chain's update as a function of the
parameters (optax's ``tx.init``), which returns the :class:`Optimizer`:

  * the gradients' global norm clipped as ``optax.clip_by_global_norm``
    does, ``g · clip / max(norm, clip)``, computed on the device with no
    host sync (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm,
    which optax does not);
  * ``torch.optim.AdamW`` with b1 0.9 (fixed) and b2 0.999, ``eps`` and
    ``weight_decay`` on every parameter, biases too, as ``optax.adamw``
    without a mask: ``p ← p − lr · (m̂ / (√v̂ + eps) + wd · p)``.  A
    parameter the loss does not reach (IRR-FlowNet's occlusion decoder,
    whose outputs the refinement takes detached) gets a zero gradient, as
    JAX gives it, so that it decays as in JAX; torch's AdamW would skip it;
  * the learning rate of update n (from 0) is ``onecycle_lr(n)``, a
    ``LambdaLR`` over this module's copy of the JAX schedule.  Not
    ``OneCycleLR``: that one cycles beta1 unless told otherwise and raises
    past its last step, where the JAX schedule holds its final value.

No loss scaling: bf16 training keeps float32 master parameters, and bf16
shares float32's exponent range.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, List

import torch


def onecycle_lr(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.05,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Callable[[int], float]:
    """torch's OneCycleLR with linear annealing, as a function of the step:
    from ``max_lr / div_factor`` up to ``max_lr`` by step
    ``pct_start · total − 1``, then down to ``initial / final_div_factor``
    at step ``total − 1``, held there after it."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    warm_end = float(pct_start * total_steps) - 1.0
    total_end = float(total_steps - 1)

    def schedule(step: int) -> float:
        s = min(float(step), total_end)
        if s <= warm_end:
            return initial + (max_lr - initial) * min(max(s / max(warm_end, 1e-8), 0.0), 1.0)
        return max_lr + (final - max_lr) * min(
            max((s - warm_end) / max(total_end - warm_end, 1e-8), 0.0), 1.0
        )

    return schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``, the
    norm over all of them; returns the norm (a device tensor)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """The chain bound to its parameters: ``step()`` clips their ``.grad``,
    takes the AdamW step at this update's learning rate and advances the
    schedule."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, wdecay: float, epsilon: float,
                 num_steps: int, clip: float, pct_start: float):
        self.params = [p for p in params if p.requires_grad]
        self.clip = clip
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr, betas=(0.9, 0.999), eps=epsilon, weight_decay=wdecay
        )
        self.schedule = onecycle_lr(lr, num_steps + 100, pct_start=pct_start)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, lambda n: self.schedule(n) / lr)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """One update from the parameters' gradients; returns the gradients'
        global norm before the clip."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params], self.clip)
        self.adamw.step()
        self.scheduler.step()
        return norm

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.adamw.param_groups[0]["lr"]

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(
    lr: float,
    wdecay: float = 0.0,
    epsilon: float = 1e-8,
    num_steps: int = 100000,
    clip: float = 1.0,
    pct_start: float = 0.05,
) -> Callable[[Iterable[torch.nn.Parameter]], Optimizer]:
    """The reference training recipe (OneCycle over ``num_steps + 100``
    steps, the clip, AdamW) as params → :class:`Optimizer`."""
    return functools.partial(Optimizer, lr=lr, wdecay=wdecay, epsilon=epsilon, num_steps=num_steps,
                             clip=clip, pct_start=pct_start)
