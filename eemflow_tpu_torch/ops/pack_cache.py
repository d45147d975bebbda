"""Packed copies of parameters that follow the parameters they were made
from.

A fused mode packs a module's weights once into its kernel's layout (K3's
conv chains, K4's coarse stage, K5's update block).  The copy must not
outlive the values it was made from: ``PackCache`` stamps each entry with
``(p.data_ptr(), p._version)`` of every parameter it packs, and repacks
when the stamp differs.  An in-place update under autograd's eyes
(``optimizer.step()``, ``load_state_dict``, ``with torch.no_grad():
p.mul_(2)``) bumps ``_version``; a parameter replaced by another tensor
changes ``data_ptr``.  An edit through ``p.data`` bypasses the version
counter and is not seen, and a model moved between devices should clear
the cache, since a new allocation can land at an old address with its
counter back at 0.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Iterable, Tuple, TypeVar

import torch

T = TypeVar("T")


def param_stamp(params: Iterable[torch.Tensor]) -> Tuple[Tuple[int, int], ...]:
    """(storage address, version) of each tensor; an inference tensor has no
    version counter and cannot change outside inference mode, so it counts
    as version -1."""
    return tuple((p.data_ptr(), -1 if p.is_inference() else p._version) for p in params)


class PackCache:
    """Entries made by ``make()`` under a caller's key, each valid while the
    parameters it was packed from keep their stamp."""

    def __init__(self):
        self._entries: Dict[Hashable, Tuple[tuple, object]] = {}

    def get(self, key: Hashable, params: Iterable[torch.Tensor], make: Callable[[], T]) -> T:
        stamp = param_stamp(params)
        hit = self._entries.get(key)
        if hit is None or hit[0] != stamp:
            hit = self._entries[key] = (stamp, make())
        return hit[1]

    def clear(self) -> None:
        self._entries.clear()

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries
