"""Host staging: pinned host buffers for the copies to and from the card.

A copy from pageable memory makes the driver stage it through its own
pinned bounce buffer and returns only when the copy is done; a copy from
page-locked (pinned) memory runs asynchronously on the stream, overlapped
with the host's next work.  A pinned buffer may be written again only once
the copy that reads it has completed.

``take(shape)`` returns a new pinned buffer from PyTorch's caching host
allocator for its producer to fill (the event packer's ``out=``);
``upload`` copies it to the card with ``non_blocking=True`` and lets the
tensor go: the allocator records an event behind that copy and hands the
block out again only after the event has completed, so in the steady
state ``take`` reuses blocks and never waits.  A buffer whose owner keeps
refilling it (``native.HostVoxelizer``'s ring) comes from ``buffer`` and
is uploaded the same way; ``claim(buf)`` says whether its owner may write
it again (not handed out since its last upload, that copy completed) and
marks it handed out.  Any other array is uploaded as a pageable copy.
``fetch(t)`` starts the copy of a device tensor into pinned memory and
returns a handle whose ``numpy()`` waits for it.

On the CPU there is no card to copy to: buffers are plain numpy arrays,
``upload`` passes an array through as a tensor (a ``buffer`` it copies, so
that its owner may refill it at once), and ``fetch`` gives the tensor's
own numpy view.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

_HANDED_OUT = object()


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class Fetch:
    """A device→host copy in flight; ``numpy()`` waits for it."""

    def __init__(self, host: torch.Tensor, event: Optional[torch.cuda.Event]):
        self._host = host
        self._event = event

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class Staging:
    """Pinned host buffers on the way to and from ``device`` (see the
    module doc).  ``take``, ``buffer`` and ``claim`` may run on another
    thread than ``upload``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self._lock = threading.Lock()
        # buffer address → the pinned tensor that owns it: taken ones until
        # their upload, kept ones for good
        self._taken: Dict[int, torch.Tensor] = {}
        self._kept: Dict[int, torch.Tensor] = {}
        # kept buffer address → _HANDED_OUT, or the event behind its last upload
        self._state: Dict[int, object] = {}

    def take(self, shape, dtype=np.float32) -> np.ndarray:
        """A new host buffer (pinned on the card's side) for one upload."""
        t = torch.empty(tuple(shape), dtype=_torch_dtype(dtype), pin_memory=self.pinned)
        arr = t.numpy()
        if self.pinned:
            with self._lock:
                self._taken[arr.ctypes.data] = t
        return arr

    def buffer(self, shape, dtype=np.float32) -> np.ndarray:
        """A zero-filled host buffer (pinned on the card's side) that its
        owner refills, each time after ``claim``."""
        t = torch.zeros(tuple(shape), dtype=_torch_dtype(dtype), pin_memory=self.pinned)
        arr = t.numpy()
        with self._lock:
            self._kept[arr.ctypes.data] = t
        return arr

    def claim(self, buf: np.ndarray) -> bool:
        """True, and ``buf`` marked handed out, if it may be written: not
        handed out since its last upload, and that copy completed."""
        key = buf.ctypes.data
        with self._lock:
            state = self._state.get(key)
            if state is _HANDED_OUT or (state is not None and not state.query()):
                return False
            self._state[key] = _HANDED_OUT
            return True

    def _owner(self, arr: np.ndarray):
        """(the pinned tensor whose whole buffer ``arr`` is, kept?), the
        taken one forgotten; (None, False) for any other array."""
        key = arr.ctypes.data
        with self._lock:
            kept = key in self._kept
            t = self._kept.get(key) if kept else self._taken.get(key)
            if t is None or tuple(t.shape) != arr.shape or t.numpy().dtype != arr.dtype:
                return None, False
            if not kept:
                del self._taken[key]
        return t, kept

    def upload(self, arr: np.ndarray, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``arr`` on the device (into ``out`` when given)."""
        arr = np.asarray(arr)
        src, kept = self._owner(arr)
        if src is None:
            # not one of these buffers: a pageable copy (on the CPU the array
            # itself, which its producer does not refill)
            t = torch.from_numpy(arr)
            if out is None:
                return t.to(self.device)
            return out.copy_(t)
        if out is None:
            out = torch.empty(arr.shape, dtype=src.dtype, device=self.device)
        out.copy_(src, non_blocking=self.pinned)
        if kept:
            state = None
            if self.pinned:
                state = torch.cuda.Event()
                state.record(torch.cuda.current_stream(self.device))
            with self._lock:
                if state is None:
                    self._state.pop(arr.ctypes.data, None)
                else:
                    self._state[arr.ctypes.data] = state
        return out

    def fetch(self, t: torch.Tensor) -> Fetch:
        """Start copying ``t`` to the host; the handle's ``numpy()`` waits."""
        if not self.pinned or t.device.type != "cuda":
            return Fetch(t.detach().cpu(), None)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        return Fetch(host, event)
