"""Batch collation and background-thread prefetch (the port's copy of
``eemflow_tpu/data/loader.py:19-213``, the DataLoader analog).

The host pipeline is a thin thread-prefetched collator; the heavy op,
voxelization, runs on the card in the raw-event mode
(``data.device_input``).  The port is single-process: ``batch_iterator``
leaves out the JAX signature's ``process_index``/``process_count``
partition and its ``epochs`` bound until multi-device training needs
them (``ROADMAP.md``).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


def collate(samples, _arena=None) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into batched arrays.

    Arrays whose shapes differ only in dim 0 (bucket-laddered event
    buffers, ``events.voxel.make_ladder``) are zero-padded to the batch
    max, so that batch shapes come from the ladder's small set.  Numbers
    become arrays; anything else (names) a list.  ``_arena`` (see :class:`ArenaCollate`) is a dict
    reused across calls: output buffers are allocated once per (key,
    shape, dtype) and refilled."""

    def _buf(key, shape, dtype):
        if _arena is None:
            return np.empty(shape, dtype)
        slot = _arena.get((key, shape, np.dtype(dtype)))
        if slot is None:
            slot = np.empty(shape, dtype)
            _arena[(key, shape, np.dtype(dtype))] = slot
        return slot

    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            arrs = [s[k] for s in samples]
            n0 = max(a.shape[0] for a in arrs)
            if any(a.shape[0] != n0 for a in arrs):
                if any(a.shape[1:] != arrs[0].shape[1:] for a in arrs):
                    raise ValueError(f"collate: key '{k}' varies beyond dim 0")
                padded = _buf(k, (len(arrs), n0) + arrs[0].shape[1:], v0.dtype)
                for i, a in enumerate(arrs):
                    n = a.shape[0]
                    padded[i, :n] = a
                    padded[i, n:] = 0
                out[k] = padded
                continue
            stacked = _buf(k, (len(arrs),) + v0.shape, v0.dtype)
            for i, a in enumerate(arrs):
                stacked[i] = a
            out[k] = stacked
        elif isinstance(v0, (int, float, bool, np.integer, np.floating, np.bool_)):
            out[k] = np.asarray([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


class ArenaCollate:
    """``collate`` with rotating preallocated output buffers.

    ``slots`` arenas rotate per call, so a batch still queued in
    ``prefetch`` or being copied to the device is never overwritten: with
    prefetch depth d, a slot is refilled ``slots`` batches after it was
    handed out, so ``slots >= d + 2`` leaves one consumed batch of slack.
    The returned arrays alias the arenas: a consumer must copy a batch
    (``train.trainer.batch_to_device`` does, on the CPU too, where
    ``torch.from_numpy`` alone would alias) and must not keep a raw batch
    for ``slots`` more calls."""

    def __init__(self, slots: int = 4):
        self._arenas = [dict() for _ in range(max(1, slots))]
        self._i = 0

    def __call__(self, samples) -> Dict[str, np.ndarray]:
        arena = self._arenas[self._i]
        self._i = (self._i + 1) % len(self._arenas)
        before = len(arena)
        out = collate(samples, _arena=arena)
        if len(arena) != before:
            # a new batch shape: allocate and fault its buffers in every other
            # slot now, not when the rotation reaches them mid-run
            for key in list(arena):
                for other in self._arenas:
                    if key not in other:
                        other[key] = np.zeros(key[1], key[2])
        return out


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    collate_fn=collate,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of ``batch_size`` samples, epoch after epoch for ever, each
    epoch in a new order drawn from one ``default_rng(seed)``."""
    # raw-event datasets hand each sample two pooled pack buffers that
    # collate copies only after the whole batch is read: size the pool's
    # ring from the batch, so that no buffer is reused inside one batch
    pool = getattr(dataset, "_pack_pool", None)
    if pool is not None and hasattr(pool, "ensure_ring"):
        pool.ensure_ring(2 * batch_size + 4)
    rng = np.random.default_rng(seed)
    while True:
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i : i + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            yield collate_fn([dataset[int(j)] for j in idx])


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread with a bounded queue, so
    that host data preparation overlaps device work.  An error in the
    worker is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
