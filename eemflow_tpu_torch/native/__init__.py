"""Native host-side input runtime of the port: fused event decode + pack
and a sparse host voxelizer (C++, ctypes) — the port's own copy of
``eemflow_tpu/native`` (``decode_pack_npz`` ``:96``, ``decode_pack_arrays``
``:112``, ``HostVoxelizer`` ``:161``, ``decode_pack_features`` ``:255``).

The translation unit (``eventpack.cpp``) fuses npz/h5 column decode,
timestamp scaling + relative conversion, polarity mapping and bucket
padding into one pass writing the final float32 rows — no intermediate
arrays.

Built at first use with ``g++ -O3 -shared -fPIC`` (the host compiler
``nvcc`` needs beside it) into ``_build/`` next to this file (git-ignored),
the library's name keyed by a hash of the source and the flags, as
``kernels/build.py`` keys the kernels' library; a unique temporary name
and an atomic rename, so a half-written library is never loadable.  Loaded
with ``ctypes``.

The numpy path (``events.sequence.EventSequence`` +
``events.voxel.pad_events``) takes unsorted input, which it sorts, and
everything when no ``g++`` is installed; it is bit-identical to the native
path.  ``have_native()`` says which path runs (``native_status()`` why);
a compiler that is present but fails raises instead of falling back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "eventpack.cpp")
BUILD_DIR = os.path.join(HERE, "_build")
FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_STATUS = "not built yet"
_BUILD_LOCK = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libeventpack-{h.hexdigest()[:16]}.so")


def build_command(out_path: str, cxx: str = "g++"):
    return [cxx, *FLAGS, "-o", out_path, SOURCE]


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _STATUS
    if _LIB is not None or _TRIED:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        so = library_path()
        if not os.path.exists(so):
            cxx = shutil.which("g++")
            if cxx is None:
                _TRIED = True
                _STATUS = "numpy path: g++ not found"
                return None
            os.makedirs(BUILD_DIR, exist_ok=True)
            # a unique temporary name, then an atomic rename: concurrent
            # builders race benignly (the last rename wins, same content)
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run(build_command(tmp, cxx), capture_output=True, text=True)
            if proc.returncode != 0:
                _TRIED = True
                raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.decode_pack_i64.restype = ctypes.c_int
        lib.decode_pack_f64.restype = ctypes.c_int
        lib.voxelize_sparse.restype = ctypes.c_longlong
        lib.zero_cells.restype = None
        _LIB = lib
        _TRIED = True
        _STATUS = f"native: {os.path.relpath(so, os.path.dirname(os.path.dirname(HERE)))}"
        return _LIB


def have_native() -> bool:
    """True when the C++ library is built and loaded (building it now if it
    has not been tried yet); False when no ``g++`` is installed."""
    return _build_and_load() is not None


def native_status() -> str:
    """Which packer runs, and why: the library's path, or the numpy path's
    reason."""
    _build_and_load()
    return _STATUS


def _fallback(
    features: np.ndarray, bucket: int, ts_mult: float, out: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, int, int]:
    """Numpy path (EventSequence + pad_events semantics)."""
    from eemflow_tpu_torch.events.sequence import EventSequence
    from eemflow_tpu_torch.events.voxel import pad_events

    if len(features) == 0:  # the native path returns an all-zero buffer too
        return pad_events(np.zeros((0, 4), np.float32), bucket, out)
    seq = EventSequence(
        features, height=0, width=0,
        timestamp_multiplier=ts_mult, convert_to_relative=True,
    )
    return pad_events(seq.features, bucket, out)


def _check_out(out: Optional[np.ndarray], bucket: int) -> np.ndarray:
    if out is None:
        return np.empty((bucket, 4), np.float32)
    if out.shape != (bucket, 4) or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous [bucket, 4] float32 buffer")
    return out


def decode_pack_npz(npz, bucket: int, ts_mult: float = 1e6,
                    out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int, int]:
    """HREM npz event record → (padded [bucket, 4] float32, n_valid, dropped).

    NpzFile members are not cached: a caller that also needs len(t)
    (bucket-ladder selection) decodes the columns once and calls
    ``decode_pack_arrays``."""
    t = np.ascontiguousarray(npz["t"], np.int64)
    x = np.ascontiguousarray(npz["x"], np.int16)
    y = np.ascontiguousarray(npz["y"], np.int16)
    p = np.ascontiguousarray(npz["p"], np.int8)
    return decode_pack_arrays(t, x, y, p, bucket, ts_mult, out)


def decode_pack_arrays(
    t: np.ndarray, x: np.ndarray, y: np.ndarray, p: np.ndarray,
    bucket: int, ts_mult: float = 1e6, out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int, int]:
    """Decoded HREM columns (int64 t [ns] / int16 x, y / int8 p) →
    (padded [bucket, 4] float32, n_valid, dropped).

    ``out``: a [bucket, 4] float32 C-contiguous buffer to write into (a
    pooled or pinned page), on either path."""
    t = np.ascontiguousarray(t, np.int64)
    x = np.ascontiguousarray(x, np.int16)
    y = np.ascontiguousarray(y, np.int16)
    p = np.ascontiguousarray(p, np.int8)
    out = _check_out(out, bucket)
    lib = _build_and_load()
    if lib is not None:
        n_valid = ctypes.c_longlong()
        n_dropped = ctypes.c_longlong()
        rc = lib.decode_pack_i64(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
            ctypes.c_longlong(len(t)),
            ctypes.c_longlong(bucket),
            ctypes.c_double(ts_mult),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(n_valid),
            ctypes.byref(n_dropped),
        )
        if rc == 0:
            return out, int(n_valid.value), int(n_dropped.value)
    # unsorted (or no g++): decode the npz the reader's way, then the numpy path
    feats = np.stack(
        [t.astype(np.float64) * 1e-9, x, y, 2.0 * p.astype(np.float64) - 1.0],
        axis=1,
    )
    return _fallback(feats, bucket, ts_mult, out)


def decode_pack_features(
    features: np.ndarray, bucket: int, ts_mult: float = 1e6,
    map_zero_polarity: bool = False,
) -> Tuple[np.ndarray, int, int]:
    """[N, 4] float64 [ts, x, y, p] (MVSEC h5 tables) → padded float32 rows."""
    lib = _build_and_load()
    feats = np.ascontiguousarray(features, np.float64)
    if lib is not None and feats.size:
        cols = np.ascontiguousarray(feats.T)  # per-column contiguous views
        out = np.empty((bucket, 4), np.float32)
        n_valid = ctypes.c_longlong()
        n_dropped = ctypes.c_longlong()
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        rc = lib.decode_pack_f64(
            dptr(cols[0]), dptr(cols[1]), dptr(cols[2]), dptr(cols[3]),
            ctypes.c_longlong(len(feats)),
            ctypes.c_longlong(bucket),
            ctypes.c_double(ts_mult),
            ctypes.c_int(1 if map_zero_polarity else 0),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(n_valid),
            ctypes.byref(n_dropped),
        )
        if rc == 0:
            return out, int(n_valid.value), int(n_dropped.value)
    if map_zero_polarity and feats.size:  # match the native path's mapping
        feats = feats.copy()
        feats[feats[:, 3] == 0, 3] = -1.0
    return _fallback(feats, bucket, ts_mult)


class HostVoxelizer:
    """Native host voxelization of packed event rows → [bins, H, W] float32
    (or [H, W, bins] with ``nhwc=True``).

    Numerics mirror ``events.voxel.events_to_voxel_grid_np`` (the float64
    host twin) with float32 cell accumulation like the device scatter; the
    numpy twin runs when the native library is unavailable.  Not
    thread-safe: one per worker thread.

    Strictly O(events) per call: a stamp grid and a per-call epoch detect
    first touches, and the returned grids come from a ring of ``ring``
    buffers, all made at the first call, whose previously touched cells
    are re-zeroed on reuse
    (``zero_cells``).  A returned grid stays valid for ``ring - 1`` further
    calls.  ``alloc(shape)`` makes a ring buffer, zero-filled (default
    ``np.zeros``; pinned host memory for copies to the card), and
    ``claim(grid)`` says whether the next buffer may be written (default:
    always; ``data.staging.Staging.claim`` says no while the copy that
    reads its previous grid is not issued or not completed): where it may
    not, a new buffer joins the ring there, so the ring grows to the
    number of grids in use and a call never waits."""

    def __init__(self, num_bins: int, height: int, width: int,
                 normalize: bool = True, ring: int = 4, nhwc: bool = False,
                 alloc: Callable[[tuple], np.ndarray] = None,
                 claim: Callable[[np.ndarray], bool] = None):
        self.num_bins, self.height, self.width = num_bins, height, width
        self.normalize = normalize
        self.nhwc = nhwc
        self._alloc = alloc or (lambda shape: np.zeros(shape, np.float32))
        self._claim = claim or (lambda grid: True)
        self._lib = _build_and_load()
        if self._lib is not None:
            cells = num_bins * height * width
            self._stamp = np.zeros(cells, np.uint32)
            self._epoch = 0
            self._ring = max(2, ring)
            # (grid, touched-index buffer, touched count) per slot
            self._slots = []
            self._next = 0

    def __call__(self, rows: np.ndarray, n_valid: int) -> np.ndarray:
        """rows: packed [bucket, 4] float32 (t, x, y, p), the first n_valid
        real.  Returns a ring-owned grid (see the class doc)."""
        if self._lib is None:
            from eemflow_tpu_torch.events.voxel import events_to_voxel_grid_np

            g = events_to_voxel_grid_np(
                np.asarray(rows[:n_valid], np.float64), self.num_bins,
                self.height, self.width, self.normalize,
            )
            return np.ascontiguousarray(g.transpose(1, 2, 0)) if self.nhwc else g
        rows = np.ascontiguousarray(rows, np.float32)
        n = int(n_valid)
        cap = max(2 * n, 2)
        fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))

        shape = ((self.height, self.width, self.num_bins) if self.nhwc
                 else (self.num_bins, self.height, self.width))
        if not self._slots:  # the whole ring at the first call, zero-filled
            self._slots = [[self._alloc(shape), np.empty(cap, np.int64), 0] for _ in range(self._ring)]
        slot = self._slots[self._next]
        if not self._claim(slot[0]):
            # the next grid is still in use: a new zero-filled one joins here
            slot = [self._alloc(shape), np.empty(cap, np.int64), 0]
            self._claim(slot[0])
            self._slots.insert(self._next, slot)
        self._next = (self._next + 1) % len(self._slots)
        grid, touched, k_prev = slot
        if k_prev:  # re-zero only the cells the previous use touched
            self._lib.zero_cells(fptr(grid), iptr(touched), ctypes.c_longlong(k_prev))
        if len(touched) < cap:
            slot[1] = np.empty(cap, np.int64)

        self._epoch += 1
        if self._epoch >= 0xFFFFFFFF:  # stamp wrap: restart cleanly
            self._stamp[:] = 0
            self._epoch = 1
        k = self._lib.voxelize_sparse(
            fptr(rows), ctypes.c_longlong(n),
            ctypes.c_int(self.num_bins), ctypes.c_int(self.height),
            ctypes.c_int(self.width),
            ctypes.c_int(1 if self.normalize else 0),
            ctypes.c_int(1 if self.nhwc else 0),
            self._stamp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_uint32(self._epoch),
            fptr(slot[0]), iptr(slot[1]),
        )
        slot[2] = int(k)
        return slot[0]
