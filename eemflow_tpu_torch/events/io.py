"""File readers and writers for event and flow data (counterpart of
``eemflow_tpu/events/io.py:12-127``; reference ``loader/loader_utils.py:26-65``,
``utils_luo/tools.py:2771-2808``).  Host-side numpy.

MVSEC's per-frame event tables are HDF5 files with a group ``myDataset`` of
float64 datasets ``ts``, ``x``, ``y``, ``p``, as the offline encoder writes
them; ``read_events_h5``/``write_events_h5`` read and write that layout
with the port's own numpy code (``events.hdf5``), since the card's machine
has no ``h5py``.  The reference's pandas/pytables tables (``pandas.
read_hdf``) are out of scope: the JAX package reads them only where pandas
and pytables are both installed, and neither machine has pytables.
"""

from __future__ import annotations

import re

import numpy as np

from eemflow_tpu_torch.events.hdf5 import read_datasets, write_datasets

EVENT_COLUMNS = ("ts", "x", "y", "p")


def read_compressed_events(event_path: str) -> np.ndarray:
    """Read an npz with x/y/t/p arrays → [N,4] float64 (t[s], x, y, p∈{-1,1}).

    Timestamps arrive in nanoseconds and are scaled by 1e-9; polarity is
    mapped 0/1 → ∓1 (reference ``loader_utils.py:26-42``)."""
    with np.load(event_path) as d:
        p = 2 * d["p"].astype(np.float64) - 1
        return np.stack(
            [d["t"].astype(np.float64) * 1e-9, d["x"], d["y"], p], axis=1
        ).astype(np.float64)


def read_flo(flow_path: str) -> np.ndarray:
    """Middlebury .flo reader → [H, W, 2] float32."""
    with open(flow_path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != 202021.25:
            raise ValueError(f"Invalid .flo file: {flow_path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
        return np.resize(data, (h, w, 2))


def write_flo(flow: np.ndarray, flow_path: str) -> None:
    """Write [H, W, 2] float32 flow as Middlebury .flo."""
    h, w = flow.shape[:2]
    with open(flow_path, "wb") as f:
        np.asarray([202021.25], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_events_h5(event_path: str) -> np.ndarray:
    """A per-frame HDF5 event table → [N, 4] float64 [ts, x, y, p]: the
    datasets under ``myDataset``, or at the root of a file without it."""
    d = read_datasets(event_path)
    missing = [k for k in EVENT_COLUMNS if k not in d]
    if missing:
        raise ValueError(f"{event_path}: no dataset {missing} in the event table")
    return np.stack([d[k] for k in EVENT_COLUMNS], axis=1)


def write_events_h5(events: np.ndarray, event_path: str) -> None:
    """Write [N, 4] [ts, x, y, p] as float64 datasets under ``myDataset``."""
    events = np.asarray(events)
    write_datasets(event_path, {k: events[:, i] for i, k in enumerate(EVENT_COLUMNS)})


def read_flow_npy(path: str) -> np.ndarray:
    """GT flow .npy as produced by the MVSEC encoder ([2, H, W] or [H, W, 2])."""
    return np.load(path)


def read_pfm(path: str) -> np.ndarray:
    """PFM reader (reference ``readPFM``): 'PF' 3 channels, 'Pf' 1; a negative
    scale means little-endian; rows are stored bottom-up (flipped here).
    FlyingThings3D's flow files are 'PF' with the third channel unused."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"Not a PFM file: {path}")
        dims = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not dims:
            raise ValueError(f"Malformed PFM header: {path}")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f")
    shape = (height, width, 3) if header == b"PF" else (height, width)
    return np.flipud(data.reshape(shape))


def write_pfm(image: np.ndarray, path: str, scale: float = 1.0) -> None:
    """Write a 1- or 3-channel float image as little-endian PFM."""
    image = np.asarray(image, np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())
        np.flipud(image).tofile(f)


def read_flow_any(path: str) -> np.ndarray:
    """Flow by extension: ``.pfm`` (FlyingThings3D; the third channel
    dropped, RAFT's ``read_gen``), else Middlebury ``.flo``."""
    if path.endswith(".pfm"):
        flow = read_pfm(path).astype(np.float32)
        return flow if flow.ndim == 2 else np.ascontiguousarray(flow[:, :, :2])
    return read_flo(path)
