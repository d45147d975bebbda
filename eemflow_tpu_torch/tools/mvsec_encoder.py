"""Offline MVSEC encoder of the port (counterpart of ``tools/mvsec_encoder.py``;
reference ``loader/MVSEC_encoder.py``).  Host-only; not on the card's path.

Slices the raw MVSEC HDF5 event stream into per-frame event tables keyed by
``image_raw_event_inds`` and synthesizes time-propagated GT flow ``.npy``
between frame timestamps:

  * events: per frame i, the slice ``events[inds[i-1] : inds[i+dt-1]]`` →
    ``event/{i:06d}.h5`` (group ``myDataset``, float64 ``ts``/``x``/``y``/``p``,
    written by ``events.io.write_events_h5``);
  * flow: ``estimate_corresponding_gt_flow(flow_dist, flow_dist_ts, ts[i],
    ts[i+dt])`` → ``flowgt_dt{dt}/{i}.npy`` ([2, H, W] float32).

Existing output files are skipped.  MVSEC's own ``{seq}_data.hdf5`` and
``{seq}_gt.hdf5`` use chunked, compressed datasets, which the port's small
HDF5 reader does not take: they are read through ``h5py``, which must be
installed on the machine that encodes (the card's machine has none).

Usage:
  python -m eemflow_tpu_torch.tools.mvsec_encoder --data path/{seq}_data.hdf5 \
      --gt path/{seq}_gt.hdf5 --out dataset/MVSEC/{seq} -dt 1 [--only_event]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from eemflow_tpu_torch.data.gt_flow import estimate_corresponding_gt_flow
from eemflow_tpu_torch.events.io import write_events_h5


def _h5py():
    try:
        import h5py
    except ImportError:
        raise SystemExit("mvsec_encoder: reading MVSEC's raw HDF5 files needs the h5py package, "
                         "which is not installed") from None
    return h5py


def encode_events(data_h5: str, out_dir: str, dt: int) -> None:
    h5py = _h5py()
    os.makedirs(out_dir, exist_ok=True)
    with h5py.File(data_h5, "r") as f:
        events = f["davis"]["left"]["events"][:]  # [N, 4] x, y, t, p
        inds = f["davis"]["left"]["image_raw_event_inds"][:]
    n_frames = len(inds)
    for i in range(1, n_frames - dt + 1):
        out_path = os.path.join(out_dir, f"{i:06d}.h5")
        if os.path.exists(out_path):
            continue
        sl = events[int(inds[i - 1]): int(inds[i + dt - 1])]
        # [ts, x, y, p] column order (events.io.read_events_h5)
        write_events_h5(np.stack([sl[:, 2], sl[:, 0], sl[:, 1], sl[:, 3]], axis=1), out_path)
        if i % 200 == 0:
            print(f"events {i}/{n_frames}", flush=True)


def encode_flowgt(data_h5: str, gt_h5: str, out_dir: str, dt: int) -> None:
    h5py = _h5py()
    os.makedirs(out_dir, exist_ok=True)
    with h5py.File(gt_h5, "r") as f:
        flow_dist = f["davis"]["left"]["flow_dist"][:]  # [T, 2, H, W]
        flow_ts = f["davis"]["left"]["flow_dist_ts"][:]
    with h5py.File(data_h5, "r") as f:
        image_ts = f["davis"]["left"]["image_raw_ts"][:]
    x_flows, y_flows = flow_dist[:, 0], flow_dist[:, 1]
    n_frames = len(image_ts)
    for i in range(n_frames - dt):
        out_path = os.path.join(out_dir, f"{i}.npy")
        if os.path.exists(out_path):
            continue
        start, end = image_ts[i], image_ts[i + dt]
        if start < flow_ts[0] or end >= flow_ts[-1]:
            continue
        xs, ys = estimate_corresponding_gt_flow(x_flows, y_flows, flow_ts, start, end)
        np.save(out_path, np.stack([xs, ys], axis=0).astype(np.float32))
        if i % 200 == 0:
            print(f"flow {i}/{n_frames}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="MVSEC offline encoder (PyTorch port)")
    p.add_argument("--data", required=True, help="{seq}_data.hdf5")
    p.add_argument("--gt", default=None, help="{seq}_gt.hdf5")
    p.add_argument("--out", required=True, help="output sequence dir")
    p.add_argument("-dt", type=int, default=1, choices=[1, 4])
    p.add_argument("--only_event", action="store_true")
    args = p.parse_args(argv)
    if not args.only_event and args.gt is None:
        p.error("--gt is required unless --only_event")
    encode_events(args.data, os.path.join(args.out, "event"), args.dt)
    if not args.only_event:
        encode_flowgt(args.data, args.gt, os.path.join(args.out, f"flowgt_dt{args.dt}"), args.dt)


if __name__ == "__main__":
    main()
