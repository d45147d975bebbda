"""Profile the port's eval step (EEMFlow or ERAFT) with ``torch.profiler``
(counterpart of ``tools/profile_model.py``): device time by kernel, the
device's busy share over the profiled window, and host milliseconds per
call.

Profiles either the forward on voxel grids already on the device, or, with
``--events N``, one whole device-voxelize eval sample (``Tester.run_sample``:
packed events copied from the host, K1 voxelize (scatter and normalization), forward,
flow copied back) with N random events per frame in a 2^18 bucket.  The
weights are random (timing does not depend on them).  Writes a Chrome
trace to ``--logdir`` and prints one JSON line.

Usage:
  python -m eemflow_tpu_torch.tools.profile_model --size 720 1280 -bs 1 [--fast] \
      [--fast_head] [--fast_pyramid] [--events 30000]
  python -m eemflow_tpu_torch.tools.profile_model -model eraft --size 720 1280 -bs 1 \
      [--fused_update | --fused_update_bf16] [--corr_fast]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from eemflow_tpu_torch.data.device_input import make_device_preprocess
from eemflow_tpu_torch.device import resolve_device
from eemflow_tpu_torch.eval.runner import Tester
from eemflow_tpu_torch.models.registry import get_eval_model
from eemflow_tpu_torch.tools.time_eval import add_mode_flags, mode_kwargs

BUCKET = 1 << 18
BINS = 5
TOP = 12  # kernels listed, by device time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Profile the eval step (PyTorch port)")
    p.add_argument("--size", type=int, nargs=2, default=[720, 1280])
    p.add_argument("-bs", "--batch_size", type=int, default=1)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--events", type=int, default=0,
                   help="profile a whole device-voxelize eval sample with this "
                   "many events per frame (0: the forward alone)")
    add_mode_flags(p)
    p.add_argument("--logdir", default="runs/profile_torch")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def _packed_events(rng, n: int, h: int, w: int) -> np.ndarray:
    ev = np.zeros((BUCKET, 4), np.float32)
    ev[:n, 0] = np.sort(rng.uniform(0, 50_000, n))
    ev[:n, 1] = rng.integers(0, w, n)
    ev[:n, 2] = rng.integers(0, h, n)
    ev[:n, 3] = rng.integers(0, 2, n)
    return ev


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    h, w = args.size
    model_kwargs = mode_kwargs(args)
    model = get_eval_model(args.model, **model_kwargs)
    rng = np.random.default_rng(0)
    if args.events:
        if args.batch_size != 1:
            raise SystemExit("--events profiles one sample: use -bs 1")
        tester = Tester(model, device, preprocess=make_device_preprocess(BINS, h, w))
        sample = {
            "events_old": _packed_events(rng, args.events, h, w), "n_old": np.int32(args.events),
            "events_new": _packed_events(rng, args.events, h, w), "n_new": np.int32(args.events),
        }

        def step():
            tester.run_sample(sample)
    else:
        model.to(device)
        x1, x2 = (
            torch.from_numpy(rng.standard_normal((args.batch_size, h, w, BINS)).astype(np.float32)).to(device)
            for _ in range(2)
        )

        def step():
            with torch.inference_mode():
                model(x1, x2)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    for _ in range(3):
        step()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(args.logdir, exist_ok=True)
    trace = os.path.join(args.logdir, "trace.json")
    prof.export_chrome_trace(trace)

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    result = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "model": args.model, "modes": model_kwargs,
        "size": [h, w], "batch": args.batch_size, "fast": args.fast,
        "fast_head": args.fast_head, "fast_pyramid": args.fast_pyramid, "events": args.events,
        "reps": args.reps, "ms_per_call": wall_ms / args.reps,
        "device_busy_share": busy_ms / wall_ms if kernels else None,
        "device_ms_per_call": busy_ms / args.reps if kernels else None,
        "top_kernels": [
            {
                "name": e.key[:120],
                "device_ms_per_call": e.self_device_time_total / 1e3 / args.reps,
                "launches_per_call": e.count / args.reps,
            }
            for e in kernels[:TOP]
        ],
        "trace": trace,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
