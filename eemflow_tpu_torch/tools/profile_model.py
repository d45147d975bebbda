"""Profile the port's eval step or a train step (EEMFlow, EEMFlow+, ERAFT,
GMA, SKFlow or KPAFlow) with ``torch.profiler`` (counterpart of ``tools/profile_model.py``): device
time by kernel, the device's busy share over the profiled window (the
union of its kernels' and copies' intervals in the exported trace over the
window's wall time), host milliseconds per call and the host's own time
by operator.

Profiles the forward on voxel grids already on the device; or, with
``--events N``, one whole device-voxelize eval sample (``Tester.run_sample``:
packed events copied from the host, K1 voxelize (scatter and normalization), forward,
flow copied back) with N random events per frame in a 2^18 bucket; or,
with ``--train``, one train step on a raw-event batch already on the
device (K1 voxelize per frame, forward, loss, backward, clip, AdamW;
``--bf16`` for the mixed-precision forward), ``--events`` (default 30,000)
events per frame, ``--bins`` voxel bins: EEMFlow's against the 16×16
meshflow label, the others' against the full-resolution flow.  The weights are random (timing does not depend on
them).  Writes a Chrome trace to ``--logdir`` and prints one JSON line.

Usage:
  python -m eemflow_tpu_torch.tools.profile_model --size 720 1280 -bs 1 [--fast] \
      [--fast_head] [--fast_pyramid] [--events 30000]
  python -m eemflow_tpu_torch.tools.profile_model -model eemflow_plus --size 720 1280 -bs 1 \
      [--fast_pyramid --fast_decoders --fast_sgu]
  python -m eemflow_tpu_torch.tools.profile_model -model eraft --size 720 1280 -bs 1 \
      [--fused_update | --fused_update_bf16] [--corr_fast] [--stacked_lookup]
  python -m eemflow_tpu_torch.tools.profile_model --train --size 720 1280 -bs 6 [--bf16]
  python -m eemflow_tpu_torch.tools.profile_model --train -model eemflow_plus --bins 15 -bs 6 [--bf16]
  python -m eemflow_tpu_torch.tools.profile_model --train -model eraft -bs 6 [--bf16]
  python -m eemflow_tpu_torch.tools.profile_model [--train] -model kpaflow --size 256 256 -bs 6 [--bf16]
      (also gma, skflow)
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
TOP = 12  # kernels listed, by device time
# what the card runs, in the exported Chrome trace's categories
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_ms(trace_path: str) -> Optional[float]:
    """Milliseconds in which the card ran at least one kernel, copy or fill
    in an exported Chrome trace: the union of their intervals, so work that
    overlaps counts once and the user annotations the profiler also lists
    on the device do not count.  None when the trace holds no device work."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Profile the eval step (PyTorch port)")
    p.add_argument("--size", type=int, nargs=2, default=[720, 1280])
    p.add_argument("-bs", "--batch_size", type=int, default=1)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--events", type=int, default=0,
                   help="profile a whole device-voxelize eval sample with this "
                   "many events per frame (0: the forward alone; with --train: "
                   "30,000)")
    p.add_argument("--train", action="store_true",
                   help="profile one train step (device voxelize)")
    p.add_argument("--bins", type=int, default=5, help="voxel bins of the input")
    p.add_argument("--bf16", action="store_true",
                   help="with --train: the bf16 mixed-precision forward")
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


def _train_step(args, rng, device):
    """One train step on a fixed raw-event batch on the device."""
    from eemflow_tpu_torch.models.registry import get_model
    from eemflow_tpu_torch.train.optim import make_optimizer
    from eemflow_tpu_torch.train.trainer import create_train_state, make_train_step

    h, w = args.size
    n = args.events or 30000
    B = args.batch_size
    kw = train_kwargs(args)
    label = (16, 16) if kw.get("out_mesh_size") else (h, w)
    state = create_train_state(get_model(args.model, **kw), 0, make_optimizer(1e-4, num_steps=1000),
                               device=device)
    events = [np.stack([_packed_events(rng, n, h, w) for _ in range(B)]) for _ in range(2)]
    batch = {
        "events_old": events[0], "events_new": events[1],
        "n_old": np.full(B, n, np.int32), "n_new": np.full(B, n, np.int32),
        "flip_h": rng.random(B) < 0.5, "flip_v": rng.random(B) < 0.1,
        "flow": (rng.standard_normal((B, *label, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, *label), np.float32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    train_step = make_train_step(preprocess=make_device_preprocess(args.bins, h, w), mixed_precision=args.bf16)

    def step():
        train_step(state, batch)

    return step


def train_kwargs(args) -> dict:
    """The train step's model: EEMFlow at the meshflow label's resolution,
    the others at full resolution; the input channels the bins'."""
    kw = {"n_first_channels": args.bins}
    if args.model == "eemflow":
        kw["out_mesh_size"] = True
    return kw


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    h, w = args.size
    rng = np.random.default_rng(0)
    model_kwargs = {**train_kwargs(args), "mixed_precision": args.bf16} if args.train else mode_kwargs(args)
    if args.train:
        step = _train_step(args, rng, device)
    elif args.events:
        if args.batch_size != 1:
            raise SystemExit("--events profiles one sample: use -bs 1")
        model = get_eval_model(args.model, n_first_channels=args.bins, **model_kwargs)
        tester = Tester(model, device, preprocess=make_device_preprocess(args.bins, h, w))
        sample = {
            "events_old": _packed_events(rng, args.events, h, w), "n_old": np.int32(args.events),
            "events_new": _packed_events(rng, args.events, h, w), "n_new": np.int32(args.events),
        }

        def step():
            tester.run_sample(sample)
    else:
        model = get_eval_model(args.model, n_first_channels=args.bins, **model_kwargs).to(device)
        x1, x2 = (
            torch.from_numpy(rng.standard_normal((args.batch_size, h, w, args.bins)).astype(np.float32)).to(device)
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

    # kernels and copies; not the optimizer's user annotation, which the
    # profiler also lists on the device
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("Optimizer.")]
    busy_ms = device_busy_ms(trace)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    host_ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    host_ops.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    result = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "model": args.model, "modes": model_kwargs, "train": args.train,
        "size": [h, w], "batch": args.batch_size, "fast": args.fast,
        "fast_head": args.fast_head, "fast_pyramid": args.fast_pyramid, "events": args.events,
        "reps": args.reps, "ms_per_call": wall_ms / args.reps,
        "device_busy_share": busy_ms / wall_ms if busy_ms is not None else None,
        "device_ms_per_call": busy_ms / args.reps if busy_ms is not None else None,
        "device_summed_ms_per_call": sum(e.self_device_time_total for e in kernels) / 1e3 / args.reps,
        "top_kernels": [
            {
                "name": e.key[:120],
                "device_ms_per_call": e.self_device_time_total / 1e3 / args.reps,
                "launches_per_call": e.count / args.reps,
            }
            for e in kernels[:TOP]
        ],
        "launches_per_call": sum(e.count for e in kernels) / args.reps,
        "top_host_ops": [
            {
                "name": e.key[:120],
                "host_ms_per_call": e.self_cpu_time_total / 1e3 / args.reps,
                "calls_per_call": e.count / args.reps,
            }
            for e in host_ops[:TOP]
        ],
        "trace": trace,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
