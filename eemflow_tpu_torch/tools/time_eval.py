"""Time the EEMFlow eval forward of the port (counterpart of
``tools/time_eval.py`` for ``-model eemflow``): the user-facing A/B
between the standard and the fused modes.

On the card the forward is timed with CUDA events over ``--reps``
back-to-back calls after a warm-up; on the CPU (``--device cpu``) with the
host clock, and the result names the CPU.  The weights are random
(timing does not depend on them).  Prints one line with ms per image and
images per second beside the device's name, and returns them.

Usage:
  python -m eemflow_tpu_torch.tools.time_eval --size 720 1280 -bs 1 \\
      [--fast_head [--fast_head_impl plain]] [--fast_pyramid | --fast_pyramid_bf16] [--fast]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from eemflow_tpu_torch.device import resolve_device
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Time the EEMFlow eval forward (PyTorch port)")
    p.add_argument("--size", type=int, nargs=2, default=[720, 1280])
    p.add_argument("-bs", "--batch_size", type=int, default=2)
    p.add_argument("--bins", type=int, default=5)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--fast_head", action="store_true",
                   help="the whole coarse stage as one kernel (K4; f32 math, parity to "
                   "fp noise)")
    p.add_argument("--fast_head_impl", default="kernel", choices=["kernel", "plain"],
                   help="plain = the PyTorch twin of the fused head, the measurement control")
    p.add_argument("--fast_pyramid", action="store_true",
                   help="each pyramid level's stride-1 convs + pool as one kernel (K3; f32 "
                   "math, parity to fp noise)")
    p.add_argument("--fast_pyramid_bf16", action="store_true",
                   help="the fused pyramid with bf16 conv operands (f32 accumulation; not "
                   "for checkpoint-parity evaluation)")
    p.add_argument("--fast", action="store_true",
                   help="every parity-safe serving mode of the family (registry.fast_eval_kwargs)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    extra = {}
    if args.fast_head:
        extra.update(fast_head=True, fast_head_impl=args.fast_head_impl)
    if args.fast_pyramid or args.fast_pyramid_bf16:
        extra["fast_pyramid"] = True
        if args.fast_pyramid_bf16:
            extra["fast_pyramid_dtype"] = "bf16"
    if args.fast:
        extra.update(fast_eval_kwargs("eemflow"))
    torch.manual_seed(0)
    model = get_eval_model("eemflow", n_first_channels=args.bins, **extra).to(device)
    h, w = args.size
    rng = np.random.default_rng(0)
    x1, x2 = (
        torch.from_numpy(rng.standard_normal((args.batch_size, h, w, args.bins)).astype(np.float32)).to(device)
        for _ in range(2)
    )

    def forward():
        with torch.inference_mode():
            return model(x1, x2)[1][-1]

    for _ in range(3):
        forward()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            forward()
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / args.reps
        name = torch.cuda.get_device_name(device)
    else:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            forward()
        ms = (time.perf_counter() - t0) * 1e3 / args.reps
        name = "cpu"
    per_img = ms / args.batch_size
    modes = ",".join(f"{k}={v}" for k, v in sorted(extra.items())) or "standard"
    print(
        f"eemflow @ {h}x{w} b={args.batch_size} ({modes}): {per_img:.3f} ms/img, "
        f"{1e3 / per_img:.1f} fps ({name})",
        flush=True,
    )
    return {"device": name, "modes": extra, "ms_per_forward": ms, "ms_per_img": per_img,
            "fps": 1e3 / per_img}


if __name__ == "__main__":
    main()
