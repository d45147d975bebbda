"""Time the eval forward of the port (counterpart of ``tools/time_eval.py``
for ``-model eemflow``, ``eemflow_plus``, ``eraft``, ``gma``, ``skflow`` and
``kpaflow``): the user-facing
A/B between the standard and the fused modes.

On the card the forward is timed with CUDA events over ``--reps``
back-to-back calls after a warm-up; on the CPU (``--device cpu``) with the
host clock, and the result names the CPU.  The weights are random
(timing does not depend on them) unless ``--checkpoint`` names a release
or an ``epoch_N.pt`` (``compat.torch_loader.load_model_checkpoint``).  Prints one line with ms per image and
images per second beside the device's name, and returns them.

Usage:
  python -m eemflow_tpu_torch.tools.time_eval --size 720 1280 -bs 1 \\
      [--fast_head [--fast_head_impl plain]] [--fast_pyramid | --fast_pyramid_bf16] [--fast]
  python -m eemflow_tpu_torch.tools.time_eval -model eemflow_plus --size 720 1280 -bs 1 \\
      [--fast_pyramid --fast_decoders --fast_sgu [--fast_pyramid_bf16]]
  python -m eemflow_tpu_torch.tools.time_eval -model eraft --size 720 1280 -bs 1 \\
      [--fused_update | --fused_update_bf16] [--corr_fast]
  python -m eemflow_tpu_torch.tools.time_eval -model gma --size 720 1280 -bs 1   (also skflow, kpaflow)
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
from eemflow_tpu_torch.device import resolve_device
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model


# the models the tools time and profile
MODELS = ["eemflow", "eemflow_plus", "eraft", "gma", "skflow", "kpaflow"]


def add_mode_flags(p: argparse.ArgumentParser) -> None:
    """The model and its eval modes, as the JAX tool spells them."""
    p.add_argument("-model", default="eemflow", choices=MODELS)
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
                   "for checkpoint-parity evaluation); EEMFlow+: every fused mode's operands")
    p.add_argument("--fast_decoders", action="store_true",
                   help="EEMFlow+: each decoder as one K3 chain (f32 math, parity to fp noise)")
    p.add_argument("--fast_sgu", action="store_true",
                   help="EEMFlow+: the SGU's dense estimator as one K3 concat chain (f32 math, "
                   "parity to fp noise)")
    p.add_argument("--fast", action="store_true",
                   help="every parity-safe serving mode of the family (registry.fast_eval_kwargs)")
    p.add_argument("--corr_fast", action="store_true",
                   help="ERAFT: bf16-stored correlation volumes and bf16 tap lookup, f32 "
                   "accumulation (not for checkpoint-parity evaluation)")
    p.add_argument("--fused_update", action="store_true",
                   help="ERAFT: the update block without its mask head as kernel K5 (f32 "
                   "math, parity to fp noise)")
    p.add_argument("--fused_update_bf16", action="store_true",
                   help="ERAFT: K5 with bf16 conv operands (f32 accumulation; not "
                   "checkpoint-parity)")
    p.add_argument("--stacked_lookup", action="store_true",
                   help="ERAFT: the correlation levels stacked once and looked up in one "
                   "gather an iteration (the same function)")


def mode_kwargs(args) -> dict:
    """Constructor kwargs of the modes the flags ask for."""
    extra = {}
    if args.fast_head:
        extra.update(fast_head=True, fast_head_impl=args.fast_head_impl)
    if args.fast_pyramid or args.fast_pyramid_bf16:
        extra["fast_pyramid"] = True
        if args.fast_pyramid_bf16:
            extra["fast_dtype" if args.model == "eemflow_plus" else "fast_pyramid_dtype"] = "bf16"
    for flag in ("fast_decoders", "fast_sgu"):
        if getattr(args, flag):
            extra[flag] = True
    for flag in ("corr_fast", "stacked_lookup"):
        if getattr(args, flag):
            extra[flag] = True
    if args.fused_update or args.fused_update_bf16:
        extra["fused_update"] = True
        if args.fused_update_bf16:
            extra["fused_dtype"] = "bf16"
    if args.fast:
        extra.update(fast_eval_kwargs(args.model))
    return extra


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Time the eval forward (PyTorch port)")
    p.add_argument("--size", type=int, nargs=2, default=[720, 1280])
    p.add_argument("-bs", "--batch_size", type=int, default=2)
    p.add_argument("--bins", type=int, default=5)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--checkpoint", default=None,
                   help="optional .pth/.pth.tar release or epoch_N.pt (default: random weights)")
    add_mode_flags(p)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    extra = mode_kwargs(args)
    torch.manual_seed(0)
    model = get_eval_model(args.model, n_first_channels=args.bins, **extra)
    if args.checkpoint:
        load_model_checkpoint(model, args.checkpoint, args.model)
    model.to(device)
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
        f"{args.model} @ {h}x{w} b={args.batch_size} ({modes}): {per_img:.3f} ms/img, "
        f"{1e3 / per_img:.1f} fps ({name})",
        flush=True,
    )
    return {"device": name, "model": args.model, "modes": extra, "ms_per_forward": ms, "ms_per_img": per_img,
            "fps": 1e3 / per_img}


if __name__ == "__main__":
    main()
