"""HREM evaluation CLI of the port (counterpart of ``tools/test_hrem.py``;
reference ``test_EEMFlow_HREM.py``).

Loads a released PyTorch ``.pth.tar`` and runs the per-sequence HREM
protocol ({indoor,outdoor}×{fast,slow}, mean of per-sequence AEE) on the
card, or on the CPU with ``--device cpu``.  ``--config`` names a JSON file
whose top-level keys that are model constructor fields go to the model
(``{"fused_update": true}`` runs ERAFT's update block as kernel K5,
``{"stacked_lookup": true}`` its lookup over the stacked levels); the
model's input channels are the data's voxel bins.  The
checkpoint goes through ``compat.torch_loader.load_model_checkpoint``: a
released ``.pth.tar`` or the port's own ``epoch_N.pt``, EEMFlow+'s dead
keys dropped, the correlation ``index`` buffer the model's own.
``--mode`` runs a research mode of ``eval.runner.ResearchTester`` on the
first available sequence (``save_flow``: ``.flo`` and HSV pictures;
``low_epe``; ``warp``; ``density``: AEE by event density;
``dsec_submission``: 16-bit PNGs), its files under
``<save_dir>/<model>_<int>/<mode>/``.

Usage:
  python -m eemflow_tpu_torch.tools.test_hrem -model eemflow -int dt1 \
      --data_root dataset/HREM --checkpoint EEMFlow_HREM_dt1.pth.tar \
      [--device_voxelize] [--eval_batch 2] [--fast_head] [--fast_pyramid] [--fast] [--device cpu]
      [--mode save_flow|low_epe|warp|density|dsec_submission]
  python -m eemflow_tpu_torch.tools.test_hrem -model eemflow_plus -int dt1 \
      --checkpoint EEMFlow+_HREM_dt1.pth.tar [--fast_pyramid --fast_decoders --fast_sgu]
  python -m eemflow_tpu_torch.tools.test_hrem -model eraft -int dt1 \
      --checkpoint eraft.pth.tar --max_samples 1 [--config cfg.json] [--stride 2]
  python -m eemflow_tpu_torch.tools.test_hrem -model raft -int dt1 --checkpoint raft.pth.tar
  python -m eemflow_tpu_torch.tools.test_hrem -model gma -int dt1 --checkpoint gma.pth.tar \
      [--device_voxelize]   (also -model skflow, kpaflow, gmflow, flowformer and the IRR-PWC and
      FlowNet line)
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
from eemflow_tpu_torch.data.device_input import make_device_preprocess
from eemflow_tpu_torch.data.hrem import HREM_SEQUENCES, HREMEventFlow
from eemflow_tpu_torch.device import resolve_device
from eemflow_tpu_torch.eval.runner import ResearchTester
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model
from eemflow_tpu_torch.utils.config import load_config, model_kwargs_from_config


# the fused eval modes a flag of the same name turns on
FUSED_FLAGS = ("fast_head", "fast_pyramid", "fast_decoders", "fast_sgu")
# the research modes of the HREM CLI (the MVSEC CLI adds warp_loss and multi_key)
HREM_MODES = ResearchTester.MODES[:5]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate on HREM (PyTorch port)")
    p.add_argument("-model", default="eemflow")
    p.add_argument("-int", dest="event_interval", default="dt1", choices=["dt1", "dt4"])
    p.add_argument("--data_root", default="dataset/HREM")
    p.add_argument("--checkpoint", required=True,
                   help="released .pth/.pth.tar checkpoint, or the port's own epoch_N.pt")
    p.add_argument("--save_dir", default="runs/hrem_eval")
    p.add_argument("--stride", type=int, default=1, help="evaluate every stride-th sample")
    p.add_argument("--max_samples", type=int, default=None,
                   help="at most this many samples per sequence")
    p.add_argument("--save_csv", action="store_true")
    p.add_argument("--mode", default="standard", choices=("standard",) + HREM_MODES,
                   help="'standard' = the protocol eval; the others are the research modes "
                   "(reference test_mvsec.py), on the first available sequence")
    p.add_argument("--config", default=None,
                   help="optional config JSON carrying model hyperparameters")
    p.add_argument("--device_voxelize", action="store_true",
                   help="voxelize raw events on the device (kernel K1)")
    p.add_argument("--bucket_size", type=int, default=1 << 18)
    p.add_argument("--eval_batch", type=int, default=1,
                   help="samples per batched forward (per-sample metrics unchanged)")
    p.add_argument("--bucket_rungs", type=int, default=1,
                   help="event bucket ladder rungs (eval default: fixed bucket)")
    p.add_argument("--fast_head", action="store_true",
                   help="EEMFlow: the whole coarse stage as one kernel (K4; f32 "
                   "math, parity to fp noise — safe for checkpoint evals)")
    p.add_argument("--fast_pyramid", action="store_true",
                   help="EEMFlow, EEMFlow+: each pyramid level's stride-1 convs (+ pool) "
                   "as one kernel (K3; f32 math, parity to fp noise)")
    p.add_argument("--fast_decoders", action="store_true",
                   help="EEMFlow+: each level's 7-conv decoder as one K3 chain (f32 math, "
                   "parity to fp noise — safe for checkpoint evals)")
    p.add_argument("--fast_sgu", action="store_true",
                   help="EEMFlow+: the SGU's dense estimator as one K3 concat chain (f32 "
                   "math, parity to fp noise)")
    p.add_argument("--fast", action="store_true",
                   help="every parity-safe serving mode of the family "
                   "(registry.fast_eval_kwargs)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None):
    """Runs the eval; returns the per-sequence results (``--mode standard``)
    or what the research mode returns."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # parity mode: full float32 convolutions and matmuls (cuDNN would
    # otherwise run float32 convolutions in TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    dataset = HREMEventFlow(
        args.data_root, dt=args.event_interval,
        raw_events=args.device_voxelize, bucket_size=args.bucket_size,
        bucket_rungs=args.bucket_rungs,
    )
    cfg = load_config(args.config) if args.config else {}
    model_kwargs = model_kwargs_from_config(args.model, cfg)
    model_kwargs.update({k: True for k in FUSED_FLAGS if getattr(args, k)})
    if args.fast:
        model_kwargs.update(fast_eval_kwargs(args.model))
    # the first conv's input channels are the data's (flax infers them)
    model_kwargs.setdefault("n_first_channels", dataset.num_bins)
    model = get_eval_model(args.model, **model_kwargs)
    try:
        load_model_checkpoint(model, args.checkpoint, args.model, log=lambda m: print(m, flush=True))
    except ValueError as e:
        raise SystemExit(str(e)) from None

    preprocess = (
        make_device_preprocess(dataset.num_bins, dataset.image_height, dataset.image_width)
        if args.device_voxelize else None
    )
    save_path = os.path.join(args.save_dir, f"{args.model}_{args.event_interval}")
    tester = ResearchTester(model, device, save_path=save_path, save_csv=args.save_csv,
                            preprocess=preprocess)
    seqs = [s for s in HREM_SEQUENCES if s in dataset.nori_list] or list(HREM_SEQUENCES)
    if args.mode == "standard":
        return tester.test_multi_sequence(dataset, seqs, stride=args.stride, max_samples=args.max_samples,
                                          batch_size=args.eval_batch)
    dataset.change_test_sequence(seqs[0])
    return tester.run_mode(args.mode, dataset, os.path.join(save_path, args.mode), stride=args.stride,
                           max_samples=args.max_samples)


if __name__ == "__main__":
    main()
