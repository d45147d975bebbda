"""MVSEC evaluation CLI of the port (counterpart of ``tools/test_mvsec.py``;
reference ``test_mvsec.py``), for the two-volume models (``eemflow``,
``eemflow_plus``, ``eraft``, ``raft``, ``gma``, ``skflow``, ``kpaflow``,
``gmflow``, ``flowformer`` and the IRR-PWC and FlowNet line).

Evaluates one sequence under the dense or the sparse protocol with the
reference's masks: the 256×256 centre crop of the validation frames,
``is_car`` (the first 190 rows only) on the outdoor sequences, the old
window's event mask for sparse; a per-sample CSV and stride subsampling.
Runs on the card, or on the CPU with ``--device cpu``.
``--device_voxelize`` reads raw events and voxelizes them on the device
(kernel K1 over the whole 260×346 frame, then the centre crop); ``--fast``
and the ``--fast_*`` flags run the family's fused eval modes (EEMFlow: K3
and K4).  ``--frames START END`` replaces the sequence's valid frame range
for this run (subset evals, synthetic fixtures).  The checkpoint goes
through ``compat.torch_loader.load_model_checkpoint`` as in ``test_hrem``.

``--mode`` runs a research mode of ``eval.runner.ResearchTester``
(``save_flow``, ``low_epe``, ``warp``, ``density``, ``dsec_submission``,
``warp_loss``: the probe-point flow error, ``multi_key``: the key-map
density CSV), its files under ``<save_dir>/<model>_<int>_<sequence>/<mode>/``.

Not ported yet: ``--shard_eval`` (``ROADMAP.md`` section 1 item 6) and the
JAX CLI's ``--seg_bucket`` (the raw-segment family, item 7).

Usage:
  python -m eemflow_tpu_torch.tools.test_mvsec -model eemflow -int dt1 \
      --sequence indoor_flying1 --data_root dataset/MVSEC --checkpoint <ckpt> \
      --eval_type dense --stride 30 [--device_voxelize] [--fast] [--eval_batch 2] [--device cpu]
      [--mode save_flow|low_epe|warp|density|dsec_submission|warp_loss|multi_key]
  python -m eemflow_tpu_torch.tools.test_mvsec -model kpaflow -int dt1 --checkpoint kpaflow.pth.tar \
      [--device_voxelize]   (also -model gma, skflow, gmflow, flowformer, irrpwc, pwcnet_irr_occ_bi, ...)
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
from eemflow_tpu_torch.data.device_input import make_device_preprocess
from eemflow_tpu_torch.data.mvsec import VAL_CROP, VALID_TIME_INDEX, MvsecEventFlow, MvsecEventFlow_dt4
from eemflow_tpu_torch.device import resolve_device
from eemflow_tpu_torch.eval.runner import ResearchTester
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model
from eemflow_tpu_torch.tools.test_hrem import FUSED_FLAGS
from eemflow_tpu_torch.utils.config import load_config, model_kwargs_from_config
from eemflow_tpu_torch.utils.logger import Logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate on MVSEC (PyTorch port)")
    p.add_argument("-model", default="eemflow")
    p.add_argument("-int", dest="event_interval", default="dt1", choices=["dt1", "dt4"])
    p.add_argument("--sequence", default="indoor_flying1")
    p.add_argument("--data_root", default="dataset/MVSEC")
    p.add_argument("--checkpoint", required=True,
                   help="released .pth/.pth.tar checkpoint, or the port's own epoch_N.pt")
    p.add_argument("--eval_type", default="dense", choices=["dense", "sparse"])
    p.add_argument("--stride", type=int, default=30)
    p.add_argument("--save_dir", default="runs/mvsec_eval")
    p.add_argument("--save_csv", action="store_true")
    p.add_argument("--mode", default="standard", choices=("standard",) + ResearchTester.MODES,
                   help="'standard' = the protocol eval; the others are the research modes (reference "
                   "test_mvsec.py)")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--device_voxelize", action="store_true",
                   help="voxelize raw events on the device (kernel K1; the centre crop included)")
    p.add_argument("--bucket_size", type=int, default=1 << 17)
    p.add_argument("--eval_batch", type=int, default=1,
                   help="samples per batched forward (per-sample metrics unchanged)")
    p.add_argument("--bucket_rungs", type=int, default=1,
                   help="event bucket ladder rungs (eval default: fixed bucket)")
    p.add_argument("--frames", type=int, nargs=2, default=None, metavar=("START", "END"),
                   help="replace the sequence's valid frame range (reference MVSEC.py:24-31 table) "
                   "for this run: subset evals and synthetic fixtures")
    p.add_argument("--config", default=None,
                   help="optional config JSON carrying model hyperparameters")
    p.add_argument("--fast_head", action="store_true",
                   help="EEMFlow: the whole coarse stage as one kernel (K4)")
    p.add_argument("--fast_pyramid", action="store_true",
                   help="EEMFlow, EEMFlow+: each pyramid level's stride-1 convs (+ pool) as one kernel (K3)")
    p.add_argument("--fast_decoders", action="store_true",
                   help="EEMFlow+: each level's 7-conv decoder as one K3 chain")
    p.add_argument("--fast_sgu", action="store_true",
                   help="EEMFlow+: the SGU's dense estimator as one K3 concat chain")
    p.add_argument("--fast", action="store_true",
                   help="every parity-safe serving mode of the family (registry.fast_eval_kwargs)")
    p.add_argument("--shard_eval", action="store_true",
                   help="shard batched eval forwards over the devices (not ported yet)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None):
    """Runs the eval; returns the sequence's results (``--mode standard``) or
    what the research mode returns."""
    args = build_parser().parse_args(argv)
    if args.shard_eval:
        raise SystemExit("--shard_eval: multi-device eval is not ported yet (ROADMAP.md section 1 item 6)")
    device = resolve_device(args.device)
    # parity mode: full float32 convolutions and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    valid_time_index = dict(VALID_TIME_INDEX)
    if args.frames is not None:
        valid_time_index[args.sequence] = [tuple(args.frames)]
    ds_cls = MvsecEventFlow if args.event_interval == "dt1" else MvsecEventFlow_dt4
    dataset = ds_cls(
        args.data_root, sequence=args.sequence, train=False, eval_type=args.eval_type,
        raw_events=args.device_voxelize, bucket_size=args.bucket_size, bucket_rungs=args.bucket_rungs,
        valid_time_index=valid_time_index,
    )
    cfg = load_config(args.config) if args.config else {}
    model_kwargs = model_kwargs_from_config(args.model, cfg)
    model_kwargs.update({k: True for k in FUSED_FLAGS if getattr(args, k)})
    if args.fast:
        model_kwargs.update(fast_eval_kwargs(args.model))
    model_kwargs.setdefault("n_first_channels", dataset.num_bins)
    model = get_eval_model(args.model, **model_kwargs)
    try:
        load_model_checkpoint(model, args.checkpoint, args.model, log=lambda m: print(m, flush=True))
    except ValueError as e:
        raise SystemExit(str(e)) from None

    preprocess = (
        make_device_preprocess(dataset.num_bins, dataset.image_height, dataset.image_width,
                               crop_size=(VAL_CROP, VAL_CROP))
        if args.device_voxelize else None
    )
    save_path = os.path.join(args.save_dir, f"{args.model}_{args.event_interval}_{args.sequence}")
    logger = Logger(save_path)
    tester = ResearchTester(model, device, save_path=save_path, save_csv=args.save_csv, preprocess=preprocess,
                            is_car="outdoor" in args.sequence)
    if args.mode != "standard":
        return tester.run_mode(args.mode, dataset, os.path.join(save_path, args.mode), stride=args.stride,
                               max_samples=args.max_samples)
    res = tester.test_sequence(dataset, stride=args.stride, max_samples=args.max_samples,
                               batch_size=args.eval_batch)
    logger.write_line(
        f"[{args.sequence}/{args.eval_type}] AEE {res['AEE']:.6f} "
        f"1px-out {res['pct1_outlier']:.6f} 3px-out {res['pct3_outlier']:.6f} "
        f"({res['n_samples']} samples)",
        True,
    )
    return res


if __name__ == "__main__":
    main()
