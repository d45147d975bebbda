"""MVSEC training CLI of the port (counterpart of ``tools/train_mvsec.py``;
reference ``train_mvsec.py`` engine), for the two-volume models
(``eemflow``, ``eemflow_plus``, ``eraft``, ``raft``, ``gma``, ``skflow``,
``kpaflow``, ``gmflow``, ``flowformer`` and the IRR-PWC and FlowNet line,
which train with the default config).

Builds a registry model with its parameters drawn from ``--seed`` and its
input channels from the config's ``num_voxel_bins``, loads a JSON config
(its ``aug_params``, bins and ``mixed_precision``; the flags take the
learning rate and weight decay, as in the JAX CLI), and trains with the
AdamW + OneCycle recipe on the card (or the CPU with ``--device cpu``)
against the full-resolution flow (the JAX CLI sets no ``out_mesh_size``),
logging to ``log.txt`` and ``metrics.jsonl`` and checkpointing each epoch
(``-se N`` resumes from epoch N).  The host path voxelizes on the host and
runs the augmentor's resize branch (scale, stretch, flips, a random crop
of ``crop_size``); ``--device_voxelize`` reads raw events and voxelizes the
full 260×346 frame on the device (kernel K1, once a frame), then flips and
crops it there with the flips and offsets drawn on the host.  Mixed
precision (``--bf16`` or the config's ``mixed_precision``) runs the forward
on bf16 copies of the float32 parameters (``train.trainer``).

Usage:
  python -m eemflow_tpu_torch.tools.train_mvsec -model eraft -int dt1 \
      --sequence outdoor_day2 --data_root dataset/MVSEC --config configs/mvsec_eraft.json \
      -bs 6 --lr 1e-4 [-se N] [--device_voxelize] [--bf16] [--device cpu]
  python -m eemflow_tpu_torch.tools.train_mvsec -model skflow --config configs/mvsec_skflow.json -bs 6 [...]
      (also gma, kpaflow, gmflow -bs 8 and flowformer with configs/mvsec_<model>.json;
      irrpwc, irrpwc_occ, pwcnet*, flownet1s*, irr_flownet with the default config, -bs 8)
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from eemflow_tpu_torch.data.device_input import make_device_preprocess
from eemflow_tpu_torch.data.loader import ArenaCollate, batch_iterator, prefetch
from eemflow_tpu_torch.data.mvsec import MvsecEventFlow, MvsecEventFlow_dt4
from eemflow_tpu_torch.device import resolve_device
from eemflow_tpu_torch.models.registry import get_model
from eemflow_tpu_torch.train.adapters import get_family
from eemflow_tpu_torch.train.checkpoint import restore_checkpoint
from eemflow_tpu_torch.train.optim import make_optimizer
from eemflow_tpu_torch.train.trainer import Trainer, TrainState, batch_to_device, create_train_state
from eemflow_tpu_torch.utils.config import create_save_path, load_config, model_kwargs_from_config, snapshot_config
from eemflow_tpu_torch.utils.logger import Logger

DEFAULT_AUG = {"crop_size": [256, 256], "min_scale": -0.2, "max_scale": 0.5, "do_flip": True}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train on MVSEC (PyTorch port)")
    p.add_argument("-model", default="eemflow")
    p.add_argument("-int", dest="event_interval", default="dt1", choices=["dt1", "dt4"])
    p.add_argument("--sequence", default="outdoor_day2")
    p.add_argument("--config", default="configs/mvsec_event_flow_dense.json")
    p.add_argument("--data_root", default="dataset/MVSEC")
    p.add_argument("-bs", "--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--train_iters", type=int, default=200000)
    p.add_argument("--val_iters", type=int, default=5000)
    p.add_argument("-se", "--start_epoch", type=int, default=None)
    p.add_argument("--save_dir", default="runs/mvsec")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device_voxelize", action="store_true",
                   help="voxelize raw events on the device (kernel K1); augmentation is then flips and the crop")
    p.add_argument("--bucket_size", type=int, default=1 << 17)
    p.add_argument("--bucket_rungs", type=int, default=4,
                   help="event bucket ladder rungs (1 = fixed worst-case bucket)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision training (float32 master parameters)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    args = build_parser().parse_args(argv)
    family = get_family(args.model)  # a model the port does not train raises here
    device = resolve_device(args.device)
    # full float32 convolutions and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = load_config(args.config) if os.path.exists(args.config) else {}
    train_args = cfg.get("data_loader", {}).get("train", {}).get("args", {})
    aug = train_args.get("aug_params", DEFAULT_AUG)
    num_bins = train_args.get("num_voxel_bins", 5)
    ds_cls = MvsecEventFlow if args.event_interval == "dt1" else MvsecEventFlow_dt4
    dataset = ds_cls(
        args.data_root, sequence=args.sequence, train=True, num_bins=num_bins,
        eval_type=train_args.get("eval_type", "dense"), aug_params=aug,
        rng=np.random.default_rng(args.seed), raw_events=args.device_voxelize,
        bucket_size=args.bucket_size, bucket_rungs=args.bucket_rungs,
    )
    save_path = create_save_path(args.save_dir, f"{args.model}_{args.event_interval}_{args.sequence}",
                                 args.lr, args.wd)
    logger = Logger(save_path)
    snapshot_config({**cfg, "cli": vars(args)}, save_path)
    logger.write_line(f"dataset: {len(dataset)} samples", True)

    model_kwargs = model_kwargs_from_config(args.model, cfg)
    # flax infers the first conv's input channels from the batch; a torch
    # module fixes them, so they come from the data
    model_kwargs["n_first_channels"] = num_bins
    model = get_model(args.model, **model_kwargs)
    tx = make_optimizer(lr=args.lr, wdecay=args.wd, num_steps=args.train_iters)

    preprocess = None
    if args.device_voxelize:
        # the dataset crops the label with the offsets it hands on; the device
        # voxelizes the full frame, flips, then crops the grids with them
        crop = tuple(aug["crop_size"]) if aug.get("crop_size") else None
        if crop == (dataset.image_height, dataset.image_width):
            crop = None
        preprocess = make_device_preprocess(num_bins, dataset.image_height, dataset.image_width, crop_size=crop)
    batches = prefetch(
        batch_iterator(dataset, args.batch_size, shuffle=True, seed=args.seed, collate_fn=ArenaCollate(slots=4))
    )

    state = create_train_state(model, args.seed, tx, device=device)
    start_epoch = 0
    ckpt_dir = os.path.join(save_path, "ckpt")
    if args.start_epoch is not None:
        state, start_epoch = restore_checkpoint(ckpt_dir, state, args.start_epoch)
        logger.write_line(f"resumed from epoch {start_epoch}", True)

    mixed_precision = args.bf16 or bool(cfg.get("train", {}).get("mixed_precision", False))
    trainer = Trainer(family=family, preprocess=preprocess, mixed_precision=mixed_precision, logger=logger,
                      checkpoint_dir=ckpt_dir)
    on_device = (batch_to_device(b, device) for b in batches)
    for epoch in range(start_epoch, args.train_iters // args.val_iters):
        state = trainer.train_iters(state, on_device, start_epoch=epoch, val_iters=args.val_iters)
    return state


if __name__ == "__main__":
    main()
