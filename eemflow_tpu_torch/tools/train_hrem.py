"""HREM training CLI of the port (counterpart of ``tools/train_hrem.py``;
reference ``train_EEMFlow_HREM.py``).

Builds a registry model (EEMFlow, EEMFlow+, ERAFT, RAFT, GMA, SKFlow or
KPAFlow) with its
parameters drawn from ``--seed`` and its input channels from the config's
``num_voxel_bins``, loads a JSON config (the flags take the learning rate
and weight decay, as in the JAX CLI), and trains with the AdamW +
OneCycle recipe on the card (or the CPU with ``--device cpu``), logging
every 10 steps to ``log.txt`` and ``metrics.jsonl`` and checkpointing
parameters, BatchNorm statistics, optimizer, schedule and step each epoch
(``-se N`` resumes from epoch N).  EEMFlow predicts at the 16×16 mesh
resolution of the HREM meshflow labels unless ``--full_res_flow``; the
other models predict at full resolution only, so they need
``--full_res_flow`` (the JAX CLI would fail at the loss's broadcast; this
one refuses before the first step).  ``--device_voxelize`` reads raw
events and voxelizes them on the device (kernel K1, once a frame); mixed
precision (``--bf16`` or the config's ``mixed_precision``) runs the
forward on bf16 copies of the float32 parameters (``train.trainer``).  The
JAX CLI's ``--viz`` comes with the port's ``viz`` package.

Usage:
  python -m eemflow_tpu_torch.tools.train_hrem -model eemflow -int dt1 \
      --data_root dataset/HREM --config configs/hrem_meshflow.json -bs 6 \
      --lr 1e-5 --train_iters 6000000 --val_iters 10000 [-se N] \
      [--device_voxelize] [--bf16] [--device cpu]
  python -m eemflow_tpu_torch.tools.train_hrem -model eemflow_plus \
      --config configs/hrem_eemflow_plus.json --full_res_flow [...]
  python -m eemflow_tpu_torch.tools.train_hrem -model eraft --full_res_flow [...]
  python -m eemflow_tpu_torch.tools.train_hrem -model gma --full_res_flow [...]   (also skflow, kpaflow)
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from eemflow_tpu_torch.data.device_input import make_device_preprocess
from eemflow_tpu_torch.data.hrem import HREMEventFlow
from eemflow_tpu_torch.data.loader import ArenaCollate, batch_iterator, prefetch
from eemflow_tpu_torch.device import resolve_device
from eemflow_tpu_torch.models.registry import get_model
from eemflow_tpu_torch.train.adapters import get_family
from eemflow_tpu_torch.train.checkpoint import restore_checkpoint
from eemflow_tpu_torch.train.optim import make_optimizer
from eemflow_tpu_torch.train.trainer import Trainer, TrainState, batch_to_device, create_train_state
from eemflow_tpu_torch.utils.config import (
    create_save_path,
    load_config,
    model_kwargs_from_config,
    snapshot_config,
)
from eemflow_tpu_torch.utils.logger import Logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train on HREM (PyTorch port)")
    p.add_argument("-model", default="eemflow")
    p.add_argument("-int", dest="event_interval", default="dt1", choices=["dt1", "dt4"])
    p.add_argument("--config", default="configs/hrem_meshflow.json")
    p.add_argument("--data_root", default="dataset/HREM")
    p.add_argument("-bs", "--batch_size", type=int, default=6)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--train_iters", type=int, default=6000000)
    p.add_argument("--val_iters", type=int, default=10000)
    p.add_argument("-se", "--start_epoch", type=int, default=None)
    p.add_argument("--save_dir", default="runs/hrem")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full_res_flow", action="store_true",
                   help="train against the full-resolution flow instead of the 16x16 meshflow")
    p.add_argument("--device_voxelize", action="store_true",
                   help="voxelize raw events on the device (kernel K1); the host only pads event buffers")
    p.add_argument("--bucket_rungs", type=int, default=4,
                   help="event bucket ladder rungs (1 = fixed worst-case bucket)")
    p.add_argument("--bucket_size", type=int, default=1 << 18,
                   help="event bucket size for --device_voxelize")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision training (float32 master parameters)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    args = build_parser().parse_args(argv)
    family = get_family(args.model)  # a model the port does not train raises here
    # only EEMFlow predicts at the meshflow label's 16x16 (out_mesh_size)
    if args.model != "eemflow" and not args.full_res_flow:
        raise SystemExit(
            f"-model {args.model} predicts at full resolution and the HREM meshflow label is 16x16: "
            f"train it with --full_res_flow")
    device = resolve_device(args.device)
    # full float32 convolutions and matmuls (cuDNN would otherwise run float32
    # convolutions in TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = load_config(args.config) if os.path.exists(args.config) else {}
    train_cfg = cfg.get("train", {})
    loader_args = cfg.get("data_loader", {}).get("train", {}).get("args", {})
    aug = loader_args.get("aug_params", {"crop_size": [512, 960], "do_flip": True})

    save_path = create_save_path(args.save_dir, f"{args.model}_{args.event_interval}", args.lr, args.wd)
    logger = Logger(save_path)
    snapshot_config({**cfg, "cli": vars(args)}, save_path)

    # meshflow training: EEMFlow predicts at the mesh resolution (16x16) of
    # the HREM labels (the reference's out_mesh_size branch)
    num_bins = loader_args.get("num_voxel_bins", 5)
    model_kwargs = model_kwargs_from_config(args.model, cfg)
    if args.model == "eemflow" and not args.full_res_flow:
        model_kwargs["out_mesh_size"] = True
    # flax infers the first conv's input channels from the batch; a torch
    # module fixes them, so they come from the data
    model_kwargs["n_first_channels"] = num_bins
    model = get_model(args.model, **model_kwargs)
    tx = make_optimizer(
        lr=args.lr,
        wdecay=args.wd,
        epsilon=train_cfg.get("epsilon", 1e-8),
        num_steps=args.train_iters,
        clip=train_cfg.get("clip", 1.0),
    )

    dataset = HREMEventFlow(
        args.data_root,
        dt=args.event_interval,
        train=True,
        num_bins=num_bins,
        aug_params=aug,
        rng=np.random.default_rng(args.seed),
        raw_events=args.device_voxelize,
        bucket_size=args.bucket_size,
        bucket_rungs=args.bucket_rungs,
        full_res_flow=args.full_res_flow,
    )
    logger.write_line(f"dataset: {len(dataset)} samples", True)
    preprocess = (
        make_device_preprocess(num_bins, dataset.image_height, dataset.image_width)
        if args.device_voxelize else None
    )
    batches = prefetch(
        batch_iterator(
            dataset, args.batch_size, shuffle=True, seed=args.seed,
            # rotating collate buffers: slots = prefetch depth + 2, so that a
            # batch still queued or being copied is never overwritten
            collate_fn=ArenaCollate(slots=4),
        )
    )

    state = create_train_state(model, args.seed, tx, device=device)
    start_epoch = 0
    ckpt_dir = os.path.join(save_path, "ckpt")
    if args.start_epoch is not None:
        state, start_epoch = restore_checkpoint(ckpt_dir, state, args.start_epoch)
        logger.write_line(f"resumed from epoch {start_epoch}", True)

    mixed_precision = args.bf16 or bool(train_cfg.get("mixed_precision", False))
    trainer = Trainer(gamma=train_cfg.get("gamma", 0.8), family=family, preprocess=preprocess,
                      mixed_precision=mixed_precision, logger=logger, checkpoint_dir=ckpt_dir)
    n_epochs = args.train_iters // args.val_iters
    on_device = (batch_to_device(b, device) for b in batches)
    for epoch in range(start_epoch, n_epochs):
        state = trainer.train_iters(state, on_device, start_epoch=epoch, val_iters=args.val_iters)
    return state


if __name__ == "__main__":
    main()
