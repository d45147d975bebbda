#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``eemflow_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right and runs
its main paths on the card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 0,1,2,3g    # only the named phases (0 and
                                               # 1 always; 4 needs 2-3g)
    python3 chip_smoke.py --k3-bf16-seeds 20   # only K3's bf16 check on
                                               # EEMFlow+'s chains, 20 draws

Phases, each announced on a flushed line so a run that is cut off shows
where it stopped:

  0. device: the card's name, the device count, and the card's name and
     power limit as ``nvidia-smi`` reports them;
  1. build: the kernels' ``nvcc`` calls, one per source, all started
     together (seconds, and the ``-Xptxas -v`` lines: registers and spills
     of each kernel), and the C++ event packer's ``g++`` (it must load: the
     serving path's packer runs native);
  2. each kernel against its plain PyTorch twin at the main paths' shapes
     (K1 ``voxel_scatter`` and ``voxelize`` on the main path's batch and
     the edge cases: n_valid 0 and 1, every event out of frame, every event
     on one pixel (each side against the float64 sum of the same votes,
     within a float32 sum's bound n·u·Σ|v|), a frame that is not whole
     tiles, 15 bins, MVSEC's 260×346 frame with a dt4 window and with
     every event in the partial edge tiles; K2 local
     correlation, ``local_corr_levels`` on the permuted views of the
     forward's pooled levels in float32 at B=1 and 2 and on bf16 operands
     (the training forward's mixed precision) at B=1 and 6, and on
     MVSEC's 4×4 levels (256×256), and K2's
     backward, one level (``LocalCorr``) and three in one launch
     (``LocalCorrLevels``, float32 and bf16); K2 at the PWC nets' cost
     volumes (K=81 on NHWC views of NCHW features, one level a launch: C=196
     on 12×20, C=32 on 180×320, C=196 on 4×4, B=2, float32 and bf16) and
     its backward there (``LocalCorr`` and ``LocalCorrLevels``, C=96 at
     16×16); K3 fused conv chain + pool at
     the three 720×1280 pyramid levels and the three 256×256 (MVSEC) ones
     for B=1 and 2, in float32 and in bf16, on a ragged NHWC view, and on a small ragged concat chain; K3 on
     EEMFlow+'s own chains at their 720×1280 level shapes, float32 and
     bf16: the SGU's concat chain (levels 5..2), the decoders' chains with
     their convs 2-4 grouped and shuffled (levels 6..2), each in the
     launches its plan gives (in bf16 the kernel and the plain version each
     against the chain with exact sums of the same bf16 operands, within
     the limit ``bf16_chain_bound`` derives from bf16 and float32
     rounding), and the fast pyramid's three chains; K4
     coarse head at the three 12×20
     levels for B=1 and 2, groups 5 and 1, at both cluster sizes, at an
     8×15 grid, a grid that takes the device-memory scratch and MVSEC's
     4×4 levels; K5 update block, both entry points, at ERAFT's 92×160
     and 64×120 grids, an odd 28×12 one and MVSEC's 32×32, in float32 and
     bf16, with He-scaled random weights),
     with the tolerance stated;
  3. end to end: the port's HREM eval CLI at 720×1280 on the seed-99
     synthetic split with the golden checkpoints, each path's launch
     counts set to 0 just before it and read just after: EEMFlow on the
     host-voxelize path, the device-voxelize path and the batched device
     path (the main path of K1 and K2: one K1 ``voxelize`` a frame, one K2
     launch a forward, and no ``normalize_voxel_grid``), then with ``--fast_head
     --fast_pyramid`` (the main path of K3 and K4); ERAFT (one sample,
     12 iterations) on the module path, then with ``--config
     {"fused_update": true}`` (the main path of K5, 24 launches, no input
     copied into another layout) and with bf16 operands, then with
     ``{"stacked_lookup": true}`` on the module path and with K5 (its AEE
     within 1e-5 of the per-level lookup's); the golden AEEs, the agreement
     of the paths, and small forwards on the card against the same
     forwards on the CPU (RAFT's among them, seeded weights, 5 channels); EEMFlow+ (golden checkpoint, one
     sample) on the standard path and with ``--fast_pyramid
     --fast_decoders --fast_sgu`` (K2 five launches a forward, K3 the
     pyramid's 6 and the SGU's and the decoders' 9 chains in the launches
     their plans cut them into), its golden AEE and a 96×128
     forward on the card against the CPU;
  3. (serve) the serving CLI on a consecutive synthetic stream at 720×1280
     (8 frames, 30,000 events a window) with the golden EEMFlow checkpoint
     in pair mode, ``--stream``, ``--stream --chunk 2``, ``--stream
     --chunk 8`` (the whole stream one chunk), ``--batch 2 --stream``,
     ``--host_voxelize``, ``--host_voxelize --stream --chunk 4``,
     ``--bf16`` and ``--fast``, each with
     its launch counts: the packer native, pair mode against the eval
     path's flow, the stream modes and host voxelize against pair mode, the
     host voxelizer's grids against K1's, bf16 against float32, ``--fast``
     parity-safe, K1 once a frame in a stream and twice a sample in pair
     mode; then ``-model eemflow_plus`` once;
  3b. train: the port's HREM training CLI on a seeded synthetic train split
     at 720×1280 (six samples, B=6, ``--device_voxelize``, two epochs of
     two steps), in bf16 (the default config) and in float32, each with
     its launch counts set to 0 just before it and read just after (K1
     ``voxelize`` two calls and K2 one launch a step), finite losses in
     ``metrics.jsonl`` and a checkpoint each epoch; a ``-se 1`` resume
     that continues the step and the learning rate; one float32 train
     step at 128×256, B=2, on the card against the CPU (loss and every
     gradient); 20 bf16 steps on one batch lowering its loss; then EEMFlow+
     (its config: 15 bins, bf16) and ERAFT the same way with
     ``--full_res_flow``, at the largest batch of B=6 or below at which a
     float32 step fits (printed with its peak memory), with their launch
     counts (K1 two calls a step, K2 five launches for EEMFlow+ and none
     for ERAFT, no K3, K4 or K5);
  3c. MVSEC: the port's MVSEC eval CLI on synthetic 260×346 sequences
     (30,000 events a frame interval, timestamps at MVSEC's ~1.5e9 s,
     written by the port's own HDF5 writer) with the golden EEMFlow
     weights: dt1 dense, dt1 sparse on an outdoor sequence and dt4, each
     on the host path, with ``--device_voxelize`` (K1 over the whole frame,
     then the crop), ``--fast`` (K3, K4) and ``--device_voxelize
     --eval_batch 2``, each run's launch counts set to 0 just before it and
     read just after, its AEE against the host path's and the host path's
     against the port's CPU run; ERAFT (golden weights) on the module path
     and with ``fused_update`` (K5 at 32×32); the MVSEC training CLI with
     ERAFT's ``configs/mvsec_eraft.json`` (B=6, the host path's resize
     augmentation) and EEMFlow with ``--device_voxelize`` (K1 twice a
     step, the flips and the crop on the card), in bf16 and float32, with
     their launch counts, and 20 steps of each on one batch lowering its
     loss;
  3d. zoo: GMA, SKFlow and KPAFlow (drawing from a generator of their
     own): the golden checkpoints through the eval CLIs on the JAX
     package's golden fixtures (GMA on the seed-99 HREM split at 720×1280
     through ``test_hrem``, SKFlow and KPAFlow on the seed-55 MVSEC
     sequence, dt1 dense, through ``test_mvsec``; one sample, 12
     iterations), each on the host path and with ``--device_voxelize``
     (K1), with their launch counts, within 0.01 of the golden AEE and the
     device path within 1e-4 of the host path; each model's 256×256 B=1
     forward (3 iterations, seeded weights, every gate drawn nonzero) on the
     card against the CPU within 1e-4·max(1, largest |flow|), and how far
     zeroing the gates moves it; ``train_mvsec`` at B=6 with each model's
     config in bf16 (host grids) and float32 (``--device_voxelize``: K1 two
     calls a step), with their launch counts; one float32 train step at
     128×128 B=2 (3 iterations, gates nonzero) on the card against the CPU
     in units of the model's largest gradient; 20 steps on one batch
     lowering its loss in bf16 and float32; the phase's seconds;
  3e. transformers: GMFlow and FlowFormer (a generator of their own): the
     golden checkpoints through ``test_hrem`` at 720×1280 on the host path
     and with ``--device_voxelize`` (K1), with their launch counts, within
     0.01 of the golden AEE and the device path within 1e-4 of the host
     path; 256×256 B=1 forwards on seeded weights (GMFlow one-scale and
     two-scale, whose local matching is K2's, FlowFormer at decoder depth
     3 with its gate nonzero) on the card against the CPU within
     1e-4·max(1, largest |flow|); ``train_mvsec`` with each model's config
     at its batch (GMFlow 8, FlowFormer 6) in bf16 and float32 with their
     launch counts; one float32 train step at 128×128 B=2 on the card
     against a float64 step on the CPU; 20 steps on one batch lowering its
     loss in bf16 and float32; the phase's seconds;
  3f. the IRR-PWC and FlowNet line (a generator of its own): the goldens of
     ``irrpwc`` and ``pwcnet_irr_occ_bi`` through ``test_mvsec`` on the JAX
     package's golden MVSEC sequence (dt1 dense, one sample) on the host
     path and with ``--device_voxelize`` (K1), with K2's launches (5 and 10
     a forward), within 0.01 of the golden AEE and the device path within
     1e-4 of the host path; all 15 names at 256×256 B=1 on seeded weights,
     the card against the CPU within 1e-4·max(1, largest |flow|), every
     prediction and occlusion map, with K2's launches; ``test_hrem`` at
     720×1280 for ``irrpwc``, ``irrpwc_occ``, ``pwcnet_irr_occ_bi``,
     ``flownet1s`` and ``irr_flownet`` on seeded weights, host path against
     ``--device_voxelize``; ``train_mvsec`` with the default config
     (``configs/mvsec_event_flow_dense.json``, B=8) for ``irrpwc``,
     ``pwcnet_irr_occ_bi``, ``flownet1s`` and ``irr_flownet`` in bf16 and
     float32 with their launch counts; 20 steps on one batch of sparse grids
     with finite gradients, lowering the loss (IRR-FlowNet's need not fall:
     ``PWC_NO_DESCENT``); one train step at 128×128 B=2 on the card against
     the CPU for ``irrpwc`` (float32) and ``irr_flownet`` (float64:
     ``PWC_STEP_DTYPE``); the phase's
     seconds;
  3g. the research eval surface (a generator of its own): ``test_hrem
     --mode`` save_flow, low_epe, warp, density and dsec_submission with the
     golden EEMFlow and ``--device_voxelize`` on one sample of the seed-99
     split at 720×1280, and save_flow under ``--fast``, each with its
     launch counts (K1, K2; K3 and K4 under ``--fast``), the ``.flo``
     against the standard path's flow (1e-5·max(1, |flow|)), the density
     mode's AEE against the standard AEE (1e-5), the DSEC file decoded back
     to the flow (1/128 px); ``test_mvsec --mode`` warp_loss and multi_key
     on phase 3c's dt1 sequence, the card against the CPU (1e-5); EEMFlow's
     ``s2d_stem`` and ``stacked_coarse`` (and both) at 720×1280, B=1 and 2,
     golden weights, against the standard forward (1e-5·max(1, |flow|)),
     back to back, K2 one launch a forward; ``time_eval --bf16`` for EEMFlow
     (standard and ``--fast``), EEMFlow+ and ERAFT (ms and the flow's
     relative L2 from float32); ``train_hrem --viz --device_voxelize`` (two
     steps, pictures every step) and ``serve --viz`` on phase 3's stream,
     their PNGs decoded; the phase's seconds;
  4. times (CUDA events after a warm-up): each kernel on the device
     (calls queued behind a sleep kernel, so the host's issue time is not
     counted) and per wrapper call back to back, beside its bound, its
     twin, the library call where there is one and, for K3, K4 and K5, the
     port's standard path for the same work; K1 (both entry points, 2·10^5
     and 30,000 events a frame), K2 (the correlation step of a forward,
     its launches and copy kernels; in bf16 at B=1 and 6) (for K3 and K5
     also each kernel instance's registers, spills and occupancy, and
     their bounds: split TF32 at the TF32 peak for float32, bf16 at the
     bf16 peak, beside the float32 SIMT figure; for K4 its registers,
     spills and clusters, at both cluster sizes; K3's timed launches held
     against the twin on the forward's own inputs, and a store probe:
     levels 1 and 2 timed again writing the pooled output alone); one
     720×1280 B=1 EEMFlow forward in the standard and the fused modes; one
     whole device-voxelize eval sample; the ERAFT forward at 720×1280 and
     512×960, B=1, on the module path and with ``fused_update``, and at
     720×1280 with the per-level and the stacked lookup in turns; RAFT's
     720×1280 forward; the
     ``--fast`` candidates for EEMFlow (``siamese_stack``, ``fast_head`` +
     ``fast_pyramid``, all three); K3 on EEMFlow+'s 9 chains of one fused
     720×1280 forward (device after an L2 flush and warm, wrapper, float32
     and bf16, the bound in the tensor cores' unit beside the SIMT figure,
     each chain's plan and its instances' registers, the plain versions,
     the standard modules), the level-2 chains at the plan's cut (one conv
     a launch) and at the fewest launches that fit, one launch of K3 at every tile
     and split its wrapper picks among (beside the pick's prediction), the
     ``--fast`` candidates for EEMFlow+ (back to back), and its standard and
     fused forwards (back to back, and the device's busy share of a profiled
     run); the serving CLI at B=1
     and B=2 in each mode (wall fps, host decode and dispatch ms a frame,
     the device's busy share of the timed window); one
     720×1280 B=6 train step (device voxelize) in bf16 and float32, back to
     back, the device's busy time and share of one profiled run, and its
     peak memory; the same for EEMFlow+ and ERAFT at their batch; then at
     MVSEC's shapes each kernel (K1 on a dt1 and a dt4 window at 260×346,
     K2 and K4 on the 4×4 levels, K3's six pyramid calls at 256×256, K5's
     pair at 32×32) beside its bound, plain version and library call, the
     256×256 B=1 forwards of EEMFlow (standard, ``--fast``) and ERAFT
     (module path, K5) back to back with their device busy time, one whole
     eval sample (host and device voxelize), and the two MVSEC train steps
     (ms, busy share, peak memory); then the zoo: GMA's 720×1280 B=1
     forward (golden weights) and the three 256×256 B=1 forwards back to
     back and their device busy time, SKFlow's and KPAFlow's first kernels
     by device time, SKFlow's 15×15 depthwise convs by their share of the
     forward, and the three B=6 MVSEC train steps with their configs in bf16
     and float32 (ms, busy share, peak memory); then GMFlow and FlowFormer:
     each one's 720×1280 and 256×256 B=1 forwards (golden weights) back to
     back, their busy share, first kernels and peak memory, and each one's
     MVSEC train step at its config's batch in bf16 and float32; then the
     720×1280 B=1 forwards of ``irrpwc``, ``pwcnet_irr_occ_bi``,
     ``flownet1s`` and ``irr_flownet`` (seeded weights) back to back, their
     busy share, peak memory, first kernels and K2's share of the device
     time, and the MVSEC B=8 train steps of ``irrpwc`` and ``flownet1s``
     with the default config in bf16 and float32.

Then one JSON line of the train step's times (``{"train_step": ...}``:
EEMFlow's under ``bf16`` and ``float32``, EEMFlow+'s and ERAFT's under
their names with their ``batch``, the zoo's forwards and MVSEC train steps
under ``zoo``, GMFlow's and FlowFormer's under ``transformers``, the
IRR-PWC and FlowNet line's under ``pwc``), one
of every ported kernel (``ms`` is device time; for K1 ``voxel_scatter`` at
2·10^5 events a frame, with ``voxelize_*`` and ``*_30k`` beside it; for K2
the three levels of a B=1 forward, float32, ``bf16_*`` on bf16 operands
(``_b6`` at B=6); for K3 and K4 with the L2 cache flushed before each call,
as a forward leaves their weights, and ``warm_ms`` without the flush; for
K3 on EEMFlow+'s chains (``fused_convs_pool_plus_chains``) the launches
of its 9 chains in one fused forward, after an L2 flush; for
K5 one pair of calls, one iteration, at the 92×160 grid; ``wrapper_ms``
the time per wrapper call back to back; ``standard_ms`` the device time of
the standard path that K3, K4 or K5 replaces; ``launches_per_train_step``
for K1 and K2 (K1's ``launches`` include phases 3d's, 3e's and 3f's
device-voxelize runs, K2's the two-scale GMFlow forward of phase 3e and
phase 3f's PWC forwards and train steps),
``launches_per_train_step_eemflow_plus`` and ``_eraft``
beside it; ``mvsec_*`` fields: the kernel at MVSEC's shapes and its
launches on the MVSEC paths of phase 3c; K1-K4's ``launches`` include
phase 3g's CLI runs), and as the last line
``{"ok": true, "device": {...}}``.
Any fault exits non-zero without the ``ok`` line, as does a machine
without CUDA.  Synthetic data goes to a temporary directory outside the
repository.  Parity phases run float32 convolutions and matmuls in full
float32 (TF32 off).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_CKPT = os.path.join(REPO, "tests", "fixtures", "eemflow_hrem_golden.pth.tar")
GOLDEN_JSON = os.path.join(REPO, "tests", "fixtures", "hrem_golden.json")
ERAFT_CKPT = os.path.join(REPO, "tests", "fixtures", "eraft_hrem_golden.pth.tar")
ERAFT_JSON = os.path.join(REPO, "tests", "fixtures", "hrem_golden_eraft.json")
PLUS_CKPT = os.path.join(REPO, "tests", "fixtures", "eemflow_plus_hrem_golden.pth.tar")
PLUS_JSON = os.path.join(REPO, "tests", "fixtures", "hrem_golden_plus.json")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, float32
# outside the tensor cores, TF32 and bf16 on them, FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12

H, W, BINS = 720, 1280, 5
K1_TOL_REL = 1e-5  # of the largest cell: atomics sum in no fixed order
# voxelize, relative to max(1, largest |plain|): shared-memory atomics sum a
# cell in no fixed order, and the statistics are summed in another order
# (float64) than the plain version's two-pass float32
K1_VOXELIZE_TOL = 1e-5
K2_TOL = 1e-5
# K2 on bf16 operands, relative to max(1, largest |plain|): both sum the
# float32 products of the same bf16 operands and round once to bf16, in
# another order, so a result can round to the neighbouring bf16 value
K2_BF16_TOL = 5e-3
# relative to max(1, largest |twin|): float32 differs in summation order
# only; in bf16 both sides round the same operands, but an intermediate that
# differs in its last float32 bit can round to the neighbouring bf16 value
K3_TOL = {"float32": 2e-5, "bfloat16": 5e-3}
K4_TOL = 1e-5
# EEMFlow's pyramid levels at 720x1280 (padded 768x1280), per frame:
# (input [C, H, W], conv widths, pool, emit_full)
K3_LEVELS = (
    ((16, 384, 640), (16,), 32, True),
    ((32, 192, 320), (32, 32), 16, True),
    ((64, 96, 160), (64, 64), 8, False),
)
HEAD_CHANNELS = (16, 32, 64)
# MVSEC (phase 3c): the DAVIS sensor's 260x346 frames, voxelized whole and
# evaluated on their 256x256 centre crop; EEMFlow's pyramid levels there
# (no padding: 256 is a multiple of 64) as K3_LEVELS, its coarse levels 4x4
MVSEC_H, MVSEC_W, MVSEC_CROP = 260, 346, 256
K3_LEVELS_MVSEC = (
    ((16, 128, 128), (16,), 32, True),
    ((32, 64, 64), (32, 32), 16, True),
    ((64, 32, 32), (64, 64), 8, False),
)
GOLDEN_TOL = 0.01
PATH_TOL = 1e-5
FORWARD_TOL = 1e-4
# K5 relative to max(1, largest |plain|): float32 differs in summation
# order only; bf16 as K3
K5_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# ERAFT's 1/8 grids at 720x1280 (padded 736x1280) and 512x960, and an odd
# small one no row tiling of the TPU kernels takes; MVSEC's 256x256 crop
K5_GRIDS = ((92, 160), (64, 120), (28, 12))
K5_GRID_MVSEC = (32, 32)
K2_GRAD_TOL = 1e-5
# ERAFT AEE: the fused update against the module path (summation order
# carried through 12 iterations); bf16 operands against float32
ERAFT_FUSED_TOL = 1e-3
ERAFT_BF16_TOL = 0.05
# EEMFlow+ forward, the card against the CPU and the fused modes against the
# standard ones, relative to max(1, largest |flow|): float32 in other
# summation orders carried through five levels of warp feedback
PLUS_TOL = 1e-5
# EEMFlow+'s K3 chains at 720x1280 (padded 768x1280): the SGU's concat chain
# at levels 5..2, the decoders' chains at levels 6..2 (convs 2-4 grouped by
# 3 and shuffled), and the fast pyramid's three chains: (label, C, H, W,
# widths, concat, relus, groups (= shuffle), pool)
_G = (1, 3, 3, 3, 1, 1, 1)
_SGU = ((32, 32, 32, 16, 8, 3), (True,) * 5 + (False,), (True,) * 5 + (False,), (1,) * 6)
_DEC = ((96, 96, 96, 96, 64, 32, 2), (False,) * 7, (True,) * 6 + (False,), _G)
PLUS_CHAINS = (
    tuple((f"SGU level {l}", 64, h, w, *_SGU, None) for l, (h, w) in
          zip((5, 4, 3, 2), ((24, 40), (48, 80), (96, 160), (192, 320))))
    + tuple((f"decoder level {l}", 87, h, w, *_DEC, None) for l, (h, w) in
            zip((6, 5, 4, 3, 2), ((12, 20), (24, 40), (48, 80), (96, 160), (192, 320))))
    + (("pyramid level 1", 16, 384, 640, (16,), (False,), (True,), (1,), None),
       ("pyramid level 2", 32, 192, 320, (32, 32), (False,) * 2, (True,) * 2, (1,) * 2, None),
       ("pyramid level 3", 64, 96, 160, (64, 64), (False,) * 2, (True,) * 2, (1,) * 2, 2))
)
# serving: a consecutive synthetic stream at 720x1280, 30,000 events a frame
SERVE_FRAMES = 8
# a served .flo against another path to the same flow (the JAX CLI's limit)
SERVE_TOL = 1e-4
# --host_voxelize's grid against K1's, relative to max(1, largest |cell|):
# both sum a cell's votes in float32 (in event order on the host, in no
# fixed order on the card) and normalize with float64 statistics
HOSTVOX_GRID_TOL = 1e-5
# --bf16 against float32: relative L2 of the flow (bf16 keeps 8 mantissa
# bits; ~25 roundings of conv operands through pyramid and decoders)
SERVE_BF16_REL_L2 = 0.02
# a parity-safe --fast: mean end-point distance to the standard path's flow
# (px), the 1e-5 of PERF.md section 2
FAST_EPE_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def say(line: str) -> None:
    print(line, flush=True)


# the run's start on the host clock: each phase line says when it began
STARTED = time.perf_counter()


def phase(name: str) -> None:
    say(f"=== phase {name} (at {time.perf_counter() - STARTED:.1f} s)")


def stamp(part: str) -> None:
    """A line that says when a part of phase 4 began, so that a run shows
    where its clock goes."""
    say(f"--- 4: {part} (at {time.perf_counter() - STARTED:.1f} s)")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound_ms(n_bytes: float, n_flops: float, flop_rate: float = PEAK_FP32_FLOP_PER_S):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate for their type (float32 unless
    given)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events over ``reps``
    back-to-back calls after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn``: the ``reps`` calls are queued
    behind a sleep kernel long enough to cover their issue on the host, so
    on the device they run back to back and the CUDA events time the device
    work alone, not the wrapper's Python and launch overhead.  A sleep the
    host outran (the machine's shared cores can stall it) is doubled, up to
    three times; fails if the host was still issuing when the last ended."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    issue_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / start.elapsed_time(end)
    for attempt in range(4):
        torch.cuda._sleep(int(cycles_per_ms * (2 * issue_ms + 5) * 2 ** attempt))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        still_queued = not start.query()
        torch.cuda.synchronize()
        if still_queued:
            return start.elapsed_time(end) / reps
    raise SmokeFailure("the host fell behind the sleep: the queued time is not device time")


def cold_queued_ms(fn, reps: int, device) -> float:
    """Device milliseconds of ``fn`` with the 50 MB L2 cache flushed before
    each call, as a forward leaves it for the coarse stage's weights:
    queued (flush, fn) pairs less queued flushes alone."""
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    flush = buf.zero_

    def both():
        flush()
        fn()

    return queued_ms(both, reps) - queued_ms(flush, reps)


def make_hrem_fixture(base: str, seed: int = 99, n_events: int = 30000) -> str:
    """Deterministic synthetic HREM test split: one sequence, two samples,
    at protocol resolution (1280×720) — the same generator, draw for draw,
    as the JAX package's golden acceptance test."""
    from eemflow_tpu_torch.events.io import write_flo

    rng = np.random.default_rng(seed)
    root = os.path.join(base, "hrem")
    for i in range(2):
        d = os.path.join(root, "test", "dt1", "indoor_fast", f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        for name in ("events1.npz", "events2.npz"):
            np.savez(
                os.path.join(d, name),
                x=rng.integers(0, W, n_events).astype(np.int32),
                y=rng.integers(0, H, n_events).astype(np.int32),
                t=np.sort(rng.integers(0, 10**9, n_events)).astype(np.int64),
                p=rng.integers(0, 2, n_events).astype(np.int8),
            )
        write_flo(
            (rng.standard_normal((H, W, 2)) * 2).astype(np.float32),
            os.path.join(d, "flow.flo"),
        )
    return root


def make_hrem_train_fixture(base: str, n_samples: int = 6, seed: int = 5, n_events: int = 30000) -> str:
    """A synthetic HREM training split, ``train/dt1/<name>/{events1.npz,
    events2.npz, flow.flo}`` at 1280×720, drawn from ``seed``."""
    from eemflow_tpu_torch.events.io import write_flo

    rng = np.random.default_rng(seed)
    root = os.path.join(base, "hrem_train")
    for i in range(n_samples):
        d = os.path.join(root, "train", "dt1", f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        for name in ("events1.npz", "events2.npz"):
            np.savez(
                os.path.join(d, name),
                x=rng.integers(0, W, n_events).astype(np.int32),
                y=rng.integers(0, H, n_events).astype(np.int32),
                t=np.sort(rng.integers(0, 10**9, n_events)).astype(np.int64),
                p=rng.integers(0, 2, n_events).astype(np.int8),
            )
        write_flo((rng.standard_normal((H, W, 2)) * 2).astype(np.float32), os.path.join(d, "flow.flo"))
    return root


def k1_batch(rng, n_valid, N: int = 1 << 18, dt_zero=(), h: int = H, w: int = W, pixel=None):
    """[B, N, 4] padded event rows: sorted relative µs timestamps, x/y
    drawn two pixels past every edge of an h×w frame (out-of-frame events)
    unless ``pixel`` (x, y) fixes them, p in {0, 1}; samples listed in
    ``dt_zero`` share one timestamp (ΔT == 0)."""
    ev = np.zeros((len(n_valid), N, 4), np.float32)
    for b, n in enumerate(n_valid):
        t = np.zeros(n) if b in dt_zero else np.sort(rng.uniform(0, 50_000, n))
        ev[b, :n, 0] = t
        ev[b, :n, 1] = rng.integers(-2, w + 2, n) if pixel is None else pixel[0]
        ev[b, :n, 2] = rng.integers(-2, h + 2, n) if pixel is None else pixel[1]
        ev[b, :n, 3] = rng.integers(0, 2, n)
    return ev, np.asarray(n_valid, np.int32)


def conv_params(rng, cins, couts, device):
    """OIHW weights at a He-like scale (activations stay O(1) down a chain)
    and biases, float32 on ``device``."""
    ws, bs = [], []
    for cin, cout in zip(cins, couts):
        w = rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))
        ws.append(torch.from_numpy(w.astype(np.float32)).to(device))
        bs.append(torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32)).to(device))
    return ws, bs


def head_params(rng, groups, device, k=53):
    """Random EEMFlow coarse-stage parameters by the port's state-dict names."""
    from eemflow_tpu_torch.ops.coarse_head import conv_names

    widths = ((16, None), (100, k + 16), (100, 100), (100, 100), (100, 100), (64, 100), (32, 64), (2, 32))
    params = {}
    for lvl, c in zip((1, 2, 3), HEAD_CHANNELS):
        for i, (name, (cout, cin)) in enumerate(zip(conv_names(lvl), widths)):
            cin = c if cin is None else cin
            g = groups if i in (2, 3, 4) else 1
            ws, bs = conv_params(rng, (cin // g,), (cout,), device)
            params[f"{name}.weight"] = ws[0]
            params[f"{name}.bias"] = bs[0]
    params["out_conv.weight"] = torch.from_numpy(rng.standard_normal((2, 6, 1, 1)).astype(np.float32)).to(device)
    params["out_conv.bias"] = torch.from_numpy(rng.standard_normal(2).astype(np.float32)).to(device)
    return params


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    """(max |Δ|, the scale max(1, largest |ref|) a relative tolerance uses)."""
    return float((got - ref).abs().max()), max(1.0, float(ref.abs().max()))


def k3_flops_bytes(B, cin, h, w, widths, emit_full, pool):
    """Operations and bytes one K3 call must do and move: 2 per
    multiply-add; the input read once, the weights read once, the full
    output (if asked) and the pooled output written once."""
    flops = 0
    nbytes = B * cin * h * w * 4
    c = cin
    for f in widths:
        flops += 2 * B * h * w * f * c * 9
        nbytes += (f * c * 9 + f) * 4
        c = f
    if emit_full:
        nbytes += B * c * h * w * 4
    nbytes += B * c * (h // pool) * (w // pool) * 4
    return flops, nbytes


def k4_flops_bytes(B, h, w, packed, k):
    """Operations and bytes of one K4 call: the correlations, the rconvs,
    the decoders (grouped convs at their grouped cost) and the 1x1 fuse;
    the features and weights read once, the flow written once."""
    hw = h * w
    flops = 0
    nbytes = 2 * B * hw * sum(HEAD_CHANNELS) * 4 + B * hw * 2 * 4
    for lvl, c in enumerate(HEAD_CHANNELS):
        flops += 2 * B * hw * k * c
        cin = c
        for i, (cout, g, _) in enumerate(packed["meta"]):
            cin = k + packed["meta"][0][0] if i == 1 else cin
            flops += 2 * B * hw * cout * (cin // g) * 9
            nbytes += (cout * (cin // g) * 9 + cout) * 4
            cin = cout
    flops += 2 * B * hw * 2 * 6
    nbytes += (12 + 2) * 4
    return flops, nbytes


def phase_device(device: torch.device) -> dict:
    phase("0 device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"device: {name} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi not available ({type(e).__name__})"
    say("card name, power limit (nvidia-smi):")
    say(smi)
    return {"platform": "gpu", "kind": name, "count": count}


def phase_build() -> None:
    from eemflow_tpu_torch.kernels import build

    phase("1 build")
    t0 = time.perf_counter()
    build.load()
    lib = os.path.relpath(build.library_path(), REPO)
    if build.build_log:
        say(f"built {lib} from {len(build.SOURCES)} sources ({', '.join(build.SOURCES)}) by one "
            f"nvcc per source, all at once, and one link in {build.build_seconds:.1f} s "
            f"(load {time.perf_counter() - t0:.1f} s)")
    else:
        say(f"reused {lib}, built earlier from the same sources")
    for line in build.build_log.splitlines():
        if "ptxas" in line or "spill" in line:
            say(line.strip())
    from eemflow_tpu_torch import native

    t0 = time.perf_counter()
    require(native.have_native(), f"the C++ event packer did not build: {native.native_status()}")
    say(f"event packer (g++ {' '.join(native.FLAGS)}): {native.native_status()}, "
        f"{time.perf_counter() - t0:.1f} s to build and load")


def ptxas_lines(name: str) -> list:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    kernels whose mangled name holds ``name``, from this process's build."""
    from eemflow_tpu_torch.kernels import build

    out, current = [], ""
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            current = line
        if name in current and ("ptxas" in line or "spill" in line):
            out.append(line.strip())
    return out


def phase_parity(device: torch.device) -> dict:
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.models.eemflow import INDEX_53

    phase("2 kernels against their twins")
    rng = np.random.default_rng(0)
    # the MVSEC shapes' inputs come from a generator of their own, so that
    # every other case draws what it drew before they were added
    mvsec_rng = np.random.default_rng(14)
    k1_err, voxelize_err = phase_parity_k1(device, rng, mvsec_rng)

    k2_err = 0.0
    for shape in ((1, 12, 20, 16), (1, 12, 20, 32), (1, 12, 20, 64), (1, 96, 160, 64)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
        y = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
        got = k2.local_corr(x, y, 4, INDEX_53)
        ref = k2.plain(x, y, 4, INDEX_53)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        k2_err = max(k2_err, err)
        say(f"K2 local_corr {list(shape)} K=53: max|Δ| {err:.3e} (tolerance {K2_TOL:g})")
        require(tuple(got.shape) == shape[:3] + (53,) and err <= K2_TOL,
                f"K2 disagrees with its twin at {shape}")
    # GMFlow's two-scale local matching (phase 3e): 1/4 of 256x256, C=128,
    # the full 9x9 window; a generator of its own, so that every other case
    # draws what it drew before
    gm_rng = np.random.default_rng(17)
    shape = (2, 64, 64, 128)
    x, y = (torch.from_numpy(gm_rng.standard_normal(shape).astype(np.float32)).to(device) for _ in range(2))
    got, ref = k2.local_corr(x, y, 4), k2.plain(x, y, 4)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    k2_err = max(k2_err, err)
    say(f"K2 local_corr {list(shape)} K=81 (GMFlow's two-scale local matching): max|Δ| {err:.3e} (tolerance "
        f"{K2_TOL:g})")
    require(tuple(got.shape) == shape[:3] + (81,) and err <= K2_TOL, f"K2 disagrees with its twin at {shape}, K=81")
    levels_err, k2_bf16_err = phase_parity_k2_levels(device, rng)
    k2_err = max(k2_err, levels_err)
    phase_parity_k2_backward(device, rng)
    pwc_err, pwc_bf16_err = phase_parity_k2_pwc(device)
    k2_err, k2_bf16_err = max(k2_err, pwc_err), max(k2_bf16_err, pwc_bf16_err)
    k3_err = phase_parity_k3(device, rng, mvsec_rng)
    plus_err, tc_err = phase_parity_k3_plus(device, rng)
    k4_err = phase_parity_k4(device, rng, mvsec_rng)
    k5_err = phase_parity_k5(device, rng, mvsec_rng)
    return {"voxel_scatter": k1_err, "voxelize": voxelize_err, "local_corr": k2_err, "local_corr_bf16": k2_bf16_err,
            "fused_convs_pool": max(k3_err, tc_err), "fused_convs_pool_plus_chains": plus_err, "coarse_head": k4_err,
            "update_block": k5_err}


def phase_parity_k3_plus(device: torch.device, rng, dtypes=(torch.float32, torch.bfloat16), bf16_ratios=None):
    """K3 on EEMFlow+'s own chains at their 720x1280 level shapes, B=1,
    He-scaled random weights, float32 and bf16: the SGU's concat chain and
    the decoders' chains (convs 2-4 grouped and shuffled), each in the
    launches its plan gives, and the fast pyramid's chains; each against
    the plain version, and in bf16 EEMFlow+'s chains against exact sums
    (``bf16_chain_bound``; each chain's largest share of the limit is
    appended to ``bf16_ratios[label]`` where that is given).  Returns the
    largest float32 differences (EEMFlow+'s 9 chains, the pyramid's)."""
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.ops.fused_convs import chain_channels

    worst = {"plus": 0.0, "pyramid": 0.0}
    for label, cin, h, w, widths, concat, relus, groups, pool in PLUS_CHAINS:
        x = torch.from_numpy(rng.standard_normal((1, cin, h, w)).astype(np.float32)).to(device)
        ws, bs = [], []
        c = cin
        for f, cat, g in zip(widths, concat, groups):
            w_, b_ = conv_params(rng, (c // g,), (f,), device)
            ws += w_
            bs += b_
            c = f + (c if cat else 0)
        chain = chain_channels(cin, ws, concat, groups)
        kind = "pyramid" if label.startswith("pyramid") else "plus"
        for dtype in dtypes:
            packed = k3.pack_chain(ws, bs, dtype == torch.bfloat16, device, pool, concat, groups, groups, relus)
            before = launch_counts["fused_convs_pool"]
            got = k3.fused_convs(x, ws, bs, pool, dtype, True, relus, concat, packed, groups, groups)
            n = launch_counts["fused_convs_pool"] - before
            require(n == len(packed.launches) and (n == 1) == (kind == "pyramid"),
                    f"K3 EEMFlow+ {label} took {n} launches, not its plan's (the pyramid's one, the others more)")
            ref = k3.plain(x, ws, bs, pool, dtype, True, relus, concat, groups, groups)
            torch.cuda.synchronize()
            tol = K3_TOL[str(dtype).split(".")[1]]
            plan = ", ".join(f"convs {L.lo + 1}-{L.hi} tile {L.plan['tile'][0]}x{L.plan['tile'][1]} "
                             f"{L.plan['smem_bytes']} B" for L in packed.launches)
            if dtype == torch.bfloat16 and kind == "plus":
                # the kernel and the plain version each against the chain
                # with exact sums of the same bf16 operands, within the
                # limit that float32 sums and bf16 re-rounding give
                # (bf16_chain_bound); against each other they pass or fail
                # by the draw, as a rounding flip between convs moves one
                # side by a bf16 unit
                ex, bound = bf16_chain_bound(x, ws, bs, relus, concat, groups)
                scale = max(1.0, float(ex.abs().max()))
                ratios = []
                for side, out in (("kernel", got[0]), ("plain version", ref[0])):
                    err = (out.double() - ex).abs()
                    ratios.append(float((err / bound).max()))
                    say(f"K3 EEMFlow+ {label} bf16 {side} against exact sums: max|Δ| {float(err.max()):.3e} "
                        f"({float(err.max()) / scale:.3e} of max(1, |exact|)); at most {ratios[-1]:.3f} of the "
                        f"limit, whose largest is {float(bound.max()):.3e} ({float(bound.max()) / scale:.3e})")
                if bf16_ratios is not None:
                    bf16_ratios.setdefault(label, []).append(max(ratios))
                require(bool(torch.isfinite(got[0]).all()) and max(ratios) <= 1.0,
                        f"K3 or its plain version lies outside the bf16 limit on EEMFlow+'s {label}")
                continue
            for what, g, r in zip(("full", "pooled"), got, ref):
                if g is None:
                    continue
                err, scale = rel_err(g, r)
                if dtype == torch.float32:
                    worst[kind] = max(worst[kind], err)
                say(f"K3 EEMFlow+ {label} [1,{cin},{h},{w}] channels {chain} groups {list(groups)} "
                    f"{str(dtype)[6:]} ({n} launches: {plan}): {what} max|Δ| {err:.3e} "
                    f"(tolerance {tol:g}·{scale:.2f} = {tol * scale:.3e})")
                require(bool(torch.isfinite(g).all()) and err <= tol * scale,
                        f"K3 disagrees with its plain version on EEMFlow+'s {label} ({what}, {dtype})")
    return worst["plus"], worst["pyramid"]


# bf16's unit roundoff (8 significand bits): round to nearest moves a
# value by at most u·|v|
BF16_UNIT_ROUNDOFF = 2.0 ** -8


def bf16_chain_bound(x, ws, bs, relus, concat, groups):
    """The conv chain with bf16-rounded operands and exact sums (float64),
    each conv's sum rounded once to float32: the value that every float32
    summation order approximates; and an elementwise limit for a float32
    evaluation of the same chain, channel by channel from the conv that
    produced the value: its float32 sum of n = C_in/g·9 + 1 terms lies
    within n·u·(|W|·|x| + |b|) of the exact one, plus u·|y| for the exact
    side's own rounding (u = 2^-24); and a difference that an earlier conv
    left can make an operand of this conv round to the neighbouring bf16
    value, one bf16 spacing away, at most 2·u₁₆·|x| (u₁₆ = 2^-8): taken
    whole, as such a flip of every operand, 2·u₁₆·|W|·|x|.  The input is
    rounded alike on both sides, so the first conv has no such term.
    LeakyReLU is 1-Lipschitz; the shuffle and the concat move the limits
    with their values.  This is a first-order limit, not a proven bound: it
    does not carry an earlier conv's difference through |W|.  A bound that
    does (|W|·e grows by Σ|w| ≈ 1.1·sqrt(C_in/g·9), some 20x a conv) exceeds
    the values themselves after three convs and would test nothing; how far
    below it the chains lie over many draws is measured by
    ``--k3-bf16-seeds``."""
    import torch.nn.functional as F

    from eemflow_tpu_torch.models.layers import channel_shuffle

    y, e = x.double(), torch.zeros_like(x, dtype=torch.float64)
    for i, (w, b, relu, cat, g) in enumerate(zip(ws, bs, relus, concat, groups)):
        wr = w.to(torch.bfloat16).double()
        yr = y.to(torch.bfloat16).double()
        out = F.conv2d(yr, wr, b.double(), padding=1, groups=g).float().double()
        n = w.shape[1] * w.shape[2] * w.shape[3] + 1
        sums = F.conv2d(yr.abs(), wr.abs(), padding=1, groups=g)
        rerounding = 2 * BF16_UNIT_ROUNDOFF * sums if i > 0 else 0.0
        e_out = rerounding + n * F32_UNIT_ROUNDOFF * (sums + b.double().abs()[None, :, None, None]) \
            + F32_UNIT_ROUNDOFF * out.abs()
        if relu:
            out = F.leaky_relu(out, 0.1)
        if g > 1:
            out, e_out = channel_shuffle(out, g), channel_shuffle(e_out, g)
        y, e = (torch.cat([out, y], dim=1), torch.cat([e_out, e], dim=1)) if cat else (out, e_out)
    return y, e


def phase_parity_k1(device: torch.device, rng, mvsec_rng):
    """K1's two entry points against their plain versions: the main path's
    batch and the edge cases (n_valid 0 and 1, every event out of frame,
    every event on one pixel, a frame that is not a whole number of tiles,
    15 bins)."""
    from eemflow_tpu_torch.events.voxel import voxelize_plain
    from eemflow_tpu_torch.kernels import voxel_scatter as k1

    cases = (
        ("B=2 N=2^18 n_valid (200000, 150000), sample 1 ΔT==0", k1_batch(rng, (200_000, 150_000), dt_zero=(1,)),
         BINS, H, W),
        ("n_valid 0 and 1", k1_batch(rng, (0, 1), N=4096), BINS, H, W),
        ("every event out of frame", k1_batch(rng, (20_000, 5_000), N=1 << 15, pixel=(W + 3, 5)), BINS, H, W),
        ("every event on one pixel (shared-atomic contention)",
         k1_batch(rng, (50_000, 20_000), N=1 << 16, pixel=(7, 9)), BINS, H, W),
        ("a 45x77 frame (not whole 32x32 tiles), bins 15",
         k1_batch(rng, (3_000, 5_000), N=8192, h=45, w=77), 15, 45, 77),
        ("bins 15 at 720x1280", k1_batch(rng, (100_000, 60_000), N=1 << 17), 15, H, W),
        ("MVSEC 260x346 (partial tiles on both axes), a dt4 and a dt1 window",
         k1_batch(mvsec_rng, (120_000, 30_000), N=1 << 17, h=MVSEC_H, w=MVSEC_W), BINS, MVSEC_H, MVSEC_W),
        ("MVSEC 260x346, every event in the partial edge tiles (x >= 320 or y >= 256)",
         mvsec_edge_batch(mvsec_rng, (30_000, 5_000), N=1 << 15), BINS, MVSEC_H, MVSEC_W),
    )
    worst = {"scatter": 0.0, "voxelize": 0.0}
    for label, (ev, nv), bins, h, w in cases:
        e = torch.from_numpy(ev).to(device)
        n = torch.from_numpy(nv).to(device)
        for fn, ref_fn, what in ((k1.voxel_scatter, k1.plain, "scatter"), (k1.voxelize, voxelize_plain, "voxelize")):
            got = fn(e, n, bins, h, w)
            ref = ref_fn(e, n, bins, h, w)
            torch.cuda.synchronize()
            if what == "scatter" and label.startswith("every event on one pixel"):
                # both sides are float32 sums of ~10^4 votes a cell, in no
                # fixed order: each is held against the exact sum instead
                worst[what] = max(worst[what], k1_against_exact_sums(e, n, bins, h, w, got, ref, label))
                continue
            err = float((got - ref).abs().max())
            largest = float(ref.abs().max())
            tol = K1_TOL_REL * largest if what == "scatter" else K1_VOXELIZE_TOL * max(1.0, largest)
            worst[what] = max(worst[what], err)
            say(f"K1 {what} {label}: max|Δ| {err:.3e}, largest |cell| {largest:.3f}, tolerance {tol:.3e} "
                f"({'K1_TOL_REL·largest' if what == 'scatter' else 'K1_VOXELIZE_TOL·max(1, largest)'})")
            require(tuple(got.shape) == tuple(ref.shape) and bool(torch.isfinite(got).all()) and err <= tol,
                    f"K1 {what} disagrees with its plain version ({label})")
    return worst["scatter"], worst["voxelize"]


def mvsec_edge_batch(rng, n_valid, N: int):
    """A [B, N, 4] MVSEC batch (260x346) whose events all fall in the partial
    32x32 tiles of the right (x >= 320) or bottom (y >= 256) edge, a few
    just past the frame."""
    ev, nv = k1_batch(rng, n_valid, N=N, h=MVSEC_H, w=MVSEC_W)
    for b, n in enumerate(n_valid):
        right = rng.random(n) < 0.5
        ev[b, :n, 1] = np.where(right, rng.integers(320, MVSEC_W + 2, n), ev[b, :n, 1])
        ev[b, :n, 2] = np.where(right, ev[b, :n, 2], rng.integers(256, MVSEC_H + 2, n))
    return ev, nv


# float32's unit roundoff: a float32 sum of n terms lies within n·u·Σ|v|
# of the exact sum (recursive summation in any order)
F32_UNIT_ROUNDOFF = 2.0 ** -24


def k1_against_exact_sums(e, n, bins, h, w, got, ref, label) -> float:
    """K1's scatter (``got``) and its plain version (``ref``), each against
    the float64 sum of the same float32 votes, on the cells that take votes,
    within a float32 sum's forward-error bound n·u·Σ|v| (n the cell's votes,
    Σ|v| their magnitudes); every other cell as the other cases, against the
    plain version.  Returns the kernel's largest difference to the plain
    version."""
    from eemflow_tpu_torch.events.voxel import voxel_votes

    idx, val = voxel_votes(e, n, bins, h, w)
    size = got.numel()

    def sums(values):
        return torch.zeros(size, dtype=torch.float64, device=e.device).index_add_(0, idx, values.double())

    exact, count, mag = sums(val), sums(torch.ones_like(val)), sums(val.abs())
    voted = count > 0
    bound = count * F32_UNIT_ROUNDOFF * mag
    k_err = (got.reshape(-1).double() - exact).abs()
    p_err = (ref.reshape(-1).double() - exact).abs()
    worst = int(torch.argmax(torch.where(voted, k_err / bound.clamp(min=1e-300), 0.0)))
    largest = float(ref.abs().max())
    rest = float(torch.where(voted, 0.0, (got - ref).abs().reshape(-1)).max())
    torch.cuda.synchronize()
    say(f"K1 scatter {label}, the {int(voted.sum())} cells that take votes against the float64 sum of the same "
        f"votes: kernel max|Δ| {float(k_err[voted].max()):.3e}, plain version {float(p_err[voted].max()):.3e}; "
        f"bound n·u·Σ|v| at the kernel's worst cell {float(bound[worst]):.3e} ({int(count[worst])} votes, "
        f"Σ|v| {float(mag[worst]):.1f}), smallest bound {float(bound[voted].min()):.3e}; kernel vs plain "
        f"{float((got - ref).abs().max()):.3e}; the other cells max|Δ| {rest:.3e} (tolerance "
        f"{K1_TOL_REL * largest:.3e}, K1_TOL_REL·largest)")
    require(bool(torch.isfinite(got).all()) and bool((k_err[voted] <= bound[voted]).all())
            and bool((p_err[voted] <= bound[voted]).all()) and rest <= K1_TOL_REL * largest,
            f"K1 scatter disagrees with the exact sums ({label})")
    return float((got - ref).abs().max())


def forward_pooled(model, batch: int, device, seed: int, h: int = H, w: int = W):
    """The three pooled NCHW levels of both frames of an h×w (720x1280
    unless given) standard forward (random input), as ``EEMFlow.forward``
    makes them."""
    from eemflow_tpu_torch.ops.pad import InputPadder

    g = torch.Generator(device="cpu").manual_seed(seed)
    frames = [torch.randn(batch, h, w, BINS, generator=g).to(device) for _ in range(2)]
    padder = InputPadder((h, w), mode="chairs", eval_pad_rate=model.pad_rate)
    with torch.inference_mode():
        ev1, ev2 = padder.pad_nchw(*(f.permute(0, 3, 1, 2).contiguous() for f in frames))
        return model.pyramid(ev1), model.pyramid(ev2)


def phase_parity_k2_levels(device: torch.device, rng):
    """``local_corr_levels`` on the permuted NCHW views of the forward's
    three pooled levels (golden weights) against the plain version level by
    level, each result channels-first in memory: float32 at B=1 and 2, and
    bf16 operands (the training forward's mixed precision) at B=1 and 6.
    Returns the largest float32 and bf16 differences."""
    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.models.registry import get_eval_model

    model = get_eval_model("eemflow")
    model.load_state_dict(to_state_dict(load_torch_checkpoint(GOLDEN_CKPT)))
    model.to(device)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # 720x1280 (12x20 levels), and MVSEC's 256x256 crop (4x4 levels: the
    # +-4 window wider than the grid, nearly every tap on padding)
    cases = [(dtype, batch, (H, W)) for dtype, batch in
             ((torch.float32, 1), (torch.float32, 2), (torch.bfloat16, 1), (torch.bfloat16, 6))]
    cases += [(torch.float32, 1, (MVSEC_CROP,) * 2), (torch.float32, 2, (MVSEC_CROP,) * 2),
              (torch.bfloat16, 6, (MVSEC_CROP,) * 2)]
    for dtype, batch, (h, w) in cases:
        p1, p2 = forward_pooled(model, batch, device, seed=10 + batch, h=h, w=w)
        pairs = [(a.to(dtype).permute(0, 2, 3, 1), b.to(dtype).permute(0, 2, 3, 1)) for a, b in zip(p1, p2)]
        before = launch_counts["local_corr"]
        with torch.inference_mode():
            got = k2.local_corr_levels(pairs, model.max_displacement, model.corr_indices)
        require(launch_counts["local_corr"] == before + 1, "local_corr_levels did not take one launch")
        for (x, y), g in zip(pairs, got):
            ref = k2.plain(x, y, model.max_displacement, model.corr_indices)
            torch.cuda.synchronize()
            err, scale = rel_err(g.float(), ref.float())
            worst[dtype] = max(worst[dtype], err)
            tol = K2_TOL if dtype == torch.float32 else K2_BF16_TOL * scale
            say(f"K2 local_corr_levels {str(dtype)[6:]} B={batch} level {list(x.shape)} (a permuted NCHW view of "
                f"the forward's pooled level): max|Δ| {err:.3e} (tolerance {tol:.3e}); output channels-first: "
                f"{g.permute(0, 3, 1, 2).is_contiguous()}")
            require(tuple(g.shape) == tuple(ref.shape) and g.dtype == dtype and err <= tol
                    and g.permute(0, 3, 1, 2).is_contiguous(),
                    f"local_corr_levels disagrees with the plain version ({dtype}, B={batch}, {list(x.shape)})")
    return worst[torch.float32], worst[torch.bfloat16]


def phase_parity_k2_backward(device: torch.device, rng) -> None:
    """K2 as an autograd.Function on the card: the kernel's forward, the
    twin's autograd as its backward; the grads against plain autograd
    through the twin on the same inputs: ``LocalCorr`` (one level), and
    ``LocalCorrLevels`` (the three levels, one launch, as a training forward
    takes it) in float32 and bf16."""
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.models.eemflow import INDEX_53

    shape = (2, 12, 20, 64)
    xa, ya = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device) for _ in range(2))
    x, y = xa.clone().requires_grad_(), ya.clone().requires_grad_()
    out = k2.local_corr(x, y, 4, INDEX_53)
    require(isinstance(out.grad_fn, k2.LocalCorr._backward_cls), "K2 under grad did not go through LocalCorr")
    g = torch.randn_like(out)
    gx, gy = torch.autograd.grad(out, [x, y], g)
    x2, y2 = xa.clone().requires_grad_(), ya.clone().requires_grad_()
    px, py = torch.autograd.grad(k2.plain(x2, y2, 4, INDEX_53), [x2, y2], g)
    torch.cuda.synchronize()
    err = max(float((gx - px).abs().max()), float((gy - py).abs().max()))
    say(f"K2 local_corr backward {list(shape)} K=53 (kernel forward, twin's autograd backward): "
        f"grads max|Δ| {err:.3e} against autograd through the twin (tolerance {K2_GRAD_TOL:g})")
    require(err <= K2_GRAD_TOL, "K2's grads on the card disagree with the twin's")
    for dtype in (torch.float32, torch.bfloat16):
        xs, ys = ([torch.from_numpy(rng.standard_normal((6, 12, 20, c)).astype(np.float32)).to(device).to(dtype)
                   .requires_grad_() for c in HEAD_CHANNELS] for _ in range(2))
        before = launch_counts["local_corr"]
        outs = k2.local_corr_levels(list(zip(xs, ys)), 4, INDEX_53)
        require(launch_counts["local_corr"] == before + 1
                and all(isinstance(o.grad_fn, k2.LocalCorrLevels._backward_cls) for o in outs),
                "K2's three levels under grad did not take one LocalCorrLevels launch")
        gs = [torch.randn_like(o) for o in outs]
        got = torch.autograd.grad(outs, xs + ys, gs)
        x2, y2 = ([t.detach().requires_grad_() for t in ts] for ts in (xs, ys))
        ref = torch.autograd.grad([k2.plain(a, b, 4, INDEX_53) for a, b in zip(x2, y2)], x2 + y2, gs)
        torch.cuda.synchronize()
        errs = [rel_err(a.float(), b.float()) for a, b in zip(got, ref)]
        tol = K2_GRAD_TOL if dtype == torch.float32 else K2_BF16_TOL
        worst = max(e / (1.0 if dtype == torch.float32 else sc) for e, sc in errs)
        say(f"K2 LocalCorrLevels backward, B=6, the three 12x20 levels (C=16/32/64), {str(dtype)[6:]}: 1 launch; "
            f"grads max|Δ| {max(e for e, _ in errs):.3e} ({worst:.3e} of the tolerance's unit; tolerance {tol:g}"
            f"{'' if dtype == torch.float32 else '·max(1, |plain grad|)'}) against autograd through the twin")
        require(worst <= tol, f"LocalCorrLevels' grads on the card disagree with the twin's ({dtype})")


# the PWC nets' cost volumes (phase 3f): md=4, the full 9x9 window (K=81),
# on NHWC views of NCHW features, one level a launch: HREM's coarsest and
# finest PWC levels at 720x1280 (C=196 on 12x20, C=32 on 180x320) and
# MVSEC's coarsest (C=196 on 4x4, the window wider than the grid)
PWC_K2_CASES = ((2, 196, 12, 20), (2, 32, 180, 320), (2, 196, 4, 4))


def phase_parity_k2_pwc(device: torch.device):
    """K2 at the PWC nets' shapes (``PWC_K2_CASES``), float32 and bf16,
    through ``local_corr_levels`` with one level on permuted NCHW tensors, as
    ``models/irrpwc.cost_volume`` calls it, against the plain version; and
    its backward, through ``LocalCorr`` and ``LocalCorrLevels``, against the
    plain autograd at C=96, 16x16.  A generator of its own, so that every
    other case draws what it drew before.  Returns the largest float32 and
    bf16 differences."""
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import local_corr as k2

    rng = np.random.default_rng(19)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for B, C, h, w in PWC_K2_CASES:
        xa, ya = (torch.from_numpy(rng.standard_normal((B, C, h, w)).astype(np.float32)).to(device) for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            x, y = (t.to(dtype).permute(0, 2, 3, 1) for t in (xa, ya))
            before = launch_counts["local_corr"]
            with torch.inference_mode():
                got = k2.local_corr_levels([(x, y)], 4)[0]
            ref = k2.plain(x, y, 4)
            torch.cuda.synchronize()
            err, scale = rel_err(got.float(), ref.float())
            worst[dtype] = max(worst[dtype], err)
            tol = K2_TOL if dtype == torch.float32 else K2_BF16_TOL * scale
            say(f"K2 PWC cost volume {str(dtype)[6:]} B={B} C={C} {h}x{w} K=81 (NHWC views of NCHW features): max|Δ| "
                f"{err:.3e} (tolerance {tol:.3e}); one launch {launch_counts['local_corr'] == before + 1}")
            require(tuple(got.shape) == (B, h, w, 81) and got.dtype == dtype and err <= tol
                    and launch_counts["local_corr"] == before + 1,
                    f"K2 disagrees with its twin at the PWC shape {(B, C, h, w)} ({dtype})")
    shape = (2, 96, 16, 16)
    xa, ya = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device) for _ in range(2))
    g = None
    for label, call in (("LocalCorr", lambda a, b: k2.local_corr(a, b, 4)),
                        ("LocalCorrLevels", lambda a, b: k2.local_corr_levels([(a, b)], 4)[0])):
        x, y = (t.clone().permute(0, 2, 3, 1).detach().requires_grad_() for t in (xa, ya))
        out = call(x, y)
        g = torch.randn_like(out) if g is None else g
        gx, gy = torch.autograd.grad(out, [x, y], g)
        x2, y2 = (t.clone().permute(0, 2, 3, 1).detach().requires_grad_() for t in (xa, ya))
        px, py = torch.autograd.grad(k2.plain(x2, y2, 4), [x2, y2], g)
        torch.cuda.synchronize()
        err = max(float((gx - px).abs().max()), float((gy - py).abs().max()))
        say(f"K2 {label} backward, the PWC cost volume B=2 C=96 16x16 K=81: grads max|Δ| {err:.3e} against "
            f"autograd through the twin (tolerance {K2_GRAD_TOL:g})")
        require(err <= K2_GRAD_TOL, f"K2's {label} grads at the PWC shape disagree with the twin's")
    return worst[torch.float32], worst[torch.bfloat16]


def k5_block(rng, device):
    """A BasicUpdateBlock with He-scaled random conv weights and small
    random biases, in eval mode on ``device``."""
    from eemflow_tpu_torch.models.raft_core import BasicUpdateBlock

    block = BasicUpdateBlock()
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                w = rng.standard_normal(tuple(m.weight.shape)) * np.sqrt(2.0 / fan_in)
                m.weight.copy_(torch.from_numpy(w.astype(np.float32)))
                m.bias.copy_(torch.from_numpy((rng.standard_normal(m.bias.shape[0]) * 0.1).astype(np.float32)))
    return block.to(device).eval()


def k5_inputs(rng, h: int, w: int, device):
    """NHWC net (tanh), inp (ReLU), correlation features and flow at B=1."""
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return (
        t(np.tanh(rng.standard_normal((1, h, w, 128)))),
        t(np.maximum(rng.standard_normal((1, h, w, 128)), 0)),
        t(rng.standard_normal((1, h, w, 324))),
        t(2 * rng.standard_normal((1, h, w, 2))),
    )


def phase_parity_k5(device: torch.device, rng, mvsec_rng) -> float:
    """Both K5 entry points against their plain versions on the same
    inputs: the motion encoder on (corr, flow), the GRU and flow head on
    (net, inp, the plain motion features)."""
    from eemflow_tpu_torch.kernels import update_block as k5
    from eemflow_tpu_torch.ops.update_block import gru_flowhead_plain, make_fused_update, motion_encoder_plain

    block = k5_block(rng, device)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        fused = make_fused_update(block, dtype)
        tol = K5_TOL[str(dtype).split(".")[1]]
        for (h, w), g in [(grid, rng) for grid in K5_GRIDS] + [(K5_GRID_MVSEC, mvsec_rng)]:
            net, inp, corr, flow = k5_inputs(g, h, w, device)
            with torch.inference_mode():
                motion = k5.update_motion(corr, flow, fused)
                ref_motion = motion_encoder_plain(corr, flow, fused.motion, dtype)
                net2, delta = k5.update_gru(net, inp, ref_motion, fused)
                ref_net, ref_delta = gru_flowhead_plain(net, inp, ref_motion, fused.gru, dtype)
            torch.cuda.synchronize()
            for what, got, ref in (("motion", motion, ref_motion), ("net", net2, ref_net),
                                   ("delta flow", delta, ref_delta)):
                err, scale = rel_err(got, ref)
                if dtype == torch.float32:
                    worst = max(worst, err)
                say(f"K5 update_block B=1 {h}x{w} {str(dtype)[6:]}: {what} {list(got.shape)} max|Δ| "
                    f"{err:.3e} (tolerance {tol:g}·{scale:.2f} = {tol * scale:.3e})")
                require(tuple(got.shape) == tuple(ref.shape) and bool(torch.isfinite(got).all())
                        and err <= tol * scale, f"K5 disagrees with its plain version ({what}, {h}x{w}, {dtype})")
    return worst


def phase_parity_k3(device: torch.device, rng, mvsec_rng) -> float:
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import launch_counts

    worst = 0.0
    # the pyramid's levels at 720x1280 and at MVSEC's 256x256 crop
    cases = [(levels, lvl, dtype, B) for levels in (K3_LEVELS, K3_LEVELS_MVSEC)
             for dtype in (torch.float32, torch.bfloat16) for lvl in range(3) for B in (1, 2)]
    for levels, lvl, dtype, B in cases:
        (cin, h, w), widths, pool, emit_full = levels[lvl]
        g = rng if levels is K3_LEVELS else mvsec_rng
        x = torch.from_numpy(g.standard_normal((B, cin, h, w)).astype(np.float32)).to(device)
        ws, bs = conv_params(g, (cin,) + widths[:-1], widths, device)
        before = launch_counts["fused_convs_pool"]
        full, pooled = k3.fused_convs(x, ws, bs, pool, dtype, emit_full)
        require(launch_counts["fused_convs_pool"] == before + 1,
                f"K3 level {lvl + 1} did not run on the tensor-core kernel")
        ref_full, ref_pooled = k3.plain(x, ws, bs, pool, dtype, emit_full)
        torch.cuda.synchronize()
        tol = K3_TOL[str(dtype).split(".")[1]]
        require((full is None) != emit_full and tuple(pooled.shape) == (B, widths[-1], h // pool, w // pool),
                f"K3 level {lvl + 1}: wrong outputs")
        for what, got, ref in (("full", full, ref_full), ("pooled", pooled, ref_pooled)):
            if got is None:
                continue
            err, scale = rel_err(got, ref)
            if dtype == torch.float32:
                worst = max(worst, err)
            say(f"K3 fused_convs_pool level {lvl + 1} [{B},{cin},{h},{w}] convs {list(widths)} "
                f"pool {pool} {str(dtype)[6:]}: {what} max|Δ| {err:.3e} "
                f"(tolerance {tol:g}·{scale:.2f} = {tol * scale:.3e})")
            require(err <= tol * scale, f"K3 disagrees with its twin at level {lvl + 1} ({what}, {dtype})")
    # the tensor-core kernel on a ragged NHWC view, no pool
    x = torch.from_numpy(rng.standard_normal((2, 37, 45, 32)).astype(np.float32)).to(device).permute(0, 3, 1, 2)
    ws, bs = conv_params(rng, (32, 32), (32, 16), device)
    for dtype in (torch.float32, torch.bfloat16):
        got, _ = k3.fused_convs(x, ws, bs, None, dtype)
        ref, _ = k3.plain(x, ws, bs, None, dtype)
        torch.cuda.synchronize()
        err, scale = rel_err(got, ref)
        tol = K3_TOL[str(dtype).split(".")[1]]
        if dtype == torch.float32:
            worst = max(worst, err)
        say(f"K3 NHWC view [2,37,45,32] convs [32,16] no pool {str(dtype)[6:]}: max|Δ| {err:.3e} "
            f"(tolerance {tol:g}·{scale:.2f})")
        require(err <= tol * scale, f"K3 disagrees with its twin on the ragged NHWC view ({dtype})")
    # a concat chain (the EEMFlow+ FlowEstimatorDense pattern), no pool,
    # ragged: its widths no multiple of 8, padded inside each tap
    x = torch.from_numpy(rng.standard_normal((2, 16, 37, 45)).astype(np.float32)).to(device)
    ws, bs = conv_params(rng, (16, 24, 32), (8, 8, 3), device)
    flags = dict(relus=(True, True, False), concat=(True, True, False))
    for dtype in (torch.float32, torch.bfloat16):
        before = launch_counts["fused_convs_pool"]
        got, _ = k3.fused_convs(x, ws, bs, None, dtype, **flags)
        require(launch_counts["fused_convs_pool"] == before + 1, "the concat chain did not take one K3 launch")
        ref, _ = k3.plain(x, ws, bs, None, dtype, **flags)
        torch.cuda.synchronize()
        err, scale = rel_err(got, ref)
        tol = K3_TOL[str(dtype).split(".")[1]]
        if dtype == torch.float32:
            worst = max(worst, err)
        say(f"K3 concat chain [2,16,37,45] convs [8,8,3] no pool {str(dtype)[6:]}: max|Δ| {err:.3e} "
            f"(tolerance {tol:g}·{scale:.2f})")
        require(err <= tol * scale, f"K3 disagrees with its twin on the concat chain ({dtype})")
    return worst


def phase_parity_k4(device: torch.device, rng, mvsec_rng) -> float:
    from eemflow_tpu_torch.kernels import coarse_head as k4
    from eemflow_tpu_torch.models.eemflow import INDEX_53
    from eemflow_tpu_torch.ops.coarse_head import HeadWeights, coarse_head

    info = k4.kernel_info(device)
    say(f"K4 coarse_head kernel: {info['threads']} threads, {info['registers']} registers, "
        f"{info['local_bytes']} B local (spills); at 12x20 a CTA takes {info['smem_8']} B of shared "
        f"memory in clusters of 8 ({info['max_clusters_8']} fit at once) and {info['smem_16']} B in "
        f"clusters of 16 ({info['max_clusters_16']} fit); the wrapper takes clusters of {info['cluster_size']}")
    worst = 0.0
    # (groups, B, grid, cluster size or None: the wrapper's)
    cases = [(g, B, (12, 20), None) for g in (5, 1) for B in (1, 2)]
    cases += [(5, 2, (12, 20), R) for R in (8, 16) if R != info["cluster_size"] and info[f"max_clusters_{R}"]]
    cases += [(5, 2, (8, 15), None), (5, 1, (17, 30), None)]
    # MVSEC's 256x256 crop: 4x4 levels, the +-4 window wider than the grid
    cases += [(5, 1, (4, 4), None), (5, 2, (4, 4), None), (1, 1, (4, 4), None)]
    weights = {}
    for groups, B, (h, w), R in cases:
        if groups not in weights:
            weights[groups] = HeadWeights(head_params(rng, groups, device), groups)
        g = mvsec_rng if (h, w) == (4, 4) else rng
        f1, f2 = (
            [torch.from_numpy(g.standard_normal((B, h, w, c)).astype(np.float32)).to(device)
             for c in HEAD_CHANNELS]
            for _ in range(2)
        )
        got = k4._launch(f1, f2, weights[groups], INDEX_53, 4, R)
        ref = coarse_head(f1, f2, weights[groups], groups, INDEX_53, 4, impl="plain")
        torch.cuda.synchronize()
        err, scale = rel_err(got, ref)
        worst = max(worst, err)
        plan = k4.plan_launch(device, len(INDEX_53), weights[groups].kernel(device)["meta"], h, w,
                              HEAD_CHANNELS, R)
        if plan["scratch"]:
            where = "activations in a device-memory scratch"
        else:
            where = (f"{plan['smem_bytes']} B of shared memory a CTA, weights "
                     f"{'staged there' if plan['w_smem'] else 'read from device memory'}")
        say(f"K4 coarse_head B={B} {h}x{w} C=16/32/64 groups {groups}, clusters of "
            f"{R or info['cluster_size']}, {where}: max|Δ| {err:.3e}, largest |flow| "
            f"{float(ref.abs().max()):.3f} (tolerance {K4_TOL:g}·{scale:.2f})")
        require(tuple(got.shape) == (B, h, w, 2) and err <= K4_TOL * scale,
                f"K4 disagrees with its twin (B={B}, {h}x{w}, groups {groups}, cluster {R})")
    return worst


def phase_end_to_end(device: torch.device, tmp: str) -> dict:
    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model
    from eemflow_tpu_torch.tools.test_hrem import main as test_hrem

    phase("3 end to end: HREM eval CLI at 720x1280, golden checkpoint")
    with open(GOLDEN_JSON) as f:
        golden = json.load(f)
    root = make_hrem_fixture(tmp, seed=golden["fixture_seed"])
    # each main path: (label, its CLI runs with the K1 calls and K2 launches
    # each must make, the kernels it must launch); two samples of two frames:
    # K1 (voxelize) once a frame on the device path, K2 once a forward
    paths = (
        ("standard", (
            ("host voxelize", [], 0, 2),
            ("device voxelize", ["--device_voxelize"], 4, 2),
            ("device voxelize, eval_batch 2", ["--device_voxelize", "--eval_batch", "2"], 2, 1),
        ), ("voxel_scatter", "local_corr")),
        ("fused", (
            ("fused modes (--fast_head --fast_pyramid)", ["--fast_head", "--fast_pyramid"], 0, 0),
        ), ("fused_convs_pool", "coarse_head")),
    )
    # the device path normalizes inside K1: normalize_voxel_grid's tensor ops
    # must not run
    import eemflow_tpu_torch.events.voxel as voxel_module

    normalize = voxel_module.normalize_voxel_grid
    normalize_calls = []
    voxel_module.normalize_voxel_grid = lambda grid: normalize_calls.append(1) or normalize(grid)
    aee = {}
    launches = {}
    try:
        for path, runs, kernels in paths:
            reset_launch_counts()
            for label, extra, k1_calls, k2_launches in runs:
                before = dict(launch_counts)
                t0 = time.perf_counter()
                res = test_hrem([
                    "-model", "eemflow", "-int", "dt1", "--data_root", root,
                    "--checkpoint", GOLDEN_CKPT, "--save_dir", os.path.join(tmp, "out"),
                    "--save_csv", "--device", str(device), *extra,
                ])
                aee[label] = res["mean"]["AEE"]
                delta = {k: launch_counts[k] - before[k] for k in launch_counts}
                say(f"{label}: AEE {aee[label]:.7f} in {time.perf_counter() - t0:.1f} s; launches {delta}")
                require(delta["voxel_scatter"] == k1_calls and delta["local_corr"] == k2_launches,
                        f"{label}: {delta['voxel_scatter']} K1 calls and {delta['local_corr']} K2 launches, not "
                        f"{k1_calls} and {k2_launches} (one K2 launch a forward)")
            counts = dict(launch_counts)
            say(f"launches on the {path} path: {counts}")
            for k in kernels:
                require(counts[k] > 0, f"kernel {k} was not launched on the {path} path")
                launches[k] = counts[k]
    finally:
        voxel_module.normalize_voxel_grid = normalize
    say(f"K2 launches per standard forward: 1 (host and device paths: 2 forwards, 2 launches; eval_batch 2: "
        f"1 forward, 1 launch); normalize_voxel_grid calls on the standard paths: {len(normalize_calls)} "
        f"(the device path normalizes inside K1's voxelize)")
    require(not normalize_calls, "normalize_voxel_grid's tensor ops ran on the standard paths")
    # two samples, each one forward of two frames: K3 three times a frame, K4 once a forward
    require(launches["fused_convs_pool"] == 12 and launches["coarse_head"] == 2,
            "the fused path did not run K3 three times a frame and K4 once a forward")
    host = aee["host voxelize"]
    say(f"golden AEE {golden['aee']:.7f}; host path |Δ| {abs(host - golden['aee']):.3e}, "
        f"fused path |Δ| {abs(aee[paths[1][1][0][0]] - golden['aee']):.3e} (tolerance {GOLDEN_TOL:g})")
    require(abs(host - golden["aee"]) < GOLDEN_TOL, "golden AEE drifted")
    for label, v in aee.items():
        say(f"{label} vs host path: |Δ| {abs(v - host):.3e} (tolerance {PATH_TOL:g})")
        require(abs(v - host) < PATH_TOL and abs(v - golden["aee"]) < GOLDEN_TOL,
                f"{label} AEE differs from the host path or the golden value")

    # the whole forward on the card (kernels) against the CPU (twins)
    sd = to_state_dict(load_torch_checkpoint(GOLDEN_CKPT))
    rng = np.random.default_rng(1)
    ev1, ev2 = (rng.standard_normal((1, 96, 128, BINS)).astype(np.float32) for _ in range(2))
    for label, kw in (("standard", {}), ("fused", dict(fast_head=True, fast_pyramid=True))):
        model = get_eval_model("eemflow", **kw)
        model.load_state_dict(sd)
        with torch.inference_mode():
            _, ref = model(torch.from_numpy(ev1), torch.from_numpy(ev2))
            model.to(device)
            _, got = model(torch.from_numpy(ev1).to(device), torch.from_numpy(ev2).to(device))
        err = float((got[-1].cpu() - ref[-1]).abs().max())
        say(f"forward 96x128 {label} card vs CPU: max|Δ| {err:.3e} (tolerance {FORWARD_TOL:g}), "
            f"largest flow {float(ref[-1].abs().max()):.3f}")
        require(bool(torch.isfinite(got[-1]).all()) and err <= FORWARD_TOL,
                f"{label} forward on the card disagrees with the CPU")
    launches.update(phase_end_to_end_eraft(device, tmp))
    launches.update(phase_end_to_end_plus(device, tmp))
    phase_serve(device, tmp)
    return launches


def phase_end_to_end_eraft(device: torch.device, tmp: str) -> dict:
    """ERAFT through the CLI on one sample: the module path, then K5 (the
    slice's main path) in float32 and in bf16, each with its own launch
    counts; then a 64x96 forward on the card against the CPU."""
    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model
    from eemflow_tpu_torch.tools.test_hrem import main as test_hrem

    with open(ERAFT_JSON) as f:
        golden = json.load(f)
    root = make_hrem_fixture(os.path.join(tmp, "eraft"), seed=golden["fixture_seed"])
    aee = {}
    counts = {}
    for label, cfg in (
        ("module path", None),
        ("fused_update", {"fused_update": True}),
        ("fused_update bf16", {"fused_update": True, "fused_dtype": "bf16"}),
        ("stacked lookup", {"stacked_lookup": True}),
        ("fused_update, stacked lookup", {"fused_update": True, "stacked_lookup": True}),
    ):
        extra = []
        if cfg is not None:
            path = os.path.join(tmp, f"eraft_{len(aee)}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            extra = ["--config", path]
        reset_launch_counts()
        t0 = time.perf_counter()
        res = test_hrem([
            "-model", "eraft", "-int", "dt1", "--data_root", root, "--checkpoint", ERAFT_CKPT,
            "--save_dir", os.path.join(tmp, "out_eraft"), "--max_samples", str(golden["max_samples"]),
            "--device", str(device), *extra,
        ])
        counts[label] = dict(launch_counts)
        aee[label] = res["mean"]["AEE"]
        say(f"ERAFT {label} (config {cfg}): AEE {aee[label]:.7f} over {res['indoor_fast']['n_samples']} "
            f"sample in {time.perf_counter() - t0:.1f} s; launches {counts[label]}")
    std, fused, bf16 = (aee[k] for k in ("module path", "fused_update", "fused_update bf16"))
    say(f"ERAFT golden AEE {golden['aee']:.7f}: module path |Δ| {abs(std - golden['aee']):.3e} (tolerance "
        f"{GOLDEN_TOL:g}); fused_update vs module path |Δ| {abs(fused - std):.3e} (tolerance "
        f"{ERAFT_FUSED_TOL:g}); bf16 vs float32 fused |Δ| {abs(bf16 - fused):.3e} (tolerance "
        f"{ERAFT_BF16_TOL:g})")
    require(abs(std - golden["aee"]) < GOLDEN_TOL, "ERAFT golden AEE drifted")
    require(abs(fused - std) < ERAFT_FUSED_TOL, "ERAFT's fused_update AEE differs from the module path")
    require(abs(bf16 - fused) < ERAFT_BF16_TOL, "ERAFT's bf16 fused_update AEE is off")
    for label, base in (("stacked lookup", std), ("fused_update, stacked lookup", fused)):
        say(f"ERAFT {label} vs the per-level lookup: AEE |Δ| {abs(aee[label] - base):.3e} (tolerance {STACKED_TOL:g})")
        require(abs(aee[label] - base) <= STACKED_TOL, f"ERAFT's {label} AEE differs from the per-level lookup's")
    require(counts["module path"]["update_block"] == counts["stacked lookup"]["update_block"] == 0,
            "the module path launched K5")
    for label in ("fused_update", "fused_update bf16", "fused_update, stacked lookup"):
        require(counts[label]["update_block_relayout"] == 0,
                f"ERAFT {label} copied an input of K5 into another layout")
    # one sample, 12 iterations, two entry points each
    for label in ("fused_update", "fused_update bf16", "fused_update, stacked lookup"):
        require(counts[label]["update_block"] == 24, f"ERAFT {label} did not launch K5 24 times")

    sd = to_state_dict(load_torch_checkpoint(ERAFT_CKPT))
    rng = np.random.default_rng(3)
    ev1, ev2 = (rng.standard_normal((1, 64, 96, BINS)).astype(np.float32) for _ in range(2))
    for label, kw in (("module path", {}), ("fused_update", {"fused_update": True})):
        model = get_eval_model("eraft", **kw)
        model.load_state_dict(sd)
        with torch.inference_mode():
            _, ref = model(torch.from_numpy(ev1), torch.from_numpy(ev2))
            model.to(device)
            _, got = model(torch.from_numpy(ev1).to(device), torch.from_numpy(ev2).to(device))
        err = float((got.cpu() - ref).abs().max())
        say(f"ERAFT forward 64x96 {label} card vs CPU: max|Δ| {err:.3e} (tolerance {FORWARD_TOL:g}), "
            f"largest flow {float(ref.abs().max()):.3f}")
        require(bool(torch.isfinite(got).all()) and err <= FORWARD_TOL,
                f"ERAFT {label} forward on the card disagrees with the CPU")
    # RAFT (seeded weights, 5 input channels: the HREM bins) on the card
    # against the CPU, its inputs scaled to the image range it normalises
    torch.manual_seed(0)
    model = get_eval_model("raft", n_first_channels=BINS)
    x1, x2 = (torch.from_numpy(255 * (e - e.min()) / (e.max() - e.min())) for e in (ev1, ev2))
    with torch.inference_mode():
        _, ref = model(x1, x2)
        model.to(device)
        _, got = model(x1.to(device), x2.to(device))
    err = float((got.cpu() - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    say(f"RAFT forward 64x96 (5 channels, seeded weights) card vs CPU: max|Δ| {err:.3e} (tolerance "
        f"{FORWARD_TOL:g}·{scale:.2f})")
    require(bool(torch.isfinite(got).all()) and err <= FORWARD_TOL * scale,
            "RAFT's forward on the card disagrees with the CPU")
    return {"update_block": counts["fused_update"]["update_block"]}


def forward_flows(model, ev1, ev2):
    with torch.inference_mode():
        return model(ev1, ev2)[1][-1]


def phase_end_to_end_plus(device: torch.device, tmp: str) -> dict:
    """EEMFlow+ through the eval CLI on the golden sample at 720x1280: the
    standard path, then ``--fast_pyramid --fast_decoders --fast_sgu`` (K3's
    launches for the pyramid, the SGU and the decoders), each with its own
    launch counts; K2 five launches a forward.  Then a 96x128 forward on
    the card against the CPU."""
    from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model
    from eemflow_tpu_torch.tools.test_hrem import main as test_hrem

    with open(PLUS_JSON) as f:
        golden = json.load(f)
    root = make_hrem_fixture(os.path.join(tmp, "plus"), seed=golden["fixture_seed"])
    aee, counts = {}, {}
    for label, extra in (("standard", []), ("fused", ["--fast_pyramid", "--fast_decoders", "--fast_sgu"])):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = test_hrem([
            "-model", "eemflow_plus", "-int", "dt1", "--data_root", root, "--checkpoint", PLUS_CKPT,
            "--save_dir", os.path.join(tmp, "out_plus"), "--max_samples", str(golden["max_samples"]),
            "--device", str(device), *extra,
        ])
        counts[label] = dict(launch_counts)
        aee[label] = res["mean"]["AEE"]
        say(f"EEMFlow+ {label} {extra}: AEE {aee[label]:.7f} over {res['indoor_fast']['n_samples']} sample in "
            f"{time.perf_counter() - t0:.1f} s; launches {counts[label]}")
    std, fused = aee["standard"], aee["fused"]
    say(f"EEMFlow+ golden AEE {golden['aee']:.7f}: standard |Δ| {abs(std - golden['aee']):.3e}, fused |Δ| "
        f"{abs(fused - golden['aee']):.3e} (tolerance {GOLDEN_TOL:g}); fused vs standard |Δ| {abs(fused - std):.3e} "
        f"(tolerance {PATH_TOL:g})")
    require(abs(std - golden["aee"]) < GOLDEN_TOL and abs(fused - golden["aee"]) < GOLDEN_TOL,
            "EEMFlow+ golden AEE drifted")
    require(abs(fused - std) < PATH_TOL, "EEMFlow+'s fused AEE differs from the standard one")
    # one sample: one forward of two frames
    require(counts["standard"]["local_corr"] == 5 and counts["fused"]["local_corr"] == 5,
            "EEMFlow+ did not take five K2 launches a forward")
    # the pyramid's 6 chains in one launch each, the 9 SGU and decoder chains
    # in the launches of their plans
    chains = plus_chain_launches()
    require(counts["standard"]["fused_convs_pool"] == 0 and counts["fused"]["fused_convs_pool"] == 6 + chains,
            f"EEMFlow+'s fused forward did not take 6 + {chains} K3 launches (the pyramid's 6 chains; the SGU "
            "at levels 5..2 and the decoders at 6..2 as their plans cut them)")

    rng = np.random.default_rng(31)
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((1, 96, 128, BINS)).astype(np.float32)) for _ in range(2))
    ref = None
    for label, kw in (("standard", {}), ("fused", dict(fast_pyramid=True, fast_decoders=True, fast_sgu=True))):
        model = get_eval_model("eemflow_plus", **kw)
        load_model_checkpoint(model, PLUS_CKPT, "eemflow_plus")
        if ref is None:
            ref = forward_flows(model, ev1, ev2)
        got = forward_flows(model.to(device), ev1.to(device), ev2.to(device)).cpu()
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max())
        say(f"EEMFlow+ forward 96x128 {label}, card vs the CPU's standard forward: max|Δ| {err:.3e} (tolerance "
            f"{PLUS_TOL:g}·{scale:.2f})")
        require(bool(torch.isfinite(got).all()) and err <= PLUS_TOL * scale,
                f"EEMFlow+ {label} forward on the card disagrees with the CPU")
    return {"fused_convs_pool_plus_chains": chains}


def make_serve_stream(base: str, n_frames: int = SERVE_FRAMES, n_events: int = 30000, seed: int = 41) -> str:
    """A consecutive synthetic dt1 stream at 720x1280 in the HREM test
    layout: ``n_frames`` samples, sample i's events2 = sample i+1's
    events1, 30,000 events a window; a random flow.flo each (the eval
    dataset reads it)."""
    from eemflow_tpu_torch.events.io import write_flo

    rng = np.random.default_rng(seed)
    windows = [dict(x=rng.integers(0, W, n_events).astype(np.int32), y=rng.integers(0, H, n_events).astype(np.int32),
                    t=np.sort(rng.integers(0, 10**9, n_events)).astype(np.int64),
                    p=rng.integers(0, 2, n_events).astype(np.int8)) for _ in range(n_frames + 1)]
    root = os.path.join(base, "serve")
    for i in range(n_frames):
        d = os.path.join(root, "test", "dt1", "indoor_fast", f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "events1.npz"), **windows[i])
        np.savez(os.path.join(d, "events2.npz"), **windows[i + 1])
        write_flo((rng.standard_normal((H, W, 2)) * 2).astype(np.float32), os.path.join(d, "flow.flo"))
    return root


def read_flows(out_dir: str) -> dict:
    from eemflow_tpu_torch.events.io import read_flo

    return {f: read_flo(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))}


# serving modes of phase 3 (EEMFlow, golden checkpoint): (label, flags, K1
# calls on the 8-frame stream: two a sample in pair mode, one a frame in a
# stream after its prime, none with host voxelize)
SERVE_MODES = (
    ("pair", [], 2 * SERVE_FRAMES),
    ("stream", ["--stream"], 1 + SERVE_FRAMES),
    ("stream chunk 2", ["--stream", "--chunk", "2"], 1 + SERVE_FRAMES),
    ("stream chunk 8", ["--stream", "--chunk", str(SERVE_FRAMES)], 1 + SERVE_FRAMES),
    ("batch 2 stream", ["--batch", "2", "--stream"], 2 + SERVE_FRAMES // 2),
    ("host_voxelize", ["--host_voxelize"], 0),
    ("host_voxelize stream chunk 4", ["--host_voxelize", "--stream", "--chunk", "4"], 0),
    ("bf16", ["--bf16"], 2 * SERVE_FRAMES),
    ("fast", ["--fast"], 2 * SERVE_FRAMES),
)


def phase_serve(device: torch.device, tmp: str) -> None:
    """The serving CLI on a consecutive 720x1280 stream (8 frames, 30,000
    events a window) with the golden EEMFlow checkpoint, in every mode, each
    with its launch counts set to 0 just before it: the packer on its
    native path; pair mode against the eval path's flow (``Tester`` with
    device voxelize) for the same samples; ``--stream``, ``--chunk`` and
    ``--batch 2 --stream`` against pair mode; ``--host_voxelize``'s grids
    against K1's and its flows against pair mode; ``--bf16`` against
    float32; ``--fast`` against the standard path; K1 once a frame in a
    stream's steady state, twice a sample in pair mode.  Then EEMFlow+
    served once."""
    from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.data.hrem import HREMEventFlow
    from eemflow_tpu_torch.eval.runner import Tester
    from eemflow_tpu_torch.events.voxel import voxelize_batch_nhwc
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model
    from eemflow_tpu_torch.native import HostVoxelizer
    from eemflow_tpu_torch.tools.serve import main as serve

    phase("3 serve: the serving CLI at 720x1280 on a consecutive stream, golden checkpoint")
    root = make_serve_stream(tmp)
    flows, counts = {}, {}
    for label, extra, k1_calls in SERVE_MODES:
        out = os.path.join(tmp, "served", label.replace(" ", "_").replace(",", ""))
        reset_launch_counts()
        t0 = time.perf_counter()
        res = serve(["--checkpoint", GOLDEN_CKPT, "--data_root", root, "--size", str(H), str(W), "--warmup", "0",
                     "--out_dir", out, "--device", str(device), *extra])
        counts[label] = dict(launch_counts)
        flows[label] = read_flows(out)
        say(f"serve {label} {extra}: {res['frames']} frames in {time.perf_counter() - t0:.1f} s (with the model's "
            f"load); packer {res['packer']}; launches {counts[label]}")
        require(res["packer"].startswith("native") and res["frames"] == SERVE_FRAMES
                and len(flows[label]) == SERVE_FRAMES, f"serve {label} did not serve every frame on the native packer")
        require(counts[label]["voxel_scatter"] == k1_calls,
                f"serve {label}: {counts[label]['voxel_scatter']} K1 calls, not {k1_calls}")
        if label != "fast":
            require(counts[label]["local_corr"] == SERVE_FRAMES // (2 if "batch 2" in label else 1),
                    f"serve {label} did not take one K2 launch a forward")
    say(f"K1 calls on the {SERVE_FRAMES}-frame stream: pair {counts['pair']['voxel_scatter']} (two a sample), stream "
        f"{counts['stream']['voxel_scatter']} (one prime, then one a frame), chunk 2 "
        f"{counts['stream chunk 2']['voxel_scatter']}, batch 2 stream {counts['batch 2 stream']['voxel_scatter']} "
        f"(two primes, one batched call a frame of both rows), host_voxelize {counts['host_voxelize']['voxel_scatter']}")

    # pair mode against the eval path (test_hrem --device_voxelize's Tester)
    model = get_eval_model("eemflow")
    load_model_checkpoint(model, GOLDEN_CKPT, "eemflow")
    ds = HREMEventFlow(root, raw_events=True, bucket_size=1 << 16)
    ds.change_test_sequence("indoor_fast")
    tester = Tester(model, device, preprocess=make_device_preprocess(BINS, H, W))
    pair = flows["pair"]
    names = sorted(pair)
    err = max(float(np.abs(tester.run_sample(ds[i]) - pair[n]).max()) for i, n in enumerate(names))
    say(f"serve pair .flo vs the eval path's flow (Tester, device voxelize) on the same samples: max|Δ| {err:.3e} "
        f"(tolerance {SERVE_TOL:g}); largest |flow| {max(float(np.abs(f).max()) for f in pair.values()):.3f}")
    require(err <= SERVE_TOL, "the served flow differs from the eval path's")
    for label in ("stream", "stream chunk 2", "stream chunk 8", "batch 2 stream", "host_voxelize",
                  "host_voxelize stream chunk 4"):
        err = max(float(np.abs(flows[label][n] - pair[n]).max()) for n in names)
        say(f"serve {label} vs pair: max|Δ| {err:.3e} (tolerance {SERVE_TOL:g})")
        require(err <= SERVE_TOL, f"serve {label} differs from pair mode")

    # host voxelize: the grids against K1's on the same packed events
    hvox = HostVoxelizer(BINS, H, W)
    grid_err, grid_scale = 0.0, 1.0
    for i in range(len(ds)):
        s = ds[i]
        for key in ("old", "new"):
            rows, n = s[f"events_{key}"], int(s[f"n_{key}"])
            host = torch.from_numpy(hvox(rows, n))
            dev = voxelize_batch_nhwc(torch.from_numpy(rows)[None].to(device),
                                      torch.tensor([n], dtype=torch.int32).to(device), BINS, H, W)
            dev = dev.permute(0, 3, 1, 2)[0].cpu()
            grid_err = max(grid_err, float((host - dev).abs().max()))
            grid_scale = max(grid_scale, float(dev.abs().max()))
    say(f"serve --host_voxelize grids vs K1 voxelize on the same packed events: max|Δ| {grid_err:.3e} (tolerance "
        f"{HOSTVOX_GRID_TOL:g}·{grid_scale:.2f})")
    require(grid_err <= HOSTVOX_GRID_TOL * grid_scale, "the host voxelizer's grids differ from K1's")

    a = np.stack([pair[n] for n in names])
    b = np.stack([flows["bf16"][n] for n in names])
    rel = float(np.linalg.norm(b - a) / np.linalg.norm(a))
    say(f"serve --bf16 vs float32: relative L2 {rel:.3e} (limit {SERVE_BF16_REL_L2:g}), max|Δ| "
        f"{float(np.abs(b - a).max()):.3e}")
    require(np.isfinite(b).all() and rel <= SERVE_BF16_REL_L2, "bf16 serving is off float32 beyond its limit")
    f = np.stack([flows["fast"][n] for n in names])
    epe = float(np.linalg.norm(f - a, axis=-1).mean())
    err = float(np.abs(f - a).max())
    say(f"serve --fast ({fast_eval_kwargs('eemflow')}) vs the standard path: mean end-point distance {epe:.3e} px "
        f"(limit {FAST_EPE_TOL:g}), max|Δ| {err:.3e} (tolerance {FORWARD_TOL:g}); launches {counts['fast']}")
    require(epe <= FAST_EPE_TOL and err <= FORWARD_TOL, "--fast is not parity-safe")
    fast = fast_eval_kwargs("eemflow")
    require(counts["fast"]["coarse_head"] == (SERVE_FRAMES if fast.get("fast_head") else 0)
            and counts["fast"]["fused_convs_pool"] == (6 * SERVE_FRAMES if fast.get("fast_pyramid") else 0),
            f"serve --fast ({fast}) did not launch the kernels of its modes once a forward")

    # EEMFlow+ served once
    out = os.path.join(tmp, "served", "plus")
    reset_launch_counts()
    res = serve(["-model", "eemflow_plus", "--checkpoint", PLUS_CKPT, "--data_root", root, "--size", str(H), str(W),
                 "--warmup", "0", "--out_dir", out, "--device", str(device)])
    plus_counts = dict(launch_counts)
    plus = read_flows(out)
    say(f"serve -model eemflow_plus: {res['frames']} frames; launches {plus_counts}")
    require(res["frames"] == SERVE_FRAMES and all(np.isfinite(v).all() and v.shape == (H, W, 2) for v in plus.values())
            and plus_counts["local_corr"] == 5 * SERVE_FRAMES and plus_counts["voxel_scatter"] == 2 * SERVE_FRAMES,
            "serve -model eemflow_plus did not serve finite flows with K1 twice and K2 five times a sample")


TRAIN_BATCH = 6  # the config's bs
TRAIN_STEPS, TRAIN_EPOCH = 4, 2  # --train_iters, --val_iters: two epochs, two checkpoints
# one float32 train step at 128x256 B=2, the card against the CPU: the loss
# relative, each parameter's gradient relative to its largest |g| (float32
# in other summation orders through two pyramids and their backward)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# the two-volume models beyond EEMFlow, trained against the full-resolution
# flow (--full_res_flow): config, voxel bins, K2 launches a step (EEMFlow+'s
# five correlations; ERAFT's all-pairs volume is a matmul), and the
# gradient's unit in the card-against-CPU step: each leaf's own largest
# (EEMFlow+, as EEMFlow) or the model's largest (ERAFT, which normalises
# before nearly every ReLU: a float32 rounding that flips one unit moves a
# leaf by ~1% of its own largest; tests/test_torch_train_two_volume.py)
TWO_VOLUME = {
    "eemflow_plus": {"config": "hrem_eemflow_plus.json", "bins": 15, "k2": 5, "per_leaf": True},
    "eraft": {"config": "hrem_meshflow.json", "bins": 5, "k2": 0, "per_leaf": False},
}
# batch sizes tried for them, the recipe's B=6 first (the largest that fits
# a float32 step is used, and printed)
TWO_VOLUME_BATCHES = (6, 4, 3, 2, 1)
# the learning rate of their 20-step loss check: EEMFlow+'s config's
TWO_VOLUME_LR = 1e-4
# ERAFT's golden AEE with stacked_lookup against the per-level lookup (the
# same function, the same sums and zeros added)
STACKED_TOL = 1e-5


def train_config(tmp: str, mixed_precision: bool, name: str = "hrem_meshflow.json") -> str:
    """A training config (the default one unless ``name``), or a copy of it
    with ``mixed_precision`` set otherwise."""
    path = os.path.join(REPO, "configs", name)
    with open(path) as f:
        cfg = json.load(f)
    if cfg["train"]["mixed_precision"] == mixed_precision:
        return path
    cfg["train"]["mixed_precision"] = mixed_precision
    path = os.path.join(tmp, f"{name[:-5]}_mp{int(mixed_precision)}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_train(device: torch.device, tmp: str) -> dict:
    """The port's training CLI on a seeded synthetic HREM train split at
    720x1280: B=6, device voxelize, two epochs of two steps, in bf16 (the
    default config) with a ``-se 1`` resume, and in float32; each run's
    launch counts set to 0 just before it and read just after.  Then one
    train step on the card against the same step on the CPU, and 20 steps
    on one batch."""
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.tools.train_hrem import main as train_hrem

    phase("3b train: the HREM training CLI at 720x1280, B=6, device voxelize")
    root = make_hrem_train_fixture(tmp, n_samples=TRAIN_BATCH)
    common = ["--data_root", root, "-bs", str(TRAIN_BATCH), "--device_voxelize", "--train_iters",
              str(TRAIN_STEPS), "--val_iters", str(TRAIN_EPOCH), "--device", str(device)]
    per_step = {}
    states = {}
    for label, mp in (("bf16 (default config)", True), ("float32", False)):
        save = os.path.join(tmp, f"train_{int(mp)}")
        args = common + ["--config", train_config(tmp, mp), "--save_dir", save]
        reset_launch_counts()
        t0 = time.perf_counter()
        state = train_hrem(args)
        counts = dict(launch_counts)
        run = os.path.join(save, "eemflow_dt1_lr1e-05_wd0.0")
        recs = read_jsonl(os.path.join(run, "metrics.jsonl"))
        ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
        say(f"train CLI {label}: {TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s; step {state.step}, next "
            f"lr {state.opt.lr:.6e}; epochs {[(r['epoch'], r['n_steps'], r['mean_loss']) for r in recs]}; "
            f"checkpoints {ckpts}; launches {counts}")
        require(state.step == TRAIN_STEPS and ckpts == ["epoch_1.pt", "epoch_2.pt"]
                and [r["kind"] for r in recs] == ["epoch", "epoch"]
                and all(np.isfinite(r["mean_loss"]) and np.isfinite(r["mean_aee"]) for r in recs),
                f"the {label} training run did not take its steps, log finite losses and checkpoint each epoch")
        require(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in state.model.parameters()),
                f"the {label} run's master parameters are not finite float32")
        require(counts["voxel_scatter"] == 2 * TRAIN_STEPS and counts["local_corr"] == TRAIN_STEPS,
                f"{label}: {counts['voxel_scatter']} K1 calls and {counts['local_corr']} K2 launches in "
                f"{TRAIN_STEPS} steps, not 2 and 1 a step")
        per_step[label] = (counts["voxel_scatter"] / TRAIN_STEPS, counts["local_corr"] / TRAIN_STEPS)
        states[label] = state
        if mp:
            reset_launch_counts()
            resumed = train_hrem(args + ["-se", "1"])
            with open(os.path.join(run, "log.txt")) as f:
                log = f.read()
            say(f"train CLI {label} resumed with -se 1: step {resumed.step}, next lr {resumed.opt.lr:.6e}, schedule "
                f"step {resumed.opt.scheduler.last_epoch} (the uninterrupted run: {state.step}, {state.opt.lr:.6e}, "
                f"{state.opt.scheduler.last_epoch}); launches {dict(launch_counts)}")
            require("resumed from epoch 1" in log and resumed.step == state.step
                    and resumed.opt.lr == state.opt.lr
                    and resumed.opt.scheduler.last_epoch == state.opt.scheduler.last_epoch,
                    "the resumed run's step and learning rate do not continue the uninterrupted run's")
    train_step_card_vs_cpu(device)
    train_steps_lower_the_loss(device, root)
    return {"voxel_scatter_per_train_step": per_step["bf16 (default config)"][0],
            "local_corr_per_train_step": per_step["bf16 (default config)"][1]}


def train_step_card_vs_cpu(device: torch.device, name: str = "eemflow") -> None:
    """One float32 train step (device voxelize with flips, forward, loss,
    backward, clip, AdamW) from the same seeded parameters and batch at
    128x256, B=2: on the card (the kernels) and on the CPU (their plain
    versions); the loss and every parameter's gradient compared.  EEMFlow
    against the 16x16 meshflow label, the two-volume models against the
    full-resolution flow."""
    h, w, B, N = 128, 256, 2, 8192
    spec = TWO_VOLUME.get(name, {"bins": BINS, "k2": 1, "per_leaf": True})
    label = (16, 16) if name == "eemflow" else (h, w)
    ev, nv = k1_batch(np.random.default_rng(13), (N, N - 100, N - 7, N), N=N, h=h, w=w)
    rng = np.random.default_rng(14)
    batch = {
        "events_old": ev[:B], "events_new": ev[B:], "n_old": nv[:B], "n_new": nv[B:],
        "flip_h": np.array([True, False]), "flip_v": np.array([False, True]),
        "flow": (rng.standard_normal((B, *label, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, *label), np.float32),
    }
    runs = step_on_cpu_and_card(device, lambda dev: train_state(dev, seed=5, lr=1e-3, name=name, num_steps=100),
                                batch, spec["bins"], h, w)
    (loss_cpu, g_cpu, n_cpu), (loss_gpu, g_gpu, n_gpu) = runs["cpu"], runs["card"]
    top = max(float(g.abs().max()) for g in g_cpu.values())
    unit = (lambda g: float(g.abs().max())) if spec["per_leaf"] else (lambda g: top)
    worst = max(float((g_gpu[n] - g).abs().max()) / unit(g) for n, g in g_cpu.items())
    unit_name = "its" if spec["per_leaf"] else "the model's"
    whole = float(torch.cat([(g_gpu[n] - g).flatten() for n, g in g_cpu.items()]).norm()
                  / torch.cat([g.flatten() for g in g_cpu.values()]).norm())
    say(f"one float32 {name} train step at {h}x{w} B={B}, card (K1 calls, K2 launches {n_gpu}) vs CPU (plain "
        f"versions, {n_cpu}): loss {loss_gpu:.7f} vs {loss_cpu:.7f} (|Δ| relative "
        f"{abs(loss_gpu - loss_cpu) / loss_cpu:.3e}, tolerance {TRAIN_LOSS_RTOL:g}); grads: the worst parameter's "
        f"max|Δ| is {worst:.3e} of {unit_name} largest |g| (tolerance "
        f"{TRAIN_GRAD_TOL:g}); the whole gradient {whole:.3e} relative L2")
    require(n_gpu == (2, spec["k2"]) and n_cpu == (0, 0),
            f"the card's {name} train step did not run K1 twice and K2 {spec['k2']} times")
    require(np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)
            and worst <= TRAIN_GRAD_TOL and whole <= TRAIN_GRAD_TOL,
            f"the {name} train step on the card disagrees with the CPU")


def step_on_cpu_and_card(device: torch.device, make_state, batch: dict, bins: int, h: int, w: int) -> dict:
    """One float32 train step (device voxelize from the raw-event ``batch``,
    forward, loss, backward, clip, AdamW) of ``make_state(device)`` on the
    CPU and on the card: per side (loss, each parameter's gradient before
    the clip, on the CPU, (K1 calls, K2 launches))."""
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.train.trainer import make_train_step

    runs = {}
    for key, dev in (("cpu", torch.device("cpu")), ("card", device)):
        state = make_state(dev)
        grads = {}
        opt_step = state.opt.step

        def step_recording_grads(state=state, grads=grads, opt_step=opt_step):
            # a parameter the loss does not reach has no .grad (the optimizer
            # gives it zeros)
            grads.update({n: torch.zeros(p.shape) if p.grad is None else p.grad.detach().cpu().clone()
                          for n, p in state.model.named_parameters()})
            return opt_step()

        state.opt.step = step_recording_grads
        before = dict(launch_counts)
        _, metrics = make_train_step(preprocess=make_device_preprocess(bins, h, w))(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        runs[key] = (float(metrics["loss"]), grads,
                     (launch_counts["voxel_scatter"] - before["voxel_scatter"],
                      launch_counts["local_corr"] - before["local_corr"]))
    return runs


def train_batch(root: str, device: torch.device, seed: int = 0, batch: int = TRAIN_BATCH,
                full_res_flow: bool = False) -> dict:
    """One raw-event batch of the synthetic train split (flips drawn from
    ``seed``; the meshflow label, or the full-resolution flow), on the card."""
    from eemflow_tpu_torch.data.hrem import HREMEventFlow
    from eemflow_tpu_torch.data.loader import collate
    from eemflow_tpu_torch.train.trainer import batch_to_device

    ds = HREMEventFlow(root, train=True, raw_events=True, bucket_rungs=4, full_res_flow=full_res_flow,
                       aug_params={"crop_size": [512, 960], "do_flip": True}, rng=np.random.default_rng(seed))
    return batch_to_device(collate([ds[i % len(ds)] for i in range(batch)]), device)


def train_state(device: torch.device, seed: int = 0, lr: float = 1e-4, name: str = "eemflow", num_steps: int = 1000):
    """A fresh train state: EEMFlow at the meshflow label's 16x16, the
    two-volume models at full resolution with their bins."""
    from eemflow_tpu_torch.models.registry import get_model
    from eemflow_tpu_torch.train.optim import make_optimizer
    from eemflow_tpu_torch.train.trainer import create_train_state

    kw = {"out_mesh_size": True} if name == "eemflow" else {"n_first_channels": TWO_VOLUME[name]["bins"]}
    return create_train_state(get_model(name, **kw), seed, make_optimizer(lr, num_steps=num_steps), device=device)


def train_steps_lower_the_loss(device: torch.device, root: str, name: str = "eemflow",
                               batch: int = TRAIN_BATCH, lr: float = 1e-3) -> None:
    """20 bf16 steps (the default mixed precision) on one fixed 720x1280
    batch lower its loss."""
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.train.trainer import make_train_step

    bins = TWO_VOLUME[name]["bins"] if name in TWO_VOLUME else BINS
    data = train_batch(root, device, batch=batch, full_res_flow=name != "eemflow")
    state = train_state(device, lr=lr, name=name)
    step = make_train_step(preprocess=make_device_preprocess(bins, H, W), mixed_precision=True)
    losses = [float(step(state, data)[1]["loss"]) for _ in range(20)]
    say(f"20 bf16 {name} steps (lr {lr:g}) on one 720x1280 B={batch} batch: loss {losses[0]:.6f} → "
        f"{losses[-1]:.6f} (every 5th: {[round(x, 6) for x in losses[::5]]})")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], f"20 {name} steps on one batch did not lower its loss")


def largest_batch(device: torch.device, root: str, name: str) -> tuple:
    """The largest of ``TWO_VOLUME_BATCHES`` at which one float32 train step
    of ``name`` at 720x1280 (device voxelize, full-resolution flow) fits on
    the card, and that step's peak allocated bytes."""
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.train.trainer import make_train_step

    def attempt(b):
        data = train_batch(root, device, batch=b, full_res_flow=True)
        state = train_state(device, name=name)
        step = make_train_step(preprocess=make_device_preprocess(TWO_VOLUME[name]["bins"], H, W))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        step(state, data)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(device)

    for b in TWO_VOLUME_BATCHES:
        try:
            peak = attempt(b)
        except torch.cuda.OutOfMemoryError as e:
            say(f"{name}: a float32 train step at 720x1280 B={b} does not fit the card ({str(e).splitlines()[0]})")
            peak = None
        torch.cuda.empty_cache()
        if peak is not None:
            say(f"{name}: a float32 train step at 720x1280 B={b} fits, peak allocated {peak / 2**30:.3f} GiB of "
                f"{torch.cuda.get_device_properties(device).total_memory / 2**30:.1f}")
            return b, peak
    raise SmokeFailure(f"{name}: no float32 train step at 720x1280 fits the card, down to B=1")


def phase_train_two_volume(device: torch.device, tmp: str) -> dict:
    """EEMFlow+ (its config: 15 bins, bf16) and ERAFT through the training
    CLI with ``--full_res_flow --device_voxelize`` on phase 3b's train split,
    at the largest batch of the recipe's B=6 or below that fits, in bf16 and
    float32: each run's launch counts set to 0 just before it and read just
    after (K1 two calls a step, K2 EEMFlow+'s five correlations, no K3, K4
    or K5), finite losses and two checkpoints, the bf16 run resumed with
    ``-se 1``; then one float32 step on the card against the CPU and 20
    bf16 steps on one batch."""
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.tools.train_hrem import main as train_hrem

    phase("3b train: EEMFlow+ and ERAFT through the HREM training CLI at 720x1280, --full_res_flow, "
          "device voxelize")
    root = os.path.join(tmp, "hrem_train")
    out = {}
    for name, spec in TWO_VOLUME.items():
        batch, peak = largest_batch(device, root, name)
        common = ["-model", name, "--full_res_flow", "--data_root", root, "-bs", str(batch), "--device_voxelize",
                  "--train_iters", str(TRAIN_STEPS), "--val_iters", str(TRAIN_EPOCH), "--device", str(device)]
        for label, mp in (("bf16", True), ("float32", False)):
            save = os.path.join(tmp, f"train_{name}_{int(mp)}")
            args = common + ["--config", train_config(tmp, mp, spec["config"]), "--save_dir", save]
            reset_launch_counts()
            t0 = time.perf_counter()
            state = train_hrem(args)
            counts = dict(launch_counts)
            run = os.path.join(save, f"{name}_dt1_lr1e-05_wd0.0")
            recs = read_jsonl(os.path.join(run, "metrics.jsonl"))
            ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
            first = next(state.model.parameters())
            say(f"train CLI {name} {label} B={batch}: {TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s; step "
                f"{state.step}, next lr {state.opt.lr:.6e}; epochs "
                f"{[(r['epoch'], r['n_steps'], r['mean_loss']) for r in recs]}; checkpoints {ckpts}; first conv "
                f"{tuple(first.shape)}; launches {counts}")
            require(state.step == TRAIN_STEPS and ckpts == ["epoch_1.pt", "epoch_2.pt"]
                    and [r["kind"] for r in recs] == ["epoch", "epoch"]
                    and all(np.isfinite(r["mean_loss"]) and np.isfinite(r["mean_aee"]) for r in recs),
                    f"the {name} {label} training run did not take its steps, log finite losses and checkpoint "
                    "each epoch")
            require(first.shape[1] == spec["bins"], f"{name}'s first conv does not take the config's {spec['bins']} bins")
            require(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in state.model.parameters()),
                    f"the {name} {label} run's master parameters are not finite float32")
            require(counts["voxel_scatter"] == 2 * TRAIN_STEPS and counts["local_corr"] == spec["k2"] * TRAIN_STEPS
                    and counts["fused_convs_pool"] == counts["coarse_head"] == counts["update_block"] == 0,
                    f"{name} {label}: launches {counts} in {TRAIN_STEPS} steps, not K1 2 and K2 {spec['k2']} a step "
                    "and no K3, K4 or K5")
            if mp:
                reset_launch_counts()
                resumed = train_hrem(args + ["-se", "1"])
                with open(os.path.join(run, "log.txt")) as f:
                    log = f.read()
                say(f"train CLI {name} {label} resumed with -se 1: step {resumed.step}, next lr "
                    f"{resumed.opt.lr:.6e}, schedule step {resumed.opt.scheduler.last_epoch} (the uninterrupted "
                    f"run: {state.step}, {state.opt.lr:.6e}, {state.opt.scheduler.last_epoch}); launches "
                    f"{dict(launch_counts)}")
                require("resumed from epoch 1" in log and resumed.step == state.step
                        and resumed.opt.lr == state.opt.lr
                        and resumed.opt.scheduler.last_epoch == state.opt.scheduler.last_epoch,
                        f"the resumed {name} run's step and learning rate do not continue the uninterrupted run's")
                del resumed
            del state
            torch.cuda.empty_cache()
        train_step_card_vs_cpu(device, name)
        train_steps_lower_the_loss(device, root, name, batch, lr=TWO_VOLUME_LR)
        torch.cuda.empty_cache()
        out[name] = {"batch": batch, "float32_peak_gib": peak / 2**30, "voxel_scatter_per_train_step": 2,
                     "local_corr_per_train_step": spec["k2"]}
    return out


def profiled_step(fn, reps: int, tmp: str) -> dict:
    """``reps`` calls of ``fn`` under torch.profiler, one run: its wall
    milliseconds a call, the device's busy milliseconds a call (the union
    of the kernels' and copies' intervals in the exported trace, so nothing
    counts twice) and their share of the wall time, and the device
    operations a call.  For work that launches more kernels than the
    card's launch queue holds, which ``queued_ms`` cannot queue behind one
    sleep.  Tracing slows the host's issue, so the wall time here is the
    profiled run's own, longer than back to back."""
    from eemflow_tpu_torch.tools.profile_model import device_busy_ms

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(tmp, "train_step_trace.json")
    prof.export_chrome_trace(trace)
    busy = device_busy_ms(trace)
    os.remove(trace)
    require(busy is not None, "the profiled train step shows no device work")
    # not the optimizer's user annotation, which the profiler also lists
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("Optimizer.")]
    return {"profiled_ms": wall_ms / reps, "busy_ms": busy / reps, "busy_share": busy / wall_ms,
            "device_ops": sum(e.count for e in ops) / reps}


def times_train(device: torch.device, tmp: str, two_volume: dict) -> dict:
    """One train step at 720x1280, device voxelize (K1 ×2, forward, loss,
    backward, clip, AdamW), in bf16 and float32: EEMFlow at B=6 (one K2
    launch), and EEMFlow+ (K2 ×5) and ERAFT at the batch phase 3b fitted,
    against the full-resolution flow; back to back (CUDA events), its device
    busy time and share in one profiled run (a step launches more kernels
    than the launch queue holds, so it cannot be queued behind a sleep), and
    its peak allocated memory."""
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.train.trainer import make_train_step

    root = os.path.join(tmp, "hrem_train")
    out = {}
    # (name, batch, warm-ups, reps, profiled reps): EEMFlow+'s and ERAFT's
    # steps take 0.2-2.2 s, so they take fewer
    models = [("eemflow", TRAIN_BATCH, 3, 5, 3)] + [(n, info["batch"], 1, 2, 1) for n, info in two_volume.items()]
    for name, batch_size, warmups, reps, prof_reps in models:
        bins = TWO_VOLUME[name]["bins"] if name in TWO_VOLUME else BINS
        batch = train_batch(root, device, batch=batch_size, full_res_flow=name != "eemflow")
        times = {"batch": batch_size} if name != "eemflow" else out
        for label, mp in (("bf16", True), ("float32", False)):
            state = train_state(device, name=name)
            step = make_train_step(preprocess=make_device_preprocess(bins, H, W), mixed_precision=mp)
            run = lambda: step(state, batch)
            for _ in range(warmups):
                run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
            b2b = cuda_ms(run, reps=reps, warmup=1)
            prof = profiled_step(run, reps=prof_reps, tmp=tmp)
            say(f"train step {name} 720x1280 B={batch_size} device voxelize, {label}: {b2b:.3f} ms back to back "
                f"({batch_size * 1e3 / b2b:.1f} samples/s); under torch.profiler {prof['profiled_ms']:.3f} ms a "
                f"step, the device busy {prof['busy_ms']:.3f} ms of it ({100 * prof['busy_share']:.1f}%, the union "
                f"of {prof['device_ops']:.0f} kernels and copies a step); peak allocated {peak / 2**30:.3f} GiB")
            times[label] = {"ms": b2b, "peak_gib": peak / 2**30, **prof}
            del state, step, run
            torch.cuda.empty_cache()
        if name != "eemflow":
            out[name] = times
    return out


def phase_times(device: torch.device, tmp: str, errs: dict, launches: dict, two_volume: dict, mvsec: dict) -> tuple:
    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.models.registry import get_eval_model

    phase("4 times (CUDA events, after a warm-up)")
    k1_row = times_k1(device, errs, launches)

    sd = to_state_dict(load_torch_checkpoint(GOLDEN_CKPT))
    model = get_eval_model("eemflow")
    model.load_state_dict(sd)
    model.to(device)
    stamp("K2")
    k2_row = times_k2(device, model, errs, launches)
    x1, x2 = (torch.randn(1, H, W, BINS, device=device) for _ in range(2))
    stamp("K3 and K4")
    k3_row, k4_row = times_k3_k4(device, model, x1, x2, errs, launches)
    stamp("EEMFlow forwards and a sample")
    times_forwards(device, model, sd, x1, x2)
    times_sample(device, model, tmp)

    stamp("K5 and ERAFT")
    k5_row = times_k5(device, errs, launches)
    times_eraft(device)
    stamp("--fast candidates")
    times_fast_candidates(device, sd, x1, x2)
    stamp("EEMFlow+")
    plus_row = times_plus(device, tmp, errs, launches)
    stamp("serve")
    times_serve(device, tmp)
    stamp("train steps")
    train = times_train(device, tmp, two_volume)
    stamp("MVSEC")
    mvsec_rows = times_mvsec(device, tmp, mvsec)
    # a two-volume train step's launches (phase 3b's counts)
    for row, key in ((k1_row, "voxel_scatter_per_train_step"), (k2_row, "local_corr_per_train_step")):
        for name, info in two_volume.items():
            row[f"launches_per_train_step_{name}"] = info[key]
    # each kernel at MVSEC's shapes, with its launches on the MVSEC paths
    for row in (k1_row, k2_row, k3_row, k4_row, k5_row):
        row.update(mvsec_rows[row["name"]])
    return [k1_row, k2_row, k3_row, plus_row, k4_row, k5_row], train


# the --fast candidates timed on the card (models/registry.FAST_EVAL_KWARGS
# maps EEMFlow to the fastest parity-safe one)
FAST_CANDIDATES = (
    ("standard", {}),
    ("siamese_stack", {"siamese_stack": True}),
    ("fast_head + fast_pyramid", {"fast_head": True, "fast_pyramid": True}),
    ("all three", {"siamese_stack": True, "fast_head": True, "fast_pyramid": True}),
)


def times_fast_candidates(device, sd, x1, x2) -> None:
    """The ``--fast`` candidates for EEMFlow, one 720x1280 B=1 forward each
    (golden weights): back to back, on the device (queued), and its flow
    against the standard forward's (max|Δ| and mean end-point distance)."""
    from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model

    ref = None
    for label, kw in FAST_CANDIDATES:
        m = get_eval_model("eemflow", **kw)
        m.load_state_dict(sd)
        m.to(device)
        flow = forward_flows(m, x1, x2)
        if ref is None:
            ref = flow
        err = float((flow - ref).abs().max())
        epe = float(torch.linalg.vector_norm(flow - ref, dim=-1).mean())
        b2b = cuda_ms(lambda: forward_flows(m, x1, x2), reps=20)
        dev = queued_ms(lambda: forward_flows(m, x1, x2), reps=2)
        say(f"--fast candidate {label} {kw}: EEMFlow forward 720x1280 B=1 {b2b:.3f} ms back to back "
            f"({1e3 / b2b:.1f} fps), {dev:.3f} ms on the device (queued); vs standard max|Δ| {err:.3e}, mean "
            f"end-point distance {epe:.3e} px (parity-safe: {epe <= FAST_EPE_TOL and err <= FORWARD_TOL})")
    say(f"--fast maps eemflow to {fast_eval_kwargs('eemflow')} (models/registry.FAST_EVAL_KWARGS)")


def plus_chain_launches(bf16: bool = False) -> int:
    """K3 launches of EEMFlow+'s 9 SGU and decoder chains in one fused
    720x1280 forward, as their plans cut them."""
    from eemflow_tpu_torch.kernels import fused_convs as k3

    sgu = k3.chain_spec(64, _SGU[0], _SGU[1])
    dec = k3.chain_spec(87, _DEC[0], None, _G, _G)
    return 4 * len(k3.plan_chain(sgu, None, bf16)) + 5 * len(k3.plan_chain(dec, None, bf16))


# EEMFlow+'s --fast candidates (models/registry.FAST_EVAL_KWARGS maps
# eemflow_plus to the fastest parity-safe one that beats the standard
# forward back to back, else to none)
PLUS_FAST_CANDIDATES = (
    ("standard", {}),
    ("siamese_stack", {"siamese_stack": True}),
    ("fast_pyramid", {"fast_pyramid": True}),
    ("fast_sgu + fast_decoders", {"fast_sgu": True, "fast_decoders": True}),
    ("fast_sgu + fast_decoders + siamese_stack", {"fast_sgu": True, "fast_decoders": True, "siamese_stack": True}),
    ("all three fused", {"fast_pyramid": True, "fast_sgu": True, "fast_decoders": True}),
)


def times_plus(device, tmp: str, errs: dict, launches: dict) -> dict:
    """EEMFlow+ at 720x1280 B=1 (golden weights): K3 on the 9 SGU and
    decoder chains of one fused forward, on the forward's own inputs, in
    float32 and bf16: on the device (queued, after an L2 flush, and warm)
    and per wrapper call back to back, beside their bound in the tensor
    cores' unit (float32: the three TF32 products of the split at the TF32
    peak; bf16 at the bf16 peak; or the bytes) and the SIMT figure, the
    plain versions and the standard modules for the same work (cuDNN: the
    SGU's dense estimator, the decoders); each chain's plan and device
    time, the instances' registers, spills and CTAs an SM, and the level-2
    chains at other cuts than the plan's; then the ``--fast`` candidates
    for EEMFlow+, and the standard and fused forwards back to back and the
    device's busy time and share of one profiled run of each."""
    import eemflow_tpu_torch.models.eemflow_plus as plus_module
    from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model
    from eemflow_tpu_torch.ops.fused_convs import chain_channels

    fused_kw = dict(fast_pyramid=True, fast_decoders=True, fast_sgu=True)
    models = {}
    for label, kw in (("standard", {}), ("fused", fused_kw), ("fused bf16", dict(fused_kw, fast_dtype="bf16"))):
        models[label] = get_eval_model("eemflow_plus", **kw)
        load_model_checkpoint(models[label], PLUS_CKPT, "eemflow_plus")
        models[label].to(device)
    x1, x2 = (torch.randn(1, H, W, BINS, device=device) for _ in range(2))
    # the SGU and decoder chains of one fused forward (the pyramid's have at
    # most 2 convs), with their inputs, in each operand mode
    real = plus_module.fused_convs
    calls = {}
    for label in ("fused", "fused bf16"):
        rec = calls[label] = []

        def recording(x, ws, bs, pool, dtype=torch.float32, emit_full=True, relus=None, concat=None,
                      packed=None, groups=None, shuffle=None, rec=rec):
            if len(ws) > 2:
                rec.append((x, ws, bs, pool, dtype, emit_full, relus, concat, packed, groups, shuffle))
            return real(x, ws, bs, pool, dtype, emit_full, relus, concat, packed, groups, shuffle)

        plus_module.fused_convs = recording
        try:
            forward_flows(models[label], x1, x2)
        finally:
            plus_module.fused_convs = real
        require(len(rec) == 9, f"one {label} EEMFlow+ forward made {len(rec)} SGU and decoder K3 calls, not 9")
    fused_model = models["fused"]
    decoders = iter(getattr(fused_model, f"decoder{l}") for l in (6, 5, 4, 3, 2))
    standard_mods = [fused_model.cdc_model.dense_estimator_mask if c[0].shape[1] == 64 else next(decoders)
                     for c in calls["fused"]]
    labels = []
    flops = nbytes = 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    with torch.inference_mode():
        for i, ((x, ws, bs, pool, dtype, emit_full, relus, concat, packed, groups, shuffle), mod) in enumerate(
                zip(calls["fused"], standard_mods)):
            B_, _, h, w = x.shape
            chain = chain_channels(x.shape[1], ws, concat or (False,) * len(ws), groups)
            labels.append(f"{'SGU' if x.shape[1] == 64 else 'decoder'} {h}x{w}")
            convs = [m for m in mod.modules() if isinstance(m, torch.nn.Conv2d)]
            require(len(convs) == len(ws) and all(c.stride == (1, 1) for c in convs),
                    f"the standard module of the K3 chain {chain} has other convs than the chain")
            flops += sum(2 * B_ * h * w * c.weight.numel() for c in convs)
            nbytes += 4 * (x.numel() + sum(c.weight.numel() + c.bias.numel() for c in convs) + B_ * chain[-1] * h * w)
            for mode in ("fused", "fused bf16"):
                c = calls[mode][i]
                got, _ = real(*c)
                ref, _ = k3.plain(*c[:8], c[9], c[10])
                err, scale = rel_err(got, ref)
                key = str(c[4]).split(".")[1]
                worst[key] = max(worst[key], err)
                require(err <= K3_TOL[key] * scale,
                        f"K3 on EEMFlow+'s forward input {list(x.shape)} ({key}) disagrees with its plain version")

        def run(mode):
            return lambda: [real(*c) for c in calls[mode]]

        def plain():
            return [k3.plain(*c[:8], c[9], c[10]) for c in calls["fused"]]

        def standard():
            return [m(c[0]) for m, c in zip(standard_mods, calls["fused"])]

        dev = cold_queued_ms(run("fused"), 5, device)
        warm = queued_ms(run("fused"), reps=5)
        wrapper = cuda_ms(run("fused"), reps=5)
        dev16 = cold_queued_ms(run("fused bf16"), 5, device)
        wrapper16 = cuda_ms(run("fused bf16"), reps=5)
        plain_ms = cuda_ms(plain, reps=5)
        std_ms = cold_queued_ms(standard, 2, device)
        per_chain = {mode: [cold_queued_ms(lambda c=c: real(*c), 5, device) for c in calls[mode]]
                     for mode in calls}
    bound, by = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)
    bound16, by16 = bound_ms(nbytes, flops, PEAK_BF16_FLOP_PER_S)
    simt_ms = flops / PEAK_FP32_FLOP_PER_S * 1e3
    n_launches = {mode: sum(len(c[8].launches) for c in calls[mode]) for mode in calls}
    for mode in calls:
        for lab, c, t in zip(labels, calls[mode], per_chain[mode]):
            plan = ", ".join(f"convs {L.lo + 1}-{L.hi} tile {L.plan['tile'][0]}x{L.plan['tile'][1]} ring "
                             f"{L.plan['ring']} ({L.plan['ring_uses']} uses) {L.plan['smem_bytes']} B"
                             for L in c[8].launches)
            say(f"K3 plan EEMFlow+ {lab} {mode}: {len(c[8].launches)} launches [{plan}]: {t:.4f} ms on the "
                f"device after an L2 flush")
    say(f"K3 on EEMFlow+'s 9 chains of one 720x1280 B=1 fused forward (SGU levels 5..2, decoders 6..2; "
        f"{n_launches['fused']} launches): {dev:.4f} ms on the device after an L2 flush ({warm:.4f} warm, queued; "
        f"{flops / dev / 1e9:.1f} TFLOP/s of the function), {wrapper:.4f} ms of wrapper calls back to back; bound "
        f"{bound:.4f} ms ({by}: 3 TF32 products of the split for {flops} FLOP of the function, the grouped convs "
        f"as grouped, at the TF32 peak; {nbytes} B); float32 SIMT figure {simt_ms:.4f} ms; bf16 operands "
        f"({n_launches['fused bf16']} launches) {dev16:.4f} ms after an L2 flush, {wrapper16:.4f} ms of wrapper "
        f"calls (bound {bound16:.4f} ms, {by16}); plain versions {plain_ms:.4f} ms; standard modules (cuDNN "
        f"convs, the decoders' grouped convs as grouped) {std_ms:.4f} ms on the device after an L2 flush; "
        f"max|Δ| to the plain version on these inputs float32 {worst['float32']:.3e}, bf16 "
        f"{worst['bfloat16']:.3e}")
    for line in ptxas_lines("fused_convs_tc"):
        say(f"K3 {line}")
    chains = (("SGU", [64, 96, 128, 160, 176, 184, 3], None, {"concat": _SGU[1]}),
              ("decoder", [87, 96, 96, 96, 96, 64, 32, 2], None, {"groups": _G, "shuffle": _G}))
    for inst in k3.kernel_info(chains, device):
        say(f"K3 instance for the {inst['chain']} {inst['mode']} convs {inst['convs'][0] + 1}-{inst['convs'][1]} "
            f"(NT={inst['nt']}): {inst['threads']} threads, {inst['registers']} registers, {inst['local_bytes']} B "
            f"local (spills), {inst['ctas_per_sm']} CTA(s) an SM at its {inst['smem_bytes']} B of shared memory; "
            f"tile {inst['tile'][0]}x{inst['tile'][1]}, ring of {inst['ring']} stages of {inst['stage_bytes']} B, "
            f"passes {inst['passes']}")
    times_plus_cuts(device, calls)
    times_k3_launch_plans(device)
    errs["fused_convs_pool_plus_chains"] = max(errs["fused_convs_pool_plus_chains"], worst["float32"])

    ref = None
    for label, kw in PLUS_FAST_CANDIDATES:
        m = get_eval_model("eemflow_plus", **kw)
        load_model_checkpoint(m, PLUS_CKPT, "eemflow_plus")
        m.to(device)
        flow = forward_flows(m, x1, x2)
        if ref is None:
            ref = flow
        err = float((flow - ref).abs().max())
        epe = float(torch.linalg.vector_norm(flow - ref, dim=-1).mean())
        # back to back only: queuing EEMFlow+'s forward (~1,500 device ops)
        # behind a sleep failed on the card, the host falling behind
        b2b = cuda_ms(lambda: forward_flows(m, x1, x2), reps=10, warmup=2)
        say(f"--fast candidate EEMFlow+ {label} {kw}: forward 720x1280 B=1 {b2b:.3f} ms back to back "
            f"({1e3 / b2b:.1f} fps); vs standard max|Δ| {err:.3e}, mean end-point distance {epe:.3e} px "
            f"(parity-safe: {epe <= FAST_EPE_TOL and err <= FORWARD_TOL})")
    say(f"--fast maps eemflow_plus to {fast_eval_kwargs('eemflow_plus')} (models/registry.FAST_EVAL_KWARGS)")
    for label in ("standard", "fused"):
        run_fwd = lambda m=models[label]: forward_flows(m, x1, x2)
        flow = run_fwd()
        require(tuple(flow.shape) == (1, H, W, 2) and bool(torch.isfinite(flow).all()),
                f"EEMFlow+ 720x1280 {label} forward is not finite or has the wrong shape")
        b2b = cuda_ms(run_fwd, reps=10, warmup=2)
        prof = profiled_step(run_fwd, reps=5, tmp=tmp)
        say(f"EEMFlow+ forward 720x1280 B=1, {label}: {b2b:.3f} ms back to back ({1e3 / b2b:.1f} fps); profiled "
            f"{prof['profiled_ms']:.3f} ms a forward, the device busy {prof['busy_ms']:.3f} ms of it "
            f"({100 * prof['busy_share']:.1f}%, {prof['device_ops']:.0f} kernels and copies)")
    return {
        "name": "fused_convs_pool_plus_chains", "route": "cuda",
        "source": "eemflow_tpu_torch/kernels/csrc/fused_convs_tc.cu",
        "replaces": "eemflow_tpu/ops/pallas/fused_convs.py:176",
        "launches": launches["fused_convs_pool_plus_chains"], "max_abs_err": errs["fused_convs_pool_plus_chains"],
        "bf16_max_abs_err": worst["bfloat16"], "ms": dev, "warm_ms": warm, "wrapper_ms": wrapper,
        "bf16_ms": dev16, "bf16_wrapper_ms": wrapper16, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "bf16_bound_ms": bound16, "simt_bound_ms": simt_ms, "library_ms": None, "standard_ms": std_ms,
    }


def times_plus_cuts(device, calls: dict) -> None:
    """The level-2 SGU and decoder chains (720x1280) at the cut their plan
    takes (one conv a launch: neither fits one launch) and at the fewest
    launches that fit (SGU convs 1-3 | 4-6, decoder 1-3 | 4-7), on the
    device after an L2 flush, float32 and bf16, each launch at the tile
    and split the wrapper picks for the grid: what
    ``kernels/fused_convs.py`` ``plan_chain`` chose between."""
    import torch.nn.functional as F

    from eemflow_tpu_torch.kernels import fused_convs as k3

    for mode, rec in calls.items():
        for c in (rec[7], rec[8]):  # level 2: the SGU, then the decoder
            x, ws, bs, pool, dtype, emit_full, relus, concat, packed, groups, shuffle = c
            spec, bf16 = packed.spec, packed.bf16
            n = len(ws)
            cuts = {"plan": [(L.lo, L.hi) for L in packed.launches], "fewest launches": [(0, 3), (3, n)]}
            for label, parts in cuts.items():
                launches = []
                for lo, hi in parts:
                    plan = k3._plan_launch(spec.part(lo, hi, spec.channels()[lo]), None, bf16)
                    pw = [k3.pack_conv(ws[j], plan, j - lo, bf16) for j in range(lo, hi)]
                    pb = [F.pad(bs[j].float(), (0, plan["convs"][j - lo]["n8"] * 8 - bs[j].shape[0])).contiguous()
                          for j in range(lo, hi)]
                    tiles = tuple((p, k3._static_args(p, pw, pb, relus[lo:hi]))
                                  for p in k3._tile_plans(plan["spec"], None, bf16))
                    launches.append(k3.Launch(lo, hi, plan, pw, pb, tiles[0][1], tiles))
                cut = packed._replace(launches=launches)
                with torch.inference_mode():
                    t = cold_queued_ms(lambda: k3.fused_convs(x, ws, bs, pool, dtype, emit_full, relus, concat, cut,
                                                              groups, shuffle), 5, device)
                say(f"K3 cut of the {'SGU' if n == 6 else 'decoder'} 192x320 {mode} ({label}): convs "
                    f"{[(lo + 1, hi) for lo, hi in parts]}: {t:.4f} ms on the device after an L2 flush")


def times_k3_launch_plans(device) -> None:
    """One launch of K3 at every plan its wrapper chooses among (tile, and
    the split of a one-conv launch's outputs over CTAs), warm, queued, at
    EEMFlow+'s level 6 (12x20) and level 2 (192x320): a dense conv (the
    decoders' first, 87 -> 96), a grouped one (96 -> 96, 3 groups) and a
    concat one (the SGU's third, 128 -> 32 and its 128-channel carry), in
    float32 and bf16, beside the wrapper's prediction (``pick_tile``:
    waves x ``cta_us``, whose constants are fitted to these lines) and its
    pick."""
    from eemflow_tpu_torch.kernels import fused_convs as k3

    rng = np.random.default_rng(17)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for label, cin, f, g, concat in (("dense 87->96", 87, 96, 1, False), ("grouped 96->96", 96, 96, 3, False),
                                     ("concat 128->32", 128, 32, 1, True)):
        w, b = conv_params(rng, (cin // g,), (f,), device)
        for bf16 in (False, True):
            launch = k3.pack_chain(w, b, bf16, device, None, (concat,), (g,), (g,), (True,)).launches[0]
            plans = [p for p, _ in launch.tiles]
            for h, wd in ((12, 20), (192, 320)):
                x = torch.randn(1, h, wd, cin, device=device).permute(0, 3, 1, 2)
                out = torch.empty(1, f + (cin if concat else 0), h, wd, device=device)
                tiles_of = lambda t: -(-h // t[0]) * -(-wd // t[1])
                pick = k3.pick_tile(plans, tiles_of, sms)
                row = []
                for i, (plan, args) in enumerate(launch.tiles):
                    one = launch._replace(args=args, tiles=((plan, args),))
                    with torch.inference_mode():
                        t = queued_ms(lambda: k3._launch(x, out, None, one), 50)
                    pred = -(-tiles_of(plan["tile"]) * plan["nsplit"] // sms) * k3.cta_us(plan)
                    row.append(f"{plan['tile'][0]}x{plan['tile'][1]} split {plan['nsplit']} ({plan['ring_uses']} "
                               f"uses): {t * 1e3:.1f} us (predicted {pred:.1f}){' *' if i == pick else ''}")
                say(f"K3 launch by plan, {label} {'bf16' if bf16 else 'float32'} at {h}x{wd} (* the wrapper's "
                    f"pick): " + "; ".join(row))


# serving modes timed in phase 4, at B=1 and B=2
SERVE_TIMED = (
    ("pair", []), ("stream", ["--stream"]), ("stream chunk 2", ["--stream", "--chunk", "2"]),
    ("host_voxelize", ["--host_voxelize"]), ("host_voxelize stream", ["--host_voxelize", "--stream"]),
    ("bf16", ["--bf16"]), ("fast", ["--fast"]), ("fast stream", ["--fast", "--stream"]),
)
SERVE_LOOPS = 2  # passes over the 8 frames a timed serve run (two keep the whole run's clock)


def times_serve(device, tmp: str) -> None:
    """The serving CLI on phase 3's serving stream (8 samples, ``--loops
    2``, one warm-up batch untimed) at B=1 and B=2 in each mode: wall fps,
    host decode and dispatch ms a frame (the CLI's report), and the
    device's busy share of the timed window from a second run under
    ``--profile``."""
    from eemflow_tpu_torch.tools.serve import main as serve

    root = os.path.join(tmp, "serve")
    runs = {}
    for rnd in ("timed", "profiled"):
        for batch in (1, 2):
            for label, extra in SERVE_TIMED:
                prof = ["--profile", os.path.join(tmp, "serve_trace")] if rnd == "profiled" else []
                res = serve(["--checkpoint", GOLDEN_CKPT, "--data_root", root, "--size", str(H), str(W),
                             "--loops", str(SERVE_LOOPS), "--warmup", "1", "--batch", str(batch),
                             "--device", str(device), *prof, *extra])
                require(res["frames"] > 0 and (rnd != "profiled" or res["busy_share"] is not None),
                        f"serve {label} B={batch} was not timed")
                runs.setdefault((batch, label), {})[rnd] = res
    for (batch, label), r in runs.items():
        a, p = r["timed"], r["profiled"]
        say(f"serve timing B={batch} {label}: {a['fps']:.1f} fps wall ({a['frames']} frames), host decode "
            f"{a['host_ms']:.3f} ms/frame, dispatch {a['dispatch_ms']:.3f} ms/frame; under --profile {p['fps']:.1f} "
            f"fps, the device busy {100 * p['busy_share']:.1f}% of the timed window")


def times_k1(device, errs: dict, launches: dict) -> dict:
    """K1 at 720x1280, B=2, with 2·10^5 events a frame and with 30,000 (the
    synthetic HREM fixture's count): ``voxel_scatter`` and ``voxelize`` on
    the device (queued) and per wrapper call back to back, against
    ``index_put_(accumulate=True)`` on the same votes (then
    ``normalize_voxel_grid`` for voxelize), the plain versions, and the
    bytes bound: each valid event read once, the grid written once."""
    from eemflow_tpu_torch.events.voxel import normalize_voxel_grid, voxel_votes, voxelize_plain
    from eemflow_tpu_torch.kernels import voxel_scatter as k1

    rng = np.random.default_rng(2)
    row = {
        "name": "voxel_scatter", "route": "cuda",
        "source": "eemflow_tpu_torch/kernels/csrc/voxel_scatter.cu",
        "replaces": "eemflow_tpu/ops/pallas/voxel_scatter.py:101",
        "launches": launches["voxel_scatter"], "max_abs_err": errs["voxel_scatter"],
        "voxelize_max_abs_err": errs["voxelize"], "standard_ms": None,
        "launches_per_train_step": launches["voxel_scatter_per_train_step"],
    }
    for n_events, tag in ((200_000, ""), (30_000, "_30k")):
        ev, nv = k1_batch(rng, (n_events, n_events))
        e = torch.from_numpy(ev).to(device)
        n = torch.from_numpy(nv).to(device)
        idx, val = voxel_votes(e, n, BINS, H, W)
        nbytes = int(nv.sum()) * 16 + len(nv) * BINS * H * W * 4
        bound, by = bound_ms(nbytes, 2 * idx.numel())

        def library():
            g = torch.zeros(len(nv) * BINS * H * W, device=device)
            g.index_put_((idx,), val, accumulate=True)
            return g.view(len(nv), BINS, H, W)

        t = {}
        for what, fn in (
            ("scatter", lambda: k1.voxel_scatter(e, n, BINS, H, W)),
            ("voxelize", lambda: k1.voxelize(e, n, BINS, H, W)),
        ):
            t[what] = (queued_ms(fn, reps=20), cuda_ms(fn))
        t["library"] = cuda_ms(library)
        t["library voxelize"] = cuda_ms(lambda: normalize_voxel_grid(library()))
        plain = (cuda_ms(lambda: k1.plain(e, n, BINS, H, W), reps=5),
                 cuda_ms(lambda: voxelize_plain(e, n, BINS, H, W), reps=5))
        say(f"K1 B=2 N=2^18 n_valid={n_events} {H}x{W}, bound {bound:.5f} ms ({by}: {nbytes} B, each valid event "
            f"read once and the grid written once; {idx.numel()} votes), device (queued) / wrapper back to back: "
            f"voxel_scatter {t['scatter'][0]:.4f} / {t['scatter'][1]:.4f} ms; voxelize {t['voxelize'][0]:.4f} / "
            f"{t['voxelize'][1]:.4f} ms; index_put_(accumulate=True) "
            f"{t['library']:.4f} ms, with normalize_voxel_grid {t['library voxelize']:.4f} (back to back); "
            f"plain versions {plain[0]:.4f} / {plain[1]:.4f} ms")
        row.update({
            f"ms{tag}": t["scatter"][0], f"wrapper_ms{tag}": t["scatter"][1], f"plain_ms{tag}": plain[0],
            f"bound_ms{tag}": bound, f"library_ms{tag}": t["library"],
            f"voxelize_ms{tag}": t["voxelize"][0], f"voxelize_wrapper_ms{tag}": t["voxelize"][1],
            f"voxelize_plain_ms{tag}": plain[1], f"voxelize_library_ms{tag}": t["library voxelize"],
        })
        if not tag:
            row["bound_by"] = by
    return row


def device_kernels(fn, complete=lambda kernels: len(kernels) > 0) -> list:
    """(name, device ms) of each kernel, copy and fill of one call of
    ``fn``, in launch order, from torch.profiler's exported trace.  CUPTI
    has delivered traces with records missing on an H100 machine (an empty
    trace; a K5 pair one conv short), so a trace that ``complete`` rejects
    is taken again, at most twice, and a line says so.  A function that
    launches other kernels than expected fails all three."""
    from eemflow_tpu_torch.tools.profile_model import DEVICE_CATEGORIES

    fn()
    torch.cuda.synchronize()
    kernels = []
    for attempt in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        fd, trace = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(trace)
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(trace)
        kernels = [(e["name"], float(e["dur"]) / 1e3) for e in
                   sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES),
                          key=lambda e: float(e["ts"]))]
        if complete(kernels):
            break
        say(f"torch.profiler trace {attempt + 1} of this call holds {len(kernels)} kernels, not the call's; "
            f"profiling it again")
    return kernels


def top_kernels(fn, n: int = 6) -> tuple:
    """(the summed device time of one call of ``fn``, a line of its first
    ``n`` kernels by summed device time with their launches), from
    torch.profiler.  cuDNN can run kernels of one call side by side, so the
    sum can exceed the busy union of ``profiled_step``."""
    by_name = {}
    for k, ms in device_kernels(fn):
        t, c = by_name.get(k, (0.0, 0))
        by_name[k] = (t + ms, c + 1)
    total = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return total, f"(of {total:.3f} ms summed) " + "; ".join(
        f"{k[:90]} {t:.3f} ms ({c} launches)" for k, (t, c) in top)


def kernel_counts(fn, name: str):
    """(launches of kernels whose name holds ``name``, other kernels) in
    one call of ``fn`` (torch.profiler)."""
    names = [k for k, _ in device_kernels(fn)]
    return sum(name in k for k in names), sum(name not in k for k in names)


def k2_work(pooled, K: int, elem_bytes: int):
    """(bytes, operations) one K2 call over these pooled NCHW levels must
    move and do: both inputs read once, the displacement table, the output
    written once; 2 per multiply-add."""
    nbytes = flops = 0
    for a in pooled:
        b, c, h, w = a.shape
        nbytes += 2 * b * h * w * c * elem_bytes + K * 4 + b * h * w * K * elem_bytes
        flops += 2 * b * h * w * K * c
    return nbytes, flops


def times_k2(device, model, errs: dict, launches: dict) -> dict:
    """K2 in the 720x1280 standard forward: the three levels' correlation
    step (``EEMFlow._corrs`` on the forward's pooled features) at B=1 in
    float32 on the device and per call back to back, its launches and the
    other kernels it runs (copies), the plain version and the bytes bound;
    then in bf16 (the training forward's mixed precision) at B=1 and B=6,
    beside their bounds."""
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import local_corr as k2

    p1, p2 = forward_pooled(model, 1, device, seed=20)
    K = len(model.corr_indices)
    nbytes, flops = k2_work(p1, K, 4)
    bound, by = bound_ms(nbytes, flops)
    with torch.inference_mode():
        new = lambda: model._corrs(p1, p2)
        plain = lambda: [k2.plain(a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1), model.max_displacement,
                                  model.corr_indices) for a, b in zip(p1, p2)]
        before = launch_counts["local_corr"]
        new()
        per_forward = launch_counts["local_corr"] - before
        require(per_forward == 1, f"the standard forward's correlation step took {per_forward} K2 launches")
        n_new, other_new = kernel_counts(new, "local_corr")
        t_new = (queued_ms(new, reps=50), cuda_ms(new, reps=50))
        t_plain = cuda_ms(plain, reps=10)
        bf16 = {}
        for batch in (1, 6):
            q1, q2 = forward_pooled(model, batch, device, seed=21 + batch)
            q1, q2 = ([t.to(torch.bfloat16) for t in q] for q in (q1, q2))
            step = lambda: model._corrs(q1, q2)
            b_bytes, b_flops = k2_work(q1, K, 2)
            bf16[batch] = (queued_ms(step, reps=50), cuda_ms(step, reps=50), bound_ms(b_bytes, b_flops),
                           b_bytes, b_flops)
    require(n_new == 1 and other_new == 0, f"K2's step ran {n_new} K2 kernels and {other_new} others")
    say(f"K2 local_corr_levels, the three 12x20 levels of a 720x1280 B=1 forward (C=16/32/64, K={K}), float32: "
        f"{n_new} launch and {other_new} other kernels per forward; {t_new[0]:.4f} ms on the device (queued), "
        f"{t_new[1]:.4f} ms per call back to back; bound {bound:.6f} ms ({by}: {nbytes} B, {flops} FLOP); plain "
        f"version {t_plain:.4f} ms; no single PyTorch call computes it")
    for batch, (dev, wrap, (b_ms, b_by), b_bytes, b_flops) in bf16.items():
        say(f"K2 local_corr_levels bf16 (the training forward's mixed precision), the three 12x20 levels of a "
            f"720x1280 B={batch} forward: {dev:.4f} ms on the device (queued), {wrap:.4f} ms per call back to back; "
            f"bound {b_ms:.6f} ms ({b_by}: {b_bytes} B, {b_flops} FLOP)")
    return {
        "name": "local_corr", "route": "cuda",
        "source": "eemflow_tpu_torch/kernels/csrc/local_corr.cu",
        "replaces": "eemflow_tpu/ops/pallas/local_corr.py:104",
        "launches": launches["local_corr"], "max_abs_err": errs["local_corr"],
        "ms": t_new[0], "wrapper_ms": t_new[1], "plain_ms": t_plain,
        "bound_ms": bound, "bound_by": by, "library_ms": None, "standard_ms": None,
        "launches_per_forward": n_new, "copy_kernels": other_new,
        "launches_per_train_step": launches["local_corr_per_train_step"],
        "bf16_max_abs_err": errs["local_corr_bf16"],
        "bf16_ms": bf16[1][0], "bf16_wrapper_ms": bf16[1][1], "bf16_bound_ms": bf16[1][2][0],
        "bf16_ms_b6": bf16[6][0], "bf16_bound_ms_b6": bf16[6][2][0],
    }


def times_forwards(device, model, sd, x1, x2) -> None:
    """One 720x1280 B=1 EEMFlow forward, standard and fused, back to back
    and on the device."""
    from eemflow_tpu_torch.models.registry import get_eval_model

    flows = {}
    fused = get_eval_model("eemflow", fast_head=True, fast_pyramid=True)
    fused.load_state_dict(sd)
    fused.to(device)

    def forward(m):
        with torch.inference_mode():
            return m(x1, x2)[1][-1]

    def timed(label, m):
        flows[label] = flow = forward(m)
        require(tuple(flow.shape) == (1, H, W, 2) and bool(torch.isfinite(flow).all()),
                f"720x1280 {label} forward is not finite or has the wrong shape")
        b2b, dev = cuda_ms(lambda: forward(m), reps=20), queued_ms(lambda: forward(m), reps=2)
        say(f"EEMFlow forward 720x1280 B=1, {label} (host-voxelized input on the card): "
            f"{b2b:.3f} ms per call back to back ({1e3 / b2b:.1f} fps), {dev:.3f} ms on the device (queued)")

    timed("standard", model)
    timed("fused (--fast_head --fast_pyramid)", fused)
    err = float((flows["standard"] - flows["fused (--fast_head --fast_pyramid)"]).abs().max())
    say(f"720x1280 fused vs standard forward: max|Δ| {err:.3e} (tolerance {FORWARD_TOL:g})")
    require(err <= FORWARD_TOL, "the 720x1280 fused forward disagrees with the standard one")


def times_sample(device, model, tmp: str) -> None:
    """The whole device-voxelize eval sample (packed events from the host →
    K1 voxelize ×2 → forward with one K2 launch → flow on the host), back
    to back."""
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.data.hrem import HREMEventFlow
    from eemflow_tpu_torch.eval.runner import Tester

    ds = HREMEventFlow(os.path.join(tmp, "hrem"), raw_events=True)
    ds.change_test_sequence("indoor_fast")
    sample = ds[0]
    tester = Tester(model, device, preprocess=make_device_preprocess(BINS, H, W))
    for _ in range(3):
        tester.run_sample(sample)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        tester.run_sample(sample)
    ms = (time.perf_counter() - t0) / reps * 1e3
    say(f"whole eval sample, device voxelize (packed events from the host → K1 voxelize ×2 → forward, one K2 "
        f"launch → flow on the host): {ms:.3f} ms ({1e3 / ms:.1f} fps)")


def times_k5(device, errs: dict, launches: dict) -> dict:
    """One K5 pair (the two entry points of one iteration) at ERAFT's
    720x1280 and 512x960 grids, float32 and bf16: device time (queued),
    wrapper calls back to back, the plain version, the bound, and the
    standard path for the same work (``BasicUpdateBlock`` without its mask
    head: cuDNN convs, TF32 off, and the concatenations).  The float32
    bound counts the three TF32 products of the split at the TF32 peak (the
    least that keeps float32 accuracy on the tensor cores); the float32
    SIMT figure, the bound before tensor cores, is printed beside it."""
    from eemflow_tpu_torch.kernels import update_block as k5
    from eemflow_tpu_torch.ops.update_block import gru_flowhead_plain, make_fused_update, motion_encoder_plain
    from eemflow_tpu_torch.tools.update_block_bound import update_block_work

    for info in k5.kernel_info():
        say(f"K5 conv_tc {info['tile']} {info['mode']}: {info['BM']}x{info['BN']} tile, {info['threads']} "
            f"threads, {info['stages']} stages, {info['smem_bytes']} B of dynamic shared memory, "
            f"{info['registers']} registers, {info['local_bytes']} B local (spills), "
            f"{info['ctas_per_sm']} CTA(s) an SM")
    for line in ptxas_lines("conv_tc"):
        say(f"K5 {line}")
    rng = np.random.default_rng(5)
    block = k5_block(rng, device)
    row = None
    with torch.inference_mode():
        for h, w in K5_GRIDS[:2]:
            net, inp, corr, flow = k5_inputs(rng, h, w, device)
            nchw = [t.permute(0, 3, 1, 2).contiguous() for t in (net, inp, corr, flow)]
            std = cold_queued_ms(lambda: block(*nchw, compute_mask=False), 5, device)
            std_warm = queued_ms(lambda: block(*nchw, compute_mask=False), reps=5)
            flops, nbytes = update_block_work(h, w, 1)
            simt_ms = flops / PEAK_FP32_FLOP_PER_S * 1e3
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            modes = ((torch.float32, 3 * flops, PEAK_TF32_FLOP_PER_S, "3 TF32 products of the split at the TF32 peak"),
                     (torch.bfloat16, flops, PEAK_BF16_FLOP_PER_S, "bf16 at the tensor-core peak"))
            for dtype, ops, rate, what in modes:
                fused = make_fused_update(block, dtype)

                def pair():
                    return k5.update_gru(net, inp, k5.update_motion(corr, flow, fused), fused)

                def plain():
                    motion = motion_encoder_plain(corr, flow, fused.motion, dtype)
                    return gru_flowhead_plain(net, inp, motion, fused.gru, dtype)

                dev = cold_queued_ms(pair, 5, device)
                warm = queued_ms(pair, reps=5)
                wrapper = cuda_ms(pair, reps=5)
                plain_ms = cuda_ms(plain, reps=5)
                b_ms, b_by = bound_ms(nbytes, ops, rate)
                kind = str(dtype)[6:]
                say(f"K5 update_block pair B=1 {h}x{w} {kind}: {dev:.4f} ms on the device after an L2 "
                    f"flush ({warm:.4f} warm, queued), {wrapper:.4f} ms per wrapper pair back to back "
                    f"({flops / dev / 1e9:.1f} TFLOP/s of the function, {ops / dev / 1e9:.1f} TFLOP/s of "
                    f"tensor-core products, {100 * b_ms / dev:.1f}% of the bound); bound {b_ms:.4f} ms "
                    f"({b_by}: {what}, {ops} FLOP; bytes {bytes_ms:.4f} ms for {nbytes} B); float32 SIMT "
                    f"figure (67 TFLOP/s, the bound before tensor cores) {simt_ms:.4f} ms; plain version "
                    f"{plain_ms:.4f} ms; standard path (BasicUpdateBlock without the mask, cuDNN float32) "
                    f"{std:.4f} ms on the device after an L2 flush ({std_warm:.4f} warm)")
                if (h, w) == K5_GRIDS[0]:
                    k5_conv_times(pair, h * w, f"B=1 {h}x{w} {kind}")
                if (h, w) == K5_GRIDS[0] and dtype == torch.float32:
                    row = {
                        "name": "update_block", "route": "cuda",
                        "source": "eemflow_tpu_torch/kernels/csrc/update_block.cu",
                        "replaces": "eemflow_tpu/ops/pallas/update_block.py:236",
                        "launches": launches["update_block"], "max_abs_err": errs["update_block"],
                        "ms": dev, "warm_ms": warm, "wrapper_ms": wrapper, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "standard_ms": std,
                    }
                elif (h, w) == K5_GRIDS[0]:
                    row["bf16_ms"], row["bf16_bound_ms"] = dev, b_ms
    return row


def k5_conv_times(pair, pixels: int, kind: str) -> None:
    """Device time of each conv launch of one K5 pair (torch.profiler) and
    the rate of the function it computes."""
    from eemflow_tpu_torch.tools.update_block_bound import update_block_convs

    convs = update_block_convs()
    times = [ms for name, ms in device_kernels(pair, lambda ks: sum("conv_tc" in k for k, _ in ks) == len(convs))
             if "conv_tc" in name]
    require(len(times) == len(convs), f"K5 pair launched {len(times)} convs, not {len(convs)}")
    parts = [f"{name} {ms:.4f} ({2 * k * cin * cout * pixels / ms / 1e9:.1f})"
             for (name, k, cin, cout), ms in zip(convs, times)]
    say(f"K5 pair {kind} by conv (torch.profiler: device ms, TFLOP/s of the function), sum "
        f"{sum(times):.4f} ms: {'; '.join(parts)}")


def times_eraft(device) -> None:
    """The ERAFT eval forward (golden weights, 12 iterations, the mask head
    once) at 720x1280 and 512x960, B=1: module path against K5, and at
    720x1280 the per-level lookup against the stacked one in turns
    (per-level, stacked, stacked, per-level); then RAFT's 720x1280 forward
    (seeded weights, 5 channels)."""
    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.models.registry import get_eval_model

    sd = to_state_dict(load_torch_checkpoint(ERAFT_CKPT))
    models = {}
    for label, kw in (("module path", {}), ("fused_update", {"fused_update": True}),
                      ("fused_update bf16", {"fused_update": True, "fused_dtype": "bf16"}),
                      ("stacked lookup", {"stacked_lookup": True}),
                      ("fused_update, stacked lookup", {"fused_update": True, "stacked_lookup": True})):
        models[label] = get_eval_model("eraft", **kw)
        models[label].load_state_dict(sd)
        models[label].to(device)

    def forward(m, x1, x2):
        with torch.inference_mode():
            return m(x1, x2)[1][-1]

    for h, w in ((720, 1280), (512, 960)):
        x1, x2 = (torch.randn(1, h, w, BINS, device=device) for _ in range(2))
        flows = {}
        for label, m in models.items():
            if "stacked" in label and h != 720:
                continue
            flows[label] = flow = forward(m, x1, x2)
            require(tuple(flow.shape) == (1, h, w, 2) and bool(torch.isfinite(flow).all()),
                    f"ERAFT {h}x{w} {label} forward is not finite or has the wrong shape")
            ms = cuda_ms(lambda m=m: forward(m, x1, x2), reps=5, warmup=2)
            say(f"ERAFT forward {h}x{w} B=1, {label}: {ms:.3f} ms per call back to back "
                f"({1e3 / ms:.1f} fps)")
        err = float((flows["fused_update"] - flows["module path"]).abs().max())
        say(f"ERAFT {h}x{w} fused_update vs module path forward: max|Δ| {err:.3e}")
        if h != 720:
            continue
        for base, stacked in (("module path", "stacked lookup"), ("fused_update", "fused_update, stacked lookup")):
            turns = [cuda_ms(lambda m=models[label]: forward(m, x1, x2), reps=5, warmup=1)
                     for label in (base, stacked, stacked, base)]
            err = float((flows[stacked] - flows[base]).abs().max())
            say(f"ERAFT forward 720x1280 B=1, {base}: per-level lookup {turns[0]:.3f} / {turns[3]:.3f} ms against "
                f"the stacked lookup {turns[1]:.3f} / {turns[2]:.3f} ms back to back, in turns; flows max|Δ| "
                f"{err:.3e}")
    x1, x2 = (torch.randn(1, 720, 1280, BINS, device=device) for _ in range(2))
    del models
    torch.cuda.empty_cache()
    torch.manual_seed(0)
    raft = get_eval_model("raft", n_first_channels=BINS).to(device)
    flow = forward(raft, 255 * x1.sigmoid(), 255 * x2.sigmoid())
    require(tuple(flow.shape) == (1, 720, 1280, 2) and bool(torch.isfinite(flow).all()),
            "RAFT's 720x1280 forward is not finite or has the wrong shape")
    ms = cuda_ms(lambda: forward(raft, 255 * x1.sigmoid(), 255 * x2.sigmoid()), reps=5, warmup=2)
    say(f"RAFT forward 720x1280 B=1 (seeded weights, 5 channels, 12 iterations): {ms:.3f} ms per call back to back "
        f"({1e3 / ms:.1f} fps)")


def times_k3_k4(device, model, x1, x2, errs: dict, launches: dict):
    """K3 per pyramid level and over the six calls of one 720x1280 B=1
    forward, and K4 on the forward's pooled grids: device time (queued),
    wrapper calls back to back, the twin, the bound, and the standard path
    for the same work (cuDNN convs + LeakyReLU + ``F.avg_pool2d`` of the
    level; the standard coarse stage: K2, rconvs, decoders, ``out_conv``)."""
    from eemflow_tpu_torch.kernels import coarse_head as k4
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels.fused_convs import pack_chain
    from eemflow_tpu_torch.models.eemflow import LEVEL_CHAINS, POOLS
    from eemflow_tpu_torch.ops.pad import InputPadder
    import torch.nn.functional as F

    with torch.inference_mode():
        padder = InputPadder((H, W), mode="chairs", eval_pad_rate=model.pad_rate)
        evs = padder.pad_nchw(x1.permute(0, 3, 1, 2).contiguous(), x2.permute(0, 3, 1, 2).contiguous())
        stems = (model.pconv1_1, model.pconv2_1, model.pconv3_1)
        # the stride-1 chain's input of each level, for each frame
        inputs = []
        for ev in evs:
            f, per = ev, []
            for lvl, names in enumerate(LEVEL_CHAINS):
                g = stems[lvl](f)
                per.append(g)
                for n in names:
                    g = getattr(model, n)(g)
                f = g
            inputs.append(per)
        chains = [
            ([getattr(model, n)[0].weight for n in names], [getattr(model, n)[0].bias for n in names])
            for names in LEVEL_CHAINS
        ]
        packs = [pack_chain(ws, bs, False, device, pool) for (ws, bs), pool in zip(chains, POOLS)]

        def fused(frame, lvl):
            return k3.fused_convs(inputs[frame][lvl], *chains[lvl], POOLS[lvl], torch.float32,
                                  lvl < 2, packed=packs[lvl])

        def plain(frame, lvl):
            return k3.plain(inputs[frame][lvl], *chains[lvl], POOLS[lvl], torch.float32, lvl < 2)

        def standard(frame, lvl):
            g = inputs[frame][lvl]
            for n in LEVEL_CHAINS[lvl]:
                g = getattr(model, n)(g)
            return F.avg_pool2d(g, POOLS[lvl])

        levels = [(f"level {lvl + 1}", [K3_LEVELS[lvl][0][0], *K3_LEVELS[lvl][1]], POOLS[lvl], {})
                  for lvl in range(3)]
        for inst, ((cin, h, w), _, _, _) in zip(k3.kernel_info(levels, device), K3_LEVELS * 2):
            th, tw = inst["tile"]
            say(f"K3 fused_convs_tc {inst['chain']} {inst['mode']} (NT={inst['nt']}): {inst['threads']} threads, "
                f"{inst['registers']} registers, {inst['local_bytes']} B local (spills), {inst['ctas_per_sm']} "
                f"CTA(s) an SM at the level's shared memory")
            say(f"K3 plan {inst['chain']} {inst['mode']}: tile {th}x{tw}, {-(-h // th) * -(-w // tw)} CTAs a frame, "
                f"ring of {inst['ring']} stages of {inst['stage_bytes']} B, {inst['smem_bytes']} B of shared "
                f"memory, passes {inst['passes']}")
        for line in ptxas_lines("fused_convs_tc"):
            say(f"K3 {line}")
        packs_bf16 = [pack_chain(ws, bs, True, device, pool) for (ws, bs), pool in zip(chains, POOLS)]

        def fused_bf16(frame, lvl):
            return k3.fused_convs(inputs[frame][lvl], *chains[lvl], POOLS[lvl], torch.bfloat16,
                                  lvl < 2, packed=packs_bf16[lvl])

        def pooled_only(frame, lvl):
            return k3.fused_convs(inputs[frame][lvl], *chains[lvl], POOLS[lvl], torch.float32,
                                  False, packed=packs[lvl])

        # the launches timed below, held against the twin on the forward's
        # own inputs: the error the kernels line reports is this plan's
        for dtype, run in ((torch.float32, fused), (torch.bfloat16, fused_bf16)):
            tol = K3_TOL[str(dtype).split(".")[1]]
            for frame in range(2):
                for lvl in range(3):
                    got = run(frame, lvl)
                    ref = k3.plain(inputs[frame][lvl], *chains[lvl], POOLS[lvl], dtype, lvl < 2)
                    for what, g, r in zip(("full", "pooled"), got, ref):
                        if g is None:
                            continue
                        err, scale = rel_err(g, r)
                        if dtype == torch.float32:
                            errs["fused_convs_pool"] = max(errs["fused_convs_pool"], err)
                        say(f"K3 on the forward's inputs, frame {frame + 1} level {lvl + 1} "
                            f"{str(dtype)[6:]}: {what} max|Δ| {err:.3e} (tolerance {tol:g}·{scale:.2f})")
                        require(err <= tol * scale,
                                f"K3 disagrees with its twin on the forward's level {lvl + 1} ({what}, {dtype})")

        flops_all = bytes_all = 0
        for lvl in range(3):
            (cin, h, w), widths, pool, emit_full = K3_LEVELS[lvl]
            require(tuple(inputs[0][lvl].shape) == (1, cin, h, w), "K3 level shape differs from the forward's")
            flops, nbytes = k3_flops_bytes(1, cin, h, w, widths, emit_full, pool)
            flops_all += 2 * flops
            bytes_all += 2 * nbytes
            b_ms, b_by = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)
            ops_ms = 3 * flops / PEAK_TF32_FLOP_PER_S * 1e3
            b16_ms, b16_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_PER_S)
            simt_ms = flops / PEAK_FP32_FLOP_PER_S * 1e3
            one = cold_queued_ms(lambda: fused(0, lvl), 20, device)
            one_warm = queued_ms(lambda: fused(0, lvl), reps=20)
            one_bf16 = cold_queued_ms(lambda: fused_bf16(0, lvl), 20, device)
            one_wrapper = cuda_ms(lambda: fused(0, lvl))
            one_plain = cuda_ms(lambda: plain(0, lvl))
            one_std = cold_queued_ms(lambda: standard(0, lvl), 10, device)
            if emit_full:
                # the store probe: the same launch writing the pooled output
                # alone; the difference is what the full output's direct
                # stores from the fragments cost
                full_bytes = 4 * widths[-1] * h * w
                one_pooled = cold_queued_ms(lambda: pooled_only(0, lvl), 20, device)
                extra = one - one_pooled
                say(f"K3 level {lvl + 1} store probe: {one_pooled:.4f} ms after an L2 flush writing the "
                    f"pooled output alone, so the full output's {full_bytes} B cost {extra:.4f} ms "
                    f"({full_bytes / max(extra, 1e-9) / 1e6:.0f} GB/s over that difference; writing them "
                    f"at the memory rate takes {full_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms)")
            say(f"K3 level {lvl + 1} [1,{cin},{h},{w}] convs {list(widths)} pool {pool}: {one:.4f} ms "
                f"on the device after an L2 flush ({one_warm:.4f} warm, queued; "
                f"{flops / one / 1e9:.1f} TFLOP/s of the function), {one_wrapper:.4f} ms per wrapper "
                f"call; bound {b_ms:.4f} ms, by {b_by} (3 TF32 products of the split at the TF32 peak "
                f"{ops_ms:.4f} ms for {flops} FLOP of the function; {nbytes} B at the memory rate); float32 "
                f"SIMT figure {simt_ms:.4f} ms; bf16 "
                f"operands {one_bf16:.4f} ms after an L2 flush (bound {b16_ms:.4f} ms, {b16_by}); twin "
                f"{one_plain:.4f} ms; standard path (cuDNN conv{'s' if len(widths) > 1 else ''} + "
                f"LeakyReLU + avg_pool2d) {one_std:.4f} ms on the device after an L2 flush")
        six = lambda fn: [fn(f, l) for f in range(2) for l in range(3)]
        k3_ms = cold_queued_ms(lambda: six(fused), 10, device)
        k3_warm = queued_ms(lambda: six(fused), reps=10)
        k3_bf16 = cold_queued_ms(lambda: six(fused_bf16), 10, device)
        k3_wrapper = cuda_ms(lambda: six(fused))
        k3_plain = cuda_ms(lambda: six(plain))
        k3_std = cold_queued_ms(lambda: six(standard), 5, device)
        k3_bound, k3_by = bound_ms(bytes_all, 3 * flops_all, PEAK_TF32_FLOP_PER_S)
        k3_b16, k3_b16_by = bound_ms(bytes_all, flops_all, PEAK_BF16_FLOP_PER_S)
        k3_simt = flops_all / PEAK_FP32_FLOP_PER_S * 1e3
        say(f"K3, the six calls of one forward (3 levels x 2 frames): {k3_ms:.4f} ms on the device "
            f"after an L2 flush ({k3_warm:.4f} warm, queued), {k3_wrapper:.4f} ms of wrapper calls; "
            f"bound {k3_bound:.4f} ms, by {k3_by} (3 TF32 products of the split at the TF32 peak for "
            f"{flops_all} FLOP of the function; {bytes_all} B); float32 SIMT figure {k3_simt:.4f} ms; "
            f"bf16 operands {k3_bf16:.4f} ms after an L2 flush (bound {k3_b16:.4f} ms, {k3_b16_by}); twin "
            f"{k3_plain:.4f} ms; standard path {k3_std:.4f} ms on the device after an L2 flush; no "
            f"single PyTorch call computes it")

        # K4 on the pooled grids of this forward
        pooled = [[standard(f, l) for l in range(3)] for f in range(2)]
        nhwc = lambda ps: [p.permute(0, 2, 3, 1) for p in ps]
        hw_weights = model._head_weights()
        from eemflow_tpu_torch.ops.coarse_head import coarse_head

        def head(impl="kernel"):
            return coarse_head(nhwc(pooled[0]), nhwc(pooled[1]), hw_weights, model.groups,
                               model.corr_indices, model.max_displacement, impl=impl)

        def standard_head():
            flows = [
                dec(torch.cat([cv, rconv(a)], dim=1))
                for cv, a, rconv, dec in zip(model._corrs(pooled[0], pooled[1]), pooled[0],
                                             (model.rconv_1, model.rconv_2, model.rconv_3),
                                             (model.decoder_1, model.decoder_2, model.decoder_3))
            ]
            return model.out_conv(torch.cat(flows, dim=1))

        ph, pw = pooled[0][0].shape[2:]
        k4_flops, k4_bytes = k4_flops_bytes(1, ph, pw, hw_weights.kernel(device), len(model.corr_indices))
        k4_bound, k4_by = bound_ms(k4_bytes, k4_flops)
        err = float((head() - standard_head().permute(0, 2, 3, 1)).abs().max())
        require(err <= FORWARD_TOL, "K4 on the forward's grids disagrees with the standard coarse stage")
        k4_ms = cold_queued_ms(head, 20, device)
        k4_warm = queued_ms(head, reps=20)
        k4_wrapper = cuda_ms(head)
        k4_plain = cuda_ms(lambda: head("plain"))
        k4_std = cold_queued_ms(standard_head, 5, device)
        k4_std_warm = queued_ms(standard_head, reps=5)
        k4_info = k4.kernel_info(device)
        say(f"K4 coarse_head B=1 {ph}x{pw} (groups {model.groups}), clusters of {k4_info['cluster_size']}: "
            f"{k4_ms:.4f} ms on the device after an L2 flush ({k4_warm:.4f} warm, queued), "
            f"{k4_wrapper:.4f} ms per wrapper call; bound {k4_bound:.6f} ms ({k4_by}: {k4_flops} FLOP, "
            f"{k4_bytes} B); twin {k4_plain:.4f} ms; standard coarse stage {k4_std:.4f} ms on the device "
            f"after an L2 flush ({k4_std_warm:.4f} warm; max|Δ| to it {err:.3e}); no single PyTorch call "
            f"computes it")
        say(f"K4 kernel: {k4_info['threads']} threads, {k4_info['registers']} registers, "
            f"{k4_info['local_bytes']} B local (spills); {k4_info['max_clusters_8']} clusters of 8 fit at "
            f"once at {k4_info['smem_8']} B a CTA, {k4_info['max_clusters_16']} of 16 at {k4_info['smem_16']} B")
        for R in (8, 16):
            if not k4_info[f"max_clusters_{R}"]:
                continue
            run = lambda: k4._launch(nhwc(pooled[0]), nhwc(pooled[1]), hw_weights,
                                      model.corr_indices, model.max_displacement, R)
            say(f"K4 clusters of {R} ({3 * R} CTAs at B=1): {cold_queued_ms(run, 20, device):.4f} ms on the "
                f"device after an L2 flush, {queued_ms(run, reps=20):.4f} warm (queued)")

    k3_row = {
        "name": "fused_convs_pool", "route": "cuda",
        "source": "eemflow_tpu_torch/kernels/csrc/fused_convs_tc.cu",
        "replaces": "eemflow_tpu/ops/pallas/fused_convs.py:176",
        "launches": launches["fused_convs_pool"], "max_abs_err": errs["fused_convs_pool"],
        "ms": k3_ms, "warm_ms": k3_warm, "wrapper_ms": k3_wrapper, "plain_ms": k3_plain,
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None, "standard_ms": k3_std,
        "bf16_ms": k3_bf16, "bf16_bound_ms": k3_b16,
    }
    k4_row = {
        "name": "coarse_head", "route": "cuda",
        "source": "eemflow_tpu_torch/kernels/csrc/coarse_head.cu",
        "replaces": "eemflow_tpu/ops/pallas/coarse_head.py:275",
        "launches": launches["coarse_head"], "max_abs_err": errs["coarse_head"],
        "ms": k4_ms, "warm_ms": k4_warm, "wrapper_ms": k4_wrapper, "plain_ms": k4_plain,
        "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None, "standard_ms": k4_std,
    }
    return k3_row, k4_row


# MVSEC (phase 3c): the synthetic sequences' frames (the eval CLIs' --frames
# range: two samples a run; six training samples, one B=6 batch), 30,000
# events a frame interval at MVSEC's timestamp magnitude (seconds since the
# epoch), the eval paths with the K1/K2/K3/K4 calls each makes on the two
# samples, the card's AEE against the CPU's, and the training runs
MVSEC_T0 = 1.5e9
MVSEC_EVAL_FRAMES = (3, 5)
MVSEC_TRAIN_FRAMES = (3, 9)
MVSEC_TRAIN_SEQUENCE = "outdoor_day2"
MVSEC_EVAL_CASES = (("dt1", "indoor_flying1", "dense"), ("dt1", "outdoor_day1", "sparse"),
                    ("dt4", "indoor_flying1", "dense"))
# (label, flags, K1 calls, K2 launches, K3 launches, K4 launches) on two samples
MVSEC_EVAL_PATHS = (
    ("host voxelize", [], 0, 2, 0, 0),
    ("device voxelize", ["--device_voxelize"], 4, 2, 0, 0),
    ("--fast", ["--fast"], 0, 0, 12, 2),
    ("device voxelize, eval_batch 2", ["--device_voxelize", "--eval_batch", "2"], 2, 1, 0, 0),
)
MVSEC_CPU_TOL = 1e-5
# (model, config, flags, K1 calls and K2 launches a step, learning rate of
# the loss check): ERAFT's own recipe on the host path (the augmentor's
# resize branch), EEMFlow on the device path (K1 over the whole frame, then
# the flips and the crop on the card)
MVSEC_TRAIN = (
    ("eraft", "mvsec_eraft.json", [], 0, 0, 1e-4),
    ("eemflow", "mvsec_event_flow_dense.json", ["--device_voxelize"], 2, 1, 1e-3),
)
MVSEC_TRAIN_STEPS = 4  # two epochs of two steps


def make_mvsec_fixture(base: str, seed: int = 55, n_events: int = 30000, sequences=None, t0: float = MVSEC_T0,
                       images: bool = False, name: str = "mvsec") -> str:
    """Synthetic MVSEC sequences at 260x346 written by the port's own HDF5
    writer: ``event/{i+1:06d}.h5`` tables (timestamps t0 + i·0.03 s) and
    ``flowgt_dt1``/``flowgt_dt4`` ``{i}.npy`` for frames first..last-1 of
    each ``(sequence, first, last)``; by default the two eval sequences (an
    indoor one, an outdoor one for ``is_car``) and the train sequence, with
    enough frames for dt4's trailing windows.  ``images`` draws a frame
    image after each event table (drawn, not written), as the JAX package's
    golden fixture does for the image-using families."""
    from eemflow_tpu_torch.events.io import write_events_h5

    if sequences is None:
        first = MVSEC_EVAL_FRAMES[0]
        sequences = (("indoor_flying1", first, 13), ("outdoor_day1", first, 13), (MVSEC_TRAIN_SEQUENCE, first, 11))
    rng = np.random.default_rng(seed)
    root = os.path.join(base, name)
    for seq, first, last in sequences:
        d = os.path.join(root, seq)
        for sub in ("event", "flowgt_dt1", "flowgt_dt4"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i in range(first, last):
            ev = np.stack([
                t0 + np.sort(rng.uniform(i * 0.03, (i + 1) * 0.03, n_events)),
                rng.integers(0, MVSEC_W, n_events).astype(np.float64),
                rng.integers(0, MVSEC_H, n_events).astype(np.float64),
                rng.integers(0, 2, n_events).astype(np.float64),
            ], axis=1)
            write_events_h5(ev, os.path.join(d, "event", f"{i + 1:06d}.h5"))
            if images:
                rng.integers(0, 255, (MVSEC_H, MVSEC_W), np.uint8)
            for sub in ("flowgt_dt1", "flowgt_dt4"):
                np.save(os.path.join(d, sub, f"{i}.npy"),
                        (rng.standard_normal((2, MVSEC_H, MVSEC_W)) * 2).astype(np.float32))
    return root


class mvsec_train_frames:
    """The train sequence's valid range set to the fixture's frames (the
    training CLI, like JAX's, has no --frames), restored on exit."""

    def __init__(self, frames=MVSEC_TRAIN_FRAMES):
        self.frames = frames

    def __enter__(self):
        import eemflow_tpu_torch.data.mvsec as mvsec

        self.table = mvsec.VALID_TIME_INDEX
        self.old = self.table[MVSEC_TRAIN_SEQUENCE]
        self.table[MVSEC_TRAIN_SEQUENCE] = [self.frames]

    def __exit__(self, *exc):
        self.table[MVSEC_TRAIN_SEQUENCE] = self.old


def mvsec_eval_args(root: str, tmp: str, device, dt: str, seq: str, eval_type: str, model: str = "eemflow",
                    ckpt: str = GOLDEN_CKPT) -> list:
    return ["-model", model, "-int", dt, "--sequence", seq, "--eval_type", eval_type, "--data_root", root,
            "--checkpoint", ckpt, "--frames", *map(str, MVSEC_EVAL_FRAMES), "--stride", "1",
            "--save_dir", os.path.join(tmp, "out_mvsec"), "--device", str(device)]


def phase_mvsec(device: torch.device, tmp: str) -> dict:
    """MVSEC through the port's CLIs at 260x346 (voxelized whole, evaluated
    on the 256x256 centre crop): ``test_mvsec`` with the golden EEMFlow
    weights on dt1 dense, dt1 sparse on an outdoor sequence (``is_car``) and
    dt4, each on the host path, with ``--device_voxelize`` (K1 and the crop),
    ``--fast`` (K3, K4) and ``--device_voxelize --eval_batch 2``, each run's
    launch counts set to 0 just before it and read just after, its AEE
    against the host path's and the host path's against the port's CPU run;
    ERAFT (golden weights) on the module path and with ``fused_update`` (K5
    at 32x32); then ``train_mvsec``: ERAFT with ``configs/mvsec_eraft.json``
    (B=6, the host path's resize augmentation) and EEMFlow with
    ``--device_voxelize`` (K1 twice a step, the crop on the card), in bf16
    (the configs' mixed precision) and float32, and 20 steps of each on one
    batch lowering its loss."""
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.tools.test_mvsec import main as test_mvsec
    from eemflow_tpu_torch.tools.train_mvsec import main as train_mvsec

    phase("3c MVSEC: the MVSEC eval and training CLIs at 260x346 (crop 256x256), golden checkpoints")
    t_phase = time.perf_counter()
    root = make_mvsec_fixture(tmp)
    say(f"MVSEC fixture: 260x346, 30,000 events a frame interval, timestamps from {MVSEC_T0:.1e} s, written "
        f"in {time.perf_counter() - t_phase:.1f} s")
    launches = {k: 0 for k in ("voxel_scatter", "local_corr", "fused_convs_pool", "coarse_head", "update_block")}
    kernel_of = (("voxel_scatter", 2), ("local_corr", 3), ("fused_convs_pool", 4), ("coarse_head", 5))
    aee = {}
    for dt, seq, eval_type in MVSEC_EVAL_CASES:
        case = f"{dt} {eval_type} {seq}"
        for path in MVSEC_EVAL_PATHS:
            label, extra = path[0], path[1]
            reset_launch_counts()
            t0 = time.perf_counter()
            res = test_mvsec(mvsec_eval_args(root, tmp, device, dt, seq, eval_type) + extra)
            counts = dict(launch_counts)
            aee[case, label] = res["AEE"]
            say(f"MVSEC {case}, {label}: AEE {res['AEE']:.7f} over {res['n_samples']} samples in "
                f"{time.perf_counter() - t0:.1f} s; launches {counts}")
            want = {k: path[i] for k, i in kernel_of}
            require(res["n_samples"] == 2 and all(counts[k] == v for k, v in want.items()),
                    f"MVSEC {case} {label}: launches {counts}, not {want}")
            for k in want:
                launches[k] += counts[k]
            host = aee[case, MVSEC_EVAL_PATHS[0][0]]
            say(f"MVSEC {case}, {label} vs host path: |Δ| {abs(res['AEE'] - host):.3e} (tolerance {PATH_TOL:g})")
            require(np.isfinite(res["AEE"]) and abs(res["AEE"] - host) < PATH_TOL,
                    f"MVSEC {case}: {label}'s AEE differs from the host path's")
        cpu = test_mvsec(mvsec_eval_args(root, tmp, "cpu", dt, seq, eval_type))["AEE"]
        host = aee[case, MVSEC_EVAL_PATHS[0][0]]
        say(f"MVSEC {case}: the card's host-path AEE {host:.7f} against the port's CPU run {cpu:.7f}: |Δ| "
            f"{abs(host - cpu):.3e} (tolerance {MVSEC_CPU_TOL:g})")
        require(abs(host - cpu) < MVSEC_CPU_TOL, f"MVSEC {case}: the card's AEE differs from the CPU's")

    # ERAFT: the module path against K5 at the crop's 32x32 grid
    cfg = os.path.join(tmp, "mvsec_eraft_fused.json")
    with open(cfg, "w") as f:
        json.dump({"fused_update": True}, f)
    eraft = {}
    for label, extra in (("module path", []), ("fused_update", ["--config", cfg])):
        reset_launch_counts()
        res = test_mvsec(mvsec_eval_args(root, tmp, device, "dt1", "indoor_flying1", "dense", "eraft", ERAFT_CKPT)
                         + extra)
        eraft[label] = (res["AEE"], launch_counts["update_block"], launch_counts["update_block_relayout"])
        say(f"MVSEC ERAFT dt1 dense, {label}: AEE {res['AEE']:.7f} over {res['n_samples']} samples; K5 launches "
            f"{launch_counts['update_block']}, inputs relaid {launch_counts['update_block_relayout']}")
    (std, k5_std, _), (fused, k5, relayout) = eraft["module path"], eraft["fused_update"]
    say(f"MVSEC ERAFT fused_update vs module path: AEE |Δ| {abs(fused - std):.3e} (tolerance {ERAFT_FUSED_TOL:g}); "
        f"K5 at the 32x32 grid, 2 samples x 12 iterations x 2 entry points")
    require(abs(fused - std) < ERAFT_FUSED_TOL and k5_std == 0 and k5 == 48 and relayout == 0,
            "MVSEC ERAFT: fused_update disagrees with the module path or did not launch K5 48 times")
    launches["update_block"] = k5

    # training, each run's launch counts set to 0 just before it
    train = {}
    with mvsec_train_frames():
        for name, config, extra, k1_step, k2_step, lr in MVSEC_TRAIN:
            for label, mp in (("bf16 (the config)", True), ("float32", False)):
                save = os.path.join(tmp, f"mvsec_train_{name}_{int(mp)}")
                reset_launch_counts()
                t0 = time.perf_counter()
                state = train_mvsec([
                    "-model", name, "--config", train_config(tmp, mp, config), "--data_root", root,
                    "--sequence", MVSEC_TRAIN_SEQUENCE, "-bs", str(TRAIN_BATCH), "--train_iters",
                    str(MVSEC_TRAIN_STEPS), "--val_iters", str(MVSEC_TRAIN_STEPS // 2), "--save_dir", save,
                    "--device", str(device), *extra,
                ])
                counts = dict(launch_counts)
                run = os.path.join(save, os.listdir(save)[0])
                recs = [r for r in read_jsonl(os.path.join(run, "metrics.jsonl")) if r["kind"] == "epoch"]
                say(f"MVSEC train CLI {name} {label}, B={TRAIN_BATCH}{' ' + ' '.join(extra) if extra else ''}: "
                    f"{MVSEC_TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s; epochs "
                    f"{[(r['epoch'], r['n_steps'], r['mean_loss']) for r in recs]}; launches {counts}")
                require(state.step == MVSEC_TRAIN_STEPS and len(recs) == 2
                        and all(np.isfinite(r["mean_loss"]) for r in recs)
                        and all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
                        f"MVSEC {name} {label}: the run did not take its steps with finite losses")
                require(counts["voxel_scatter"] == k1_step * MVSEC_TRAIN_STEPS
                        and counts["local_corr"] == k2_step * MVSEC_TRAIN_STEPS
                        and counts["fused_convs_pool"] == counts["coarse_head"] == counts["update_block"] == 0,
                        f"MVSEC {name} {label}: launches {counts}, not K1 {k1_step} and K2 {k2_step} a step")
                del state
            train[name] = (k1_step, k2_step)
            mvsec_steps_lower_the_loss(device, root, name, config, extra, lr)
    torch.cuda.empty_cache()
    say(f"phase 3c took {time.perf_counter() - t_phase:.1f} s; launches on the MVSEC eval paths {launches}")
    launches["train"] = train
    return launches


def mvsec_train_batch(root: str, device, config: str, raw: bool, seed: int = 0, batch: int = TRAIN_BATCH,
                      frames=MVSEC_TRAIN_FRAMES) -> dict:
    """One batch (B=6 by default) of the MVSEC train split as the training
    CLI makes it (the config's augmentation; raw events with flips and crop
    offsets, or host grids through the resize branch), on the card."""
    from eemflow_tpu_torch.data.loader import collate
    from eemflow_tpu_torch.data.mvsec import MvsecEventFlow
    from eemflow_tpu_torch.train.trainer import batch_to_device

    with open(os.path.join(REPO, "configs", config)) as f:
        aug = json.load(f)["data_loader"]["train"]["args"]["aug_params"]
    with mvsec_train_frames(frames):
        ds = MvsecEventFlow(root, MVSEC_TRAIN_SEQUENCE, train=True, aug_params=aug, raw_events=raw,
                            bucket_rungs=4, rng=np.random.default_rng(seed))
        return batch_to_device(collate([ds[i] for i in range(batch)]), device)


def mvsec_train_state(device, name: str, lr: float):
    from eemflow_tpu_torch.models.registry import get_model
    from eemflow_tpu_torch.train.optim import make_optimizer
    from eemflow_tpu_torch.train.trainer import create_train_state

    return create_train_state(get_model(name, n_first_channels=BINS), 0, make_optimizer(lr, num_steps=1000),
                              device=device)


def mvsec_step(name: str, mixed_precision: bool):
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.train.trainer import make_train_step

    pre = (make_device_preprocess(BINS, MVSEC_H, MVSEC_W, crop_size=(MVSEC_CROP, MVSEC_CROP))
           if name == "eemflow" else None)
    return make_train_step(preprocess=pre, mixed_precision=mixed_precision)


def mvsec_steps_lower_the_loss(device, root: str, name: str, config: str, extra: list, lr: float,
                               batch: int = TRAIN_BATCH, frames=MVSEC_TRAIN_FRAMES) -> None:
    """20 steps on one fixed MVSEC batch (B=6 by default) lower its loss, in
    bf16 and in float32."""
    data = mvsec_train_batch(root, device, config, raw="--device_voxelize" in extra, batch=batch, frames=frames)
    for label, mp in (("bf16", True), ("float32", False)):
        state = mvsec_train_state(device, name, lr)
        step = mvsec_step(name, mp)
        losses = [float(step(state, data)[1]["loss"]) for _ in range(20)]
        say(f"20 {label} MVSEC {name} steps (lr {lr:g}) on one 256x256 B={batch} batch: loss "
            f"{losses[0]:.6f} → {losses[-1]:.6f} (every 5th: {[round(x, 6) for x in losses[::5]]})")
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"20 {label} MVSEC {name} steps on one batch did not lower its loss")


def times_mvsec(device, tmp: str, launches: dict) -> dict:
    """Phase 4 at MVSEC's shapes: each kernel on the device (queued; K3, K4
    and K5 also after an L2 flush) beside its bound, its plain version and
    the library call where there is one; the 256x256 B=1 forwards of EEMFlow
    (standard and ``--fast``) and ERAFT (module path and K5) back to back and
    their device busy time (one profiled run); one whole eval sample; the
    two train steps (ms back to back, busy share, peak memory).  Returns
    each kernel's MVSEC fields for the ``kernels`` line."""
    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.data.mvsec import MvsecEventFlow
    from eemflow_tpu_torch.eval.runner import Tester
    from eemflow_tpu_torch.events.voxel import normalize_voxel_grid, voxel_votes, voxelize_plain
    from eemflow_tpu_torch.kernels import coarse_head as k4
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.kernels import update_block as k5
    from eemflow_tpu_torch.kernels import voxel_scatter as k1
    from eemflow_tpu_torch.kernels.fused_convs import pack_chain
    from eemflow_tpu_torch.models.eemflow import INDEX_53
    from eemflow_tpu_torch.models.registry import get_eval_model
    from eemflow_tpu_torch.ops.coarse_head import HeadWeights, coarse_head
    from eemflow_tpu_torch.ops.update_block import gru_flowhead_plain, make_fused_update, motion_encoder_plain
    from eemflow_tpu_torch.tools.update_block_bound import update_block_work

    rng = np.random.default_rng(14)
    hw = MVSEC_H * MVSEC_W
    rows = {}
    # K1: one frame at 260x346, a dt1 and a dt4 window (the eval path's call)
    k1_fields = {"mvsec_launches": launches["voxel_scatter"],
          "mvsec_launches_per_train_step_eemflow": launches["train"]["eemflow"][0]}
    for n_events, tag in ((30_000, "dt1"), (120_000, "dt4")):
        ev, nv = k1_batch(rng, (n_events,), N=1 << 17, h=MVSEC_H, w=MVSEC_W)
        e, n = torch.from_numpy(ev).to(device), torch.from_numpy(nv).to(device)
        idx, val = voxel_votes(e, n, BINS, MVSEC_H, MVSEC_W)
        nbytes = n_events * 16 + BINS * hw * 4
        bound, by = bound_ms(nbytes, 2 * idx.numel())

        def library():
            g = torch.zeros(BINS * hw, device=device)
            g.index_put_((idx,), val, accumulate=True)
            return normalize_voxel_grid(g.view(1, BINS, MVSEC_H, MVSEC_W))

        fn = lambda: k1.voxelize(e, n, BINS, MVSEC_H, MVSEC_W)
        dev, wrap = queued_ms(fn, reps=20), cuda_ms(fn)
        plain, lib = cuda_ms(lambda: voxelize_plain(e, n, BINS, MVSEC_H, MVSEC_W), reps=5), cuda_ms(library)
        say(f"MVSEC K1 voxelize B=1 260x346 {tag} window ({n_events} events): {dev:.4f} ms on the device "
            f"(queued), {wrap:.4f} ms per wrapper call back to back; bound {bound:.5f} ms ({by}: {nbytes} B); "
            f"index_put_ + normalize_voxel_grid {lib:.4f} ms; plain version {plain:.4f} ms")
        k1_fields.update({f"mvsec_ms_{tag}": dev, f"mvsec_wrapper_ms_{tag}": wrap, f"mvsec_bound_ms_{tag}": bound,
                   f"mvsec_plain_ms_{tag}": plain, f"mvsec_library_ms_{tag}": lib})
    rows["voxel_scatter"] = k1_fields

    sd = to_state_dict(load_torch_checkpoint(GOLDEN_CKPT))
    model = get_eval_model("eemflow")
    model.load_state_dict(sd)
    model.to(device)
    # K2: the three 4x4 levels of a 256x256 B=1 forward, one launch
    p1, p2 = forward_pooled(model, 1, device, seed=30, h=MVSEC_CROP, w=MVSEC_CROP)
    K = len(model.corr_indices)
    nbytes, flops = k2_work(p1, K, 4)
    bound, by = bound_ms(nbytes, flops)
    with torch.inference_mode():
        step = lambda: model._corrs(p1, p2)
        plain = lambda: [k2.plain(a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1), model.max_displacement,
                                  model.corr_indices) for a, b in zip(p1, p2)]
        dev, wrap, plain_ms = queued_ms(step, reps=50), cuda_ms(step, reps=50), cuda_ms(plain, reps=10)
    say(f"MVSEC K2 local_corr_levels, the three 4x4 levels of a 256x256 B=1 forward (K={K}): {dev:.4f} ms on the "
        f"device (queued), {wrap:.4f} ms per call back to back; bound {bound:.6f} ms ({by}: {nbytes} B, {flops} "
        f"FLOP); plain version {plain_ms:.4f} ms")
    rows["local_corr"] = {"mvsec_launches": launches["local_corr"], "mvsec_ms": dev, "mvsec_wrapper_ms": wrap,
                          "mvsec_bound_ms": bound, "mvsec_plain_ms": plain_ms,
                          "mvsec_launches_per_train_step_eemflow": launches["train"]["eemflow"][1]}

    # K3: the six calls of a 256x256 B=1 pyramid (three levels, two frames)
    calls, flops, nbytes = [], 0, 0
    for (cin, h, w), widths, pool, emit_full in K3_LEVELS_MVSEC:
        ws, bs = conv_params(rng, (cin,) + widths[:-1], widths, device)
        packed = pack_chain(ws, bs, False, device, pool)  # as the model packs its weights once
        for _ in range(2):
            x = torch.from_numpy(rng.standard_normal((1, cin, h, w)).astype(np.float32)).to(device)
            calls.append((x, ws, bs, pool, emit_full, packed))
            f_, b_ = k3_flops_bytes(1, cin, h, w, widths, emit_full, pool)
            flops, nbytes = flops + f_, nbytes + b_
    with torch.inference_mode():
        six = lambda: [k3.fused_convs(x, ws, bs, pool, torch.float32, full, packed=packed)
                       for x, ws, bs, pool, full, packed in calls]
        six_plain = lambda: [k3.plain(x, ws, bs, pool, torch.float32, full) for x, ws, bs, pool, full, _ in calls]
        dev, warm = cold_queued_ms(six, 10, device), queued_ms(six, reps=10)
        wrap, plain_ms = cuda_ms(six, reps=10), cuda_ms(six_plain, reps=5)
    bound, by = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)
    say(f"MVSEC K3 fused_convs_pool, the six calls of a 256x256 B=1 pyramid, float32 (split TF32): {dev:.4f} ms on "
        f"the device after an L2 flush ({warm:.4f} warm), {wrap:.4f} ms per six wrapper calls back to back; bound "
        f"{bound:.5f} ms ({by}: 3 x {flops} FLOP at the TF32 peak, {nbytes} B); plain version {plain_ms:.4f} ms")
    rows["fused_convs_pool"] = {"mvsec_launches": launches["fused_convs_pool"], "mvsec_ms": dev,
                                "mvsec_warm_ms": warm, "mvsec_wrapper_ms": wrap, "mvsec_bound_ms": bound,
                                "mvsec_plain_ms": plain_ms}

    # K4: the coarse stage on the three 4x4 levels of a B=1 forward
    weights = HeadWeights(head_params(rng, 5, device), 5)
    f1, f2 = ([torch.from_numpy(rng.standard_normal((1, 4, 4, c)).astype(np.float32)).to(device)
               for c in HEAD_CHANNELS] for _ in range(2))
    packed = weights.kernel(device)
    flops, nbytes = k4_flops_bytes(1, 4, 4, packed, len(INDEX_53))
    bound, by = bound_ms(nbytes, flops)
    with torch.inference_mode():
        head = lambda: k4._launch(f1, f2, weights, INDEX_53, 4, None)
        dev, warm, wrap = cold_queued_ms(head, 20, device), queued_ms(head, reps=20), cuda_ms(head, reps=20)
        plain_ms = cuda_ms(lambda: coarse_head(f1, f2, weights, 5, INDEX_53, 4, impl="plain"), reps=10)
    say(f"MVSEC K4 coarse_head B=1, the three 4x4 levels (the +-4 window wider than the grid): {dev:.4f} ms on the "
        f"device after an L2 flush ({warm:.4f} warm), {wrap:.4f} ms per wrapper call back to back; bound "
        f"{bound:.6f} ms ({by}); plain version {plain_ms:.4f} ms")
    rows["coarse_head"] = {"mvsec_launches": launches["coarse_head"], "mvsec_ms": dev, "mvsec_warm_ms": warm,
                           "mvsec_wrapper_ms": wrap, "mvsec_bound_ms": bound, "mvsec_plain_ms": plain_ms}

    # K5: one pair at ERAFT's 32x32 grid of a 256x256 crop, float32
    block = k5_block(rng, device)
    fused = make_fused_update(block, torch.float32)
    net, inp, corr, flow = k5_inputs(rng, 32, 32, device)
    flops, nbytes = update_block_work(32, 32, 1)
    bound, by = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)
    with torch.inference_mode():
        pair = lambda: k5.update_gru(net, inp, k5.update_motion(corr, flow, fused), fused)
        plain = lambda: gru_flowhead_plain(net, inp, motion_encoder_plain(corr, flow, fused.motion, torch.float32),
                                           fused.gru, torch.float32)
        dev, warm, wrap = cold_queued_ms(pair, 10, device), queued_ms(pair, reps=10), cuda_ms(pair, reps=10)
        plain_ms = cuda_ms(plain, reps=10)
    say(f"MVSEC K5 update_block pair B=1 32x32 float32: {dev:.4f} ms on the device after an L2 flush ({warm:.4f} "
        f"warm), {wrap:.4f} ms per wrapper pair back to back; bound {bound:.5f} ms ({by}: 3 x {flops} FLOP at the "
        f"TF32 peak, {nbytes} B); plain version {plain_ms:.4f} ms")
    rows["update_block"] = {"mvsec_launches": launches["update_block"], "mvsec_ms": dev, "mvsec_warm_ms": warm,
                            "mvsec_wrapper_ms": wrap, "mvsec_bound_ms": bound, "mvsec_plain_ms": plain_ms}

    # the 256x256 B=1 forwards
    x1, x2 = (torch.randn(1, MVSEC_CROP, MVSEC_CROP, BINS, device=device) for _ in range(2))
    eraft_sd = to_state_dict(load_torch_checkpoint(ERAFT_CKPT))
    for name, label, kw, state in (("eemflow", "standard", {}, sd), ("eemflow", "--fast", {"fast_head": True,
                                   "fast_pyramid": True}, sd), ("eraft", "module path", {}, eraft_sd),
                                   ("eraft", "fused_update (K5)", {"fused_update": True}, eraft_sd)):
        m = get_eval_model(name, **kw)
        m.load_state_dict(state)
        m.to(device)

        def forward(m=m):
            with torch.inference_mode():
                return m(x1, x2)[1][-1]

        require(tuple(forward().shape) == (1, MVSEC_CROP, MVSEC_CROP, 2) and bool(torch.isfinite(forward()).all()),
                f"the 256x256 {name} {label} forward is not finite or has the wrong shape")
        b2b = cuda_ms(forward, reps=10)
        prof = profiled_step(forward, reps=5, tmp=tmp)
        say(f"MVSEC forward {name} 256x256 B=1, {label}: {b2b:.3f} ms back to back ({1e3 / b2b:.1f} fps); the device "
            f"busy {prof['busy_ms']:.3f} ms of {prof['profiled_ms']:.3f} ms a profiled call "
            f"({100 * prof['busy_share']:.1f}%, {prof['device_ops']:.0f} kernels and copies)")
        del m

    # one whole eval sample, host and device voxelize (dt1)
    root = os.path.join(tmp, "mvsec")
    table = {"indoor_flying1": [MVSEC_EVAL_FRAMES]}
    for label, raw in (("host voxelize", False), ("device voxelize", True)):
        ds = MvsecEventFlow(root, "indoor_flying1", train=False, raw_events=raw, valid_time_index=table)
        sample = ds[0]
        pre = (make_device_preprocess(BINS, MVSEC_H, MVSEC_W, crop_size=(MVSEC_CROP, MVSEC_CROP)) if raw else None)
        tester = Tester(model, device, preprocess=pre)
        for _ in range(3):
            tester.run_sample(sample)
        t0 = time.perf_counter()
        for _ in range(20):
            tester.run_sample(sample)
        ms = (time.perf_counter() - t0) / 20 * 1e3
        t0 = time.perf_counter()
        for _ in range(5):
            ds[0]
        read_ms = (time.perf_counter() - t0) / 5 * 1e3
        say(f"MVSEC whole eval sample dt1, {label} (arrays from the host → {'K1 voxelize x2 + crop → ' if raw else ''}"
            f"forward → flow on the host): {ms:.3f} ms ({1e3 / ms:.1f} fps); the dataset's read of the sample "
            f"{read_ms:.3f} ms on the host")

    # the two train steps at B=6
    for name, config, extra, _, _, lr in MVSEC_TRAIN:
        data = mvsec_train_batch(root, device, config, raw="--device_voxelize" in extra)
        for label, mp in (("bf16", True), ("float32", False)):
            state = mvsec_train_state(device, name, lr)
            step = mvsec_step(name, mp)
            run = lambda: step(state, data)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
            b2b = cuda_ms(run, reps=10, warmup=1)
            prof = profiled_step(run, reps=3, tmp=tmp)
            say(f"MVSEC train step {name} 256x256 B={TRAIN_BATCH}{' device voxelize' if extra else ' host grids'}, "
                f"{label}: {b2b:.3f} ms back to back ({TRAIN_BATCH * 1e3 / b2b:.1f} samples/s); under torch.profiler "
                f"{prof['profiled_ms']:.3f} ms a step, the device busy {prof['busy_ms']:.3f} ms of it "
                f"({100 * prof['busy_share']:.1f}%, {prof['device_ops']:.0f} kernels and copies); peak allocated "
                f"{peak / 2**30:.3f} GiB")
            del state, step, run
            torch.cuda.empty_cache()
    return rows


# GMA, SKFlow and KPAFlow (phase 3d): their golden checkpoints, each on the
# JAX package's golden fixture and protocol (GMA on phase 3's seed-99 HREM
# split at 720x1280, SKFlow and KPAFlow on the seed-55 MVSEC sequence of
# tests/test_golden_acceptance.py, dt1 dense; one sample, 12 iterations);
# the device path against the host path (the same function, the grid summed
# in another order and carried through 12 iterations); the card against the
# CPU, relative to max(1, largest |flow|), with every gate drawn nonzero
ZOO = ("gma", "skflow", "kpaflow")
ZOO_GOLDENS = {
    "gma": ("hrem", "gma_hrem_golden.pth.tar", "hrem_golden_gma.json"),
    "skflow": ("mvsec", "skflow_mvsec_golden.pth.tar", "mvsec_golden_skflow.json"),
    "kpaflow": ("mvsec", "kpaflow_mvsec_golden.pth.tar", "mvsec_golden_kpaflow.json"),
}
ZOO_PATH_TOL = 1e-4
ZOO_FORWARD_TOL = 1e-4
# the update blocks' weights at this share of their He variance (the CPU
# tests' draws, tests/test_torch_gma.py and test_torch_train_zoo.py): at the
# full variance SKFlow's residual PCBlocks grow the flow ~10^4x an iteration
ZOO_SCALE = {"gma": 0.5, "skflow": 0.3, "kpaflow": 1.0}
ZOO_ITERS = 3  # the card-vs-CPU forwards and train step
ZOO_LR = 1e-4  # the 20-step loss check
ZOO_TRAIN_PATHS = (("bf16 (the config), host grids", True, [], 0),
                   ("float32, --device_voxelize", False, ["--device_voxelize"], 2))


def zoo_seeded(model, rng, scale: float):
    """Draw the model's weights from ``rng`` as the CPU tests draw the JAX
    model's: conv weights normal with variance 2/fan_out in the encoders,
    1/fan_in in a GRU and 2/fan_in elsewhere (times ``scale`` outside the
    encoders), conv biases N(0, 0.01²), norms at scale 1 and bias 0, every
    gate (``gamma``) uniform in [0.5, 1.5] and ``w_prelu`` its init value
    times uniform [0.5, 1.5].  Returns the model."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.Conv2d):
                o, i, kh, kw = m.weight.shape
                if name.startswith(("fnet.", "cnet.")):
                    var = 2.0 / (o * kh * kw)
                else:
                    var = (1.0 if ".gru." in f".{name}." else 2.0) / (i * kh * kw) * scale
                m.weight.copy_(torch.from_numpy(rng.standard_normal(m.weight.shape) * np.sqrt(var)))
                if m.bias is not None:
                    m.bias.copy_(torch.from_numpy(rng.standard_normal(m.bias.shape) * 0.01))
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape)))
            elif name.endswith("w_prelu"):
                p.mul_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape)).float())
    return model


def phase_zoo(device: torch.device, tmp: str) -> dict:
    """GMA, SKFlow and KPAFlow through the port's CLIs: the golden
    checkpoints (GMA's through ``test_hrem`` at 720x1280, SKFlow's and
    KPAFlow's through ``test_mvsec`` on MVSEC dt1 dense), each on the host
    path and with ``--device_voxelize`` (K1), each run's launch counts set to
    0 just before it and read just after; the card against the CPU at
    256x256 B=1 (3 iterations, seeded weights, every gate nonzero);
    ``train_mvsec`` at B=6 with each model's own config in bf16 (host grids)
    and float32 (``--device_voxelize``); one float32 train step on the card
    against the CPU at 128x128 B=2; 20 steps on one batch lowering its loss
    in bf16 and float32.  Draws from a generator of its own.  Returns the
    K1 calls of its device paths."""
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model
    from eemflow_tpu_torch.tools.test_hrem import main as test_hrem
    from eemflow_tpu_torch.tools.test_mvsec import main as test_mvsec
    from eemflow_tpu_torch.tools.train_mvsec import main as train_mvsec

    phase("3d zoo: GMA, SKFlow and KPAFlow: goldens (HREM 720x1280, MVSEC dt1 dense), the card against the CPU, "
          "train_mvsec at B=6 with their configs")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)
    fixtures = os.path.join(REPO, "tests", "fixtures")
    hrem_root = hrem_split(tmp)
    golden_mvsec = golden_mvsec_split(tmp)
    k1_calls = 0
    others = ("local_corr", "fused_convs_pool", "coarse_head", "update_block")
    for name in ZOO:
        data, ckpt, golden_json = ZOO_GOLDENS[name]
        with open(os.path.join(fixtures, golden_json)) as f:
            golden = json.load(f)
        aee = {}
        for label, extra, k1 in (("host voxelize", [], 0), ("device voxelize", ["--device_voxelize"], 2)):
            common = ["-model", name, "-int", "dt1", "--checkpoint", os.path.join(fixtures, ckpt), "--max_samples",
                      str(golden["max_samples"]), "--device", str(device), *extra]
            reset_launch_counts()
            t0 = time.perf_counter()
            if data == "hrem":
                res = test_hrem(common + ["--data_root", hrem_root, "--save_dir", os.path.join(tmp, "out_zoo")])
                aee[label] = res["mean"]["AEE"]
            else:
                res = test_mvsec(common + ["--sequence", "indoor_flying1", "--eval_type", "dense", "--data_root",
                                           golden_mvsec, "--frames", "3", "9", "--stride", "1", "--save_dir",
                                           os.path.join(tmp, "out_zoo")])
                aee[label] = res["AEE"]
            counts = dict(launch_counts)
            say(f"zoo {name} golden ({data}), {label}: AEE {aee[label]:.7f} in {time.perf_counter() - t0:.1f} s; "
                f"launches {counts}")
            require(counts["voxel_scatter"] == k1 and all(counts[k] == 0 for k in others),
                    f"zoo {name} {label}: launches {counts}, not K1 {k1} and no other kernel")
            k1_calls += counts["voxel_scatter"]
        host, dev = aee["host voxelize"], aee["device voxelize"]
        say(f"zoo {name}: golden AEE {golden['aee']:.7f}, host path |Δ| {abs(host - golden['aee']):.3e} (tolerance "
            f"{GOLDEN_TOL:g}); device voxelize vs host path |Δ| {abs(dev - host):.3e} (tolerance {ZOO_PATH_TOL:g})")
        require(abs(host - golden["aee"]) < GOLDEN_TOL and abs(dev - host) <= ZOO_PATH_TOL,
                f"zoo {name}: the golden AEE drifted or the device path differs from the host path")

    # the card against the CPU, every gate nonzero
    for name in ZOO:
        model = zoo_seeded(get_eval_model(name, iters=ZOO_ITERS), rng, ZOO_SCALE[name])
        ev1, ev2 = (torch.from_numpy(rng.standard_normal((1, MVSEC_CROP, MVSEC_CROP, BINS)).astype(np.float32))
                    for _ in range(2))
        with torch.inference_mode():
            ref = model(ev1, ev2)[1][-1]
            model.to(device)
            got = model(ev1.to(device), ev2.to(device))[1][-1].cpu()
            gates = [p for n, p in model.named_parameters() if n.endswith("gamma")]
            for p in gates:
                p.zero_()
            ungated = model(ev1.to(device), ev2.to(device))[1][-1].cpu()
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max())
        say(f"zoo {name} forward 256x256 B=1, {ZOO_ITERS} iterations, gates nonzero, card vs CPU: max|Δ| {err:.3e} "
            f"(tolerance {ZOO_FORWARD_TOL:g}·{scale:.3f}); largest flow {float(ref.abs().max()):.3f}, moved "
            f"{float((ungated - got).abs().max()):.3f} by zeroing the {len(gates)} gates")
        require(bool(torch.isfinite(got).all()) and err <= ZOO_FORWARD_TOL * scale,
                f"zoo {name}: the forward on the card disagrees with the CPU")
        del model

    # train_mvsec at B=6 with each model's own config, its launch counts set
    # to 0 just before each run
    root = mvsec_split(tmp)
    with mvsec_train_frames():
        for name in ZOO:
            config = f"mvsec_{name}.json"
            for label, mp, extra, k1_step in ZOO_TRAIN_PATHS:
                save = os.path.join(tmp, f"zoo_train_{name}_{int(mp)}")
                reset_launch_counts()
                t0 = time.perf_counter()
                state = train_mvsec([
                    "-model", name, "--config", train_config(tmp, mp, config), "--data_root", root, "--sequence",
                    MVSEC_TRAIN_SEQUENCE, "-bs", str(TRAIN_BATCH), "--train_iters", str(MVSEC_TRAIN_STEPS),
                    "--val_iters", str(MVSEC_TRAIN_STEPS // 2), "--save_dir", save, "--device", str(device), *extra,
                ])
                counts = dict(launch_counts)
                run = os.path.join(save, os.listdir(save)[0])
                recs = [r for r in read_jsonl(os.path.join(run, "metrics.jsonl")) if r["kind"] == "epoch"]
                say(f"zoo train_mvsec {name} {label}, B={TRAIN_BATCH}: {MVSEC_TRAIN_STEPS} steps in "
                    f"{time.perf_counter() - t0:.1f} s; epochs {[(r['epoch'], r['n_steps'], r['mean_loss']) for r in recs]}"
                    f"; launches {counts}")
                require(state.step == MVSEC_TRAIN_STEPS and len(recs) == 2
                        and all(np.isfinite(r["mean_loss"]) for r in recs)
                        and all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
                        f"zoo {name} {label}: the run did not take its steps with finite losses")
                require(counts["voxel_scatter"] == k1_step * MVSEC_TRAIN_STEPS and all(counts[k] == 0 for k in others),
                        f"zoo {name} {label}: launches {counts}, not K1 {k1_step} a step and no other kernel")
                k1_calls += counts["voxel_scatter"]
                del state
            zoo_step_card_vs_cpu(device, name, rng)
            mvsec_steps_lower_the_loss(device, root, name, config, [], ZOO_LR)
            torch.cuda.empty_cache()
    say(f"phase 3d took {time.perf_counter() - t_phase:.1f} s; K1 calls on its device paths {k1_calls}")
    return {"voxel_scatter": k1_calls}


def zoo_step_card_vs_cpu(device: torch.device, name: str, rng) -> None:
    """One float32 train step of ``name`` (3 iterations; device voxelize with
    flips, forward, loss, backward, clip, AdamW) from the same seeded
    parameters, every gate nonzero, and batch at 128x128, B=2: on the card
    and on the CPU; the loss and every gradient, in units of the model's
    largest |g| (phase 3b's ERAFT rule), and the whole gradient."""
    from eemflow_tpu_torch.models.registry import get_model
    from eemflow_tpu_torch.train.optim import make_optimizer
    from eemflow_tpu_torch.train.trainer import create_train_state

    h, w, B, N = 128, 128, 2, 4096
    params = zoo_seeded(get_model(name, iters=ZOO_ITERS), rng, ZOO_SCALE[name]).state_dict()
    ev, nv = k1_batch(rng, (N, N - 100, N - 7, N), N=N, h=h, w=w)
    batch = {
        "events_old": ev[:B], "events_new": ev[B:], "n_old": nv[:B], "n_new": nv[B:],
        "flip_h": np.array([True, False]), "flip_v": np.array([False, True]),
        "flow": (rng.standard_normal((B, h, w, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, h, w), np.float32),
    }
    runs = step_on_cpu_and_card(
        device, lambda dev: create_train_state(get_model(name, iters=ZOO_ITERS), 0, make_optimizer(1e-4, num_steps=100),
                                               params=params, device=dev), batch, BINS, h, w)
    (loss_cpu, g_cpu, n_cpu), (loss_gpu, g_gpu, n_gpu) = runs["cpu"], runs["card"]
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst = max(float((g_gpu[n] - g).abs().max()) for n, g in g_cpu.items()) / top
    whole = float(torch.cat([(g_gpu[n] - g).flatten() for n, g in g_cpu.items()]).norm()
                  / torch.cat([g.flatten() for g in g_cpu.values()]).norm())
    say(f"zoo {name}: one float32 train step at {h}x{w} B={B}, {ZOO_ITERS} iterations, gates nonzero, card (K1 calls, "
        f"K2 launches {n_gpu}) vs CPU ({n_cpu}): loss {loss_gpu:.7f} vs {loss_cpu:.7f} (|Δ| relative "
        f"{abs(loss_gpu - loss_cpu) / loss_cpu:.3e}, tolerance {TRAIN_LOSS_RTOL:g}); grads: the worst parameter's "
        f"max|Δ| is {worst:.3e} of the model's largest |g| (tolerance {TRAIN_GRAD_TOL:g}); the whole gradient "
        f"{whole:.3e} relative L2")
    require(n_gpu == (2, 0) and n_cpu == (0, 0), f"zoo {name}: the card's train step did not run K1 twice")
    require(np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)
            and worst <= TRAIN_GRAD_TOL and whole <= TRAIN_GRAD_TOL,
            f"zoo {name}: the train step on the card disagrees with the CPU")


def times_zoo(device, tmp: str) -> dict:
    """Phase 4 for GMA, SKFlow and KPAFlow: GMA's 720x1280 B=1 eval forward
    (golden weights), and the three 256x256 B=1 forwards, back to back
    (CUDA events) and the device's busy time in one profiled run;
    SKFlow's and KPAFlow's first kernels by device time; SKFlow's 15x15
    depthwise convs of one forward, replayed on their inputs, by their
    kernels' device time against the forward's busy time; the B=6 MVSEC
    train steps with each model's config (host grids),
    in bf16 and float32: ms back to back, busy share, peak memory."""
    from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
    from eemflow_tpu_torch.models.registry import get_eval_model

    fixtures = os.path.join(REPO, "tests", "fixtures")
    out = {}
    forwards = [("gma", (H, W))] + [(n, (MVSEC_CROP, MVSEC_CROP)) for n in ZOO]
    for name, (h, w) in forwards:
        model = get_eval_model(name)
        load_model_checkpoint(model, os.path.join(fixtures, ZOO_GOLDENS[name][1]), name, log=say)
        model.to(device)
        x1, x2 = (torch.randn(1, h, w, BINS, device=device) for _ in range(2))

        def forward(m=model):
            with torch.inference_mode():
                return m(x1, x2)[1][-1]

        require(tuple(forward().shape) == (1, h, w, 2) and bool(torch.isfinite(forward()).all()),
                f"the {h}x{w} {name} forward is not finite or has the wrong shape")
        b2b = cuda_ms(forward, reps=5 if h == H else 10)
        prof = profiled_step(forward, reps=1, tmp=tmp)
        say(f"zoo forward {name} {h}x{w} B=1, 12 iterations: {b2b:.3f} ms back to back ({1e3 / b2b:.1f} fps); the "
            f"device busy {prof['busy_ms']:.3f} ms of {prof['profiled_ms']:.3f} ms a profiled call "
            f"({100 * prof['busy_share']:.1f}%, {prof['device_ops']:.0f} kernels and copies)")
        out[f"{name}_{h}x{w}"] = {"ms": b2b, **prof}
        if name in ("skflow", "kpaflow"):
            summed, line = top_kernels(forward)
            say(f"zoo {name} 256x256 forward's first kernels by device time: {line}")
        if name == "skflow":
            calls = []
            hooks = [m.register_forward_hook(lambda mod, inp, _o: calls.append((mod, inp[0])))
                     for m in model.modules() if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (15, 15)]
            forward()
            for hk in hooks:
                hk.remove()
            def convs15():
                with torch.inference_mode():
                    return [mod(x) for mod, x in calls]

            dw, line = top_kernels(convs15, 3)
            say(f"zoo SKFlow 256x256 forward: its {len(calls)} 15x15 depthwise convs, replayed on their inputs, take "
                f"{dw:.3f} ms of summed device time, {100 * dw / summed:.1f}% of the forward's {summed:.3f}: {line}")
            out["skflow_depthwise15_ms"] = dw
        del model
        torch.cuda.empty_cache()

    root = os.path.join(tmp, "mvsec")
    for name in ZOO:
        data = mvsec_train_batch(root, device, f"mvsec_{name}.json", raw=False)
        for label, mp in (("bf16", True), ("float32", False)):
            state = mvsec_train_state(device, name, ZOO_LR)
            step = mvsec_step(name, mp)
            run = lambda: step(state, data)
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
            b2b = cuda_ms(run, reps=3, warmup=1)
            prof = profiled_step(run, reps=1, tmp=tmp)
            say(f"zoo train step {name} 256x256 B={TRAIN_BATCH} host grids (its config), {label}: {b2b:.3f} ms back "
                f"to back ({TRAIN_BATCH * 1e3 / b2b:.1f} samples/s); under torch.profiler {prof['profiled_ms']:.3f} "
                f"ms a step, the device busy {prof['busy_ms']:.3f} ms of it ({100 * prof['busy_share']:.1f}%, "
                f"{prof['device_ops']:.0f} kernels and copies); peak allocated {peak / 2**30:.3f} GiB")
            out[f"train_{name}_{label}"] = {"ms": b2b, "peak_gib": peak / 2**30, **prof}
            del state, step, run
            torch.cuda.empty_cache()
    return out


# GMFlow and FlowFormer (phase 3e): their golden checkpoints on phase 3's
# seed-99 HREM split at 720x1280 (one sample), each on the host path and
# with --device_voxelize; the card against the CPU at 256x256 B=1 on seeded
# weights; train_mvsec with each model's own config at its batch (GMFlow
# B=8, FlowFormer B=6) on an MVSEC train sequence of eight samples
TRANSFORMERS = ("gmflow", "flowformer")
TRANSFORMER_GOLDENS = {"gmflow": ("gmflow_hrem_golden.pth.tar", "hrem_golden_gmflow.json"),
                       "flowformer": ("flowformer_hrem_golden.pth.tar", "hrem_golden_flowformer.json")}
TRANSFORMER_BATCH = {"gmflow": 8, "flowformer": 6}  # configs/mvsec_<name>.json
GMFLOW_TWO_SCALE = dict(num_scales=2, upsample_factor=4, attn_splits_list=(2, 2), corr_radius_list=(-1, 4),
                        prop_radius_list=(-1, 1))
# (label, model, fields, K2 launches a forward) of the 256x256 card-vs-CPU
# forwards: the two-scale GMFlow's local matching at 1/4 (64x64, C=128,
# md=4, the full 9x9 window) is K2's
TRANSFORMER_FORWARDS = (("GMFlow one-scale", "gmflow", {}, 0),
                        ("GMFlow two-scale", "gmflow", GMFLOW_TWO_SCALE, 1),
                        ("FlowFormer, decoder depth 3", "flowformer", {"decoder_depth": 3}, 0))
# GMFlow's LayerNorm scales and its encoder's output conv at this share of
# their draws: at the full draws its softmax matching is a near-argmax at
# 256x256 (flows reach the frame's edge, ~200 px), where a float32 rounding
# moves a pixel's match, on either device (the two-scale one's float32
# flow lies pixels from a float64 run); at 0.3 the flows are 20-30 px and
# the card within a few 1e-6 of max(1, |flow|) of the CPU
GMFLOW_SOFT = 0.3
TRANSFORMER_PATH_TOL = 1e-4
TRANSFORMER_LR = 1e-4  # the 20-step loss check
MVSEC_3E_FRAMES = (3, 11)  # eight train samples, GMFlow's B=8


def transformer_seeded(model, rng, soft: float = 1.0):
    """Draw a GMFlow's or FlowFormer's weights from ``rng`` as the CPU tests
    draw the JAX model's (``tests/test_torch_gmflow.seeded_transformer_variables``):
    conv weights normal with variance 2/fan_in (1/fan_in in a GRU), linear
    weights 1/fan_in, biases N(0, 0.01²), LayerNorm scales uniform in [0.8,
    1.2], the gate ``gamma`` uniform in [0.5, 1.5], the latent tokens N(0,
    1); FlowFormer's ``channel_convertor`` at a tenth of its deviation
    (``tests/test_torch_flowformer.py``: its cost volume has no 1/√C);
    GMFlow's LayerNorm scales and encoder output conv times ``soft``.
    Returns the model."""
    def normal(shape, std):
        return torch.from_numpy(rng.standard_normal(shape) * std).float()

    with torch.no_grad():
        for name, p in model.named_parameters():
            mod, _, leaf = name.rpartition(".")
            if leaf == "weight" and p.dim() > 1:
                fan_in = p[0].numel()
                var = (1.0 if p.dim() == 2 or ".gru." in f".{mod}." else 2.0) / fan_in
                if mod.endswith("channel_convertor"):
                    var *= 0.01
                p.copy_(normal(p.shape, np.sqrt(var) * (soft if mod == "backbone.conv2" else 1.0)))
            elif leaf == "weight":
                p.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, p.shape) * soft).float())
            elif leaf == "gamma":
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape)).float())
            elif leaf == "latent_tokens":
                p.copy_(normal(p.shape, 1.0))
            else:
                p.copy_(normal(p.shape, 0.01))
    return model


def hrem_split(tmp: str) -> str:
    """Phase 3's seed-99 HREM split, made here when phase 3 did not run."""
    root = os.path.join(tmp, "hrem")
    if not os.path.isdir(root):
        with open(GOLDEN_JSON) as f:
            make_hrem_fixture(tmp, seed=json.load(f)["fixture_seed"])
    return root


def mvsec_split(tmp: str) -> str:
    """Phase 3c's MVSEC sequences, made here when phase 3c did not run."""
    root = os.path.join(tmp, "mvsec")
    return root if os.path.isdir(root) else make_mvsec_fixture(tmp)


def golden_mvsec_split(tmp: str) -> str:
    """The JAX package's golden MVSEC sequence
    (``tests/test_golden_acceptance.make_mvsec_fixture``, draw for draw),
    made by the first phase that reads it."""
    root = os.path.join(tmp, "mvsec_golden")
    if os.path.isdir(root):
        return root
    return make_mvsec_fixture(tmp, n_events=20000, sequences=(("indoor_flying1", 2, 18),), t0=0.0, images=True,
                              name="mvsec_golden")


def mvsec_3e_split(tmp: str) -> str:
    """An eight-sample MVSEC train sequence (seed 57; GMFlow's and the
    default config's B=8), made by the first phase that reads it."""
    root = os.path.join(tmp, "mvsec_3e")
    if os.path.isdir(root):
        return root
    return make_mvsec_fixture(tmp, seed=57, sequences=((MVSEC_TRAIN_SEQUENCE, MVSEC_3E_FRAMES[0],
                                                       MVSEC_3E_FRAMES[1] + 2),), name="mvsec_3e")


def phase_transformers(device: torch.device, tmp: str) -> dict:
    """GMFlow and FlowFormer through the port's CLIs: the golden checkpoints
    through ``test_hrem`` at 720x1280 on the host path and with
    ``--device_voxelize`` (K1), each run's launch counts set to 0 just
    before it and read just after; the card against the CPU at 256x256 B=1
    on seeded weights (GMFlow one-scale, two-scale with its K2 launch,
    FlowFormer at decoder depth 3 with its gate nonzero); ``train_mvsec``
    with each model's own config at its batch in bf16 (host grids) and
    float32 (``--device_voxelize``); one float32 train step on the card
    against the CPU at 128x128 B=2; 20 steps on one batch lowering its loss
    in bf16 and float32.  Draws from a generator of its own.  Returns the
    K1 calls and K2 launches of its runs."""
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model
    from eemflow_tpu_torch.tools.test_hrem import main as test_hrem
    from eemflow_tpu_torch.tools.train_mvsec import main as train_mvsec

    phase("3e transformers: GMFlow and FlowFormer: goldens (HREM 720x1280), the card against the CPU, train_mvsec "
          "with their configs")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(16)
    fixtures = os.path.join(REPO, "tests", "fixtures")
    hrem_root = hrem_split(tmp)
    calls = {"voxel_scatter": 0, "local_corr": 0}
    others = ("fused_convs_pool", "coarse_head", "update_block")
    for name in TRANSFORMERS:
        ckpt, golden_json = TRANSFORMER_GOLDENS[name]
        with open(os.path.join(fixtures, golden_json)) as f:
            golden = json.load(f)
        aee = {}
        for label, extra, k1 in (("host voxelize", [], 0), ("device voxelize", ["--device_voxelize"], 2)):
            reset_launch_counts()
            t0 = time.perf_counter()
            res = test_hrem(["-model", name, "-int", "dt1", "--checkpoint", os.path.join(fixtures, ckpt),
                             "--max_samples", str(golden["max_samples"]), "--device", str(device), "--data_root",
                             hrem_root, "--save_dir", os.path.join(tmp, "out_transformers"), *extra])
            aee[label] = res["mean"]["AEE"]
            counts = dict(launch_counts)
            say(f"{name} golden (HREM 720x1280), {label}: AEE {aee[label]:.7f} in {time.perf_counter() - t0:.1f} s; "
                f"launches {counts}")
            require(counts["voxel_scatter"] == k1 and counts["local_corr"] == 0 and all(counts[k] == 0 for k in others),
                    f"{name} {label}: launches {counts}, not K1 {k1} and no other kernel")
            calls["voxel_scatter"] += counts["voxel_scatter"]
        host, dev = aee["host voxelize"], aee["device voxelize"]
        say(f"{name}: golden AEE {golden['aee']:.7f}, host path |Δ| {abs(host - golden['aee']):.3e} (tolerance "
            f"{GOLDEN_TOL:g}); device voxelize vs host path |Δ| {abs(dev - host):.3e} (tolerance "
            f"{TRANSFORMER_PATH_TOL:g})")
        require(abs(host - golden["aee"]) < GOLDEN_TOL and abs(dev - host) <= TRANSFORMER_PATH_TOL,
                f"{name}: the golden AEE drifted or the device path differs from the host path")

    # the card against the CPU at 256x256 B=1, seeded weights
    for label, name, fields, k2 in TRANSFORMER_FORWARDS:
        model = transformer_seeded(get_eval_model(name, **fields), rng, GMFLOW_SOFT if name == "gmflow" else 1.0)
        ev1, ev2 = (torch.from_numpy(rng.standard_normal((1, MVSEC_CROP, MVSEC_CROP, BINS)).astype(np.float32))
                    for _ in range(2))
        with torch.inference_mode():
            ref = model(ev1, ev2)[1]
            model.to(device)
            reset_launch_counts()
            got = model(ev1.to(device), ev2.to(device))[1].cpu()
            counts = dict(launch_counts)
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max())
        say(f"{label} forward 256x256 B=1 (every prediction), card vs CPU: max|Δ| {err:.3e} (tolerance "
            f"{FORWARD_TOL:g}·{scale:.3f}); largest flow {float(ref.abs().max()):.3f}; K2 launches {counts['local_corr']}")
        require(bool(torch.isfinite(got).all()) and err <= FORWARD_TOL * scale and counts["local_corr"] == k2,
                f"{label}: the forward on the card disagrees with the CPU or did not launch K2 {k2} times")
        calls["local_corr"] += counts["local_corr"]
        del model

    # train_mvsec with each model's own config at its batch
    mvsec = mvsec_3e_split(tmp)
    with mvsec_train_frames(MVSEC_3E_FRAMES):
        for name in TRANSFORMERS:
            config, bs = f"mvsec_{name}.json", TRANSFORMER_BATCH[name]
            for label, mp, extra, k1_step in ZOO_TRAIN_PATHS:
                save = os.path.join(tmp, f"transformer_train_{name}_{int(mp)}")
                reset_launch_counts()
                t0 = time.perf_counter()
                state = train_mvsec([
                    "-model", name, "--config", train_config(tmp, mp, config), "--data_root", mvsec, "--sequence",
                    MVSEC_TRAIN_SEQUENCE, "-bs", str(bs), "--train_iters", str(MVSEC_TRAIN_STEPS),
                    "--val_iters", str(MVSEC_TRAIN_STEPS // 2), "--save_dir", save, "--device", str(device), *extra,
                ])
                counts = dict(launch_counts)
                run = os.path.join(save, os.listdir(save)[0])
                recs = [r for r in read_jsonl(os.path.join(run, "metrics.jsonl")) if r["kind"] == "epoch"]
                say(f"train_mvsec {name} {label}, B={bs}: {MVSEC_TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s"
                    f"; epochs {[(r['epoch'], r['n_steps'], r['mean_loss']) for r in recs]}; launches {counts}")
                require(state.step == MVSEC_TRAIN_STEPS and len(recs) == 2
                        and all(np.isfinite(r["mean_loss"]) for r in recs)
                        and all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
                        f"{name} {label}: the run did not take its steps with finite losses")
                require(counts["voxel_scatter"] == k1_step * MVSEC_TRAIN_STEPS and counts["local_corr"] == 0
                        and all(counts[k] == 0 for k in others),
                        f"{name} {label}: launches {counts}, not K1 {k1_step} a step and no other kernel")
                calls["voxel_scatter"] += counts["voxel_scatter"]
                del state
            transformer_step_card_vs_cpu(device, name, rng)
            mvsec_steps_lower_the_loss(device, mvsec, name, config, [], TRANSFORMER_LR, batch=bs,
                                       frames=MVSEC_3E_FRAMES)
            torch.cuda.empty_cache()
    say(f"phase 3e took {time.perf_counter() - t_phase:.1f} s; its K1 calls and K2 launches {calls}")
    return calls


# the instance-norm encoders: their float32 weight gradients sum terms that
# cancel to ~1e-3 of their size, and cuDNN (PyTorch's instance norm runs its
# normalisation there) computes them less exactly than the CPU: against the
# CPU's float64 step GMFlow's backbone leaves lie 1.3e-2 of the model's
# largest |g| on an H100 with cuDNN (the strided 1x1 shortcut's weight),
# ~7e-4 with cuDNN off and on the CPU in float32 (this step's line prints
# all three).  So each side's float32 step is held against a float64 step
# on the CPU: these leaves within ENCODER_GRAD_TOL of the model's largest
# |g|, every other within TRAIN_GRAD_TOL, the whole gradient within
# WHOLE_GRAD_TOL relative L2 (GMFlow's card 4.9e-3)
TRANSFORMER_ENCODERS = ("backbone.", "context_encoder.", "memory_encoder.feat_encoder.")
ENCODER_GRAD_TOL = 2e-2
WHOLE_GRAD_TOL = 1e-2


def transformer_step_card_vs_cpu(device: torch.device, name: str, rng) -> None:
    """One float32 train step of ``name`` (FlowFormer at decoder depth 3;
    device voxelize with flips, forward, loss, backward, clip, AdamW) from
    the same seeded parameters and batch at 128x128, B=2, on the card and on
    the CPU, and the step's gradient on the CPU in float64 from the card's
    voxel grids: the card's loss against the CPU's, its gradients against
    the float64 ones (see ``TRANSFORMER_ENCODERS``; the card's without
    cuDNN and the CPU's float32 distances printed beside them)."""
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.models.registry import get_model
    from eemflow_tpu_torch.train.loss import sequence_loss
    from eemflow_tpu_torch.train.optim import make_optimizer
    from eemflow_tpu_torch.train.trainer import create_train_state

    fields = {"decoder_depth": 3} if name == "flowformer" else {}
    h, w, B, N = 128, 128, 2, 4096
    params = transformer_seeded(get_model(name, **fields), rng, GMFLOW_SOFT if name == "gmflow" else 1.0).state_dict()
    ev, nv = k1_batch(rng, (N, N - 100, N - 7, N), N=N, h=h, w=w)
    batch = {
        "events_old": ev[:B], "events_new": ev[B:], "n_old": nv[:B], "n_new": nv[B:],
        "flip_h": np.array([True, False]), "flip_v": np.array([False, True]),
        "flow": (rng.standard_normal((B, h, w, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, h, w), np.float32),
    }
    runs = step_on_cpu_and_card(
        device, lambda dev: create_train_state(get_model(name, **fields), 0, make_optimizer(1e-4, num_steps=100),
                                               params=params, device=dev), batch, BINS, h, w)
    (loss_cpu, g_cpu, n_cpu), (loss_gpu, g_gpu, n_gpu) = runs["cpu"], runs["card"]

    # the step's gradient in float64 on the CPU from the card's voxel grids
    # (K1 sums a cell's votes in another order than the CPU's plain version)
    with torch.no_grad():
        grids = make_device_preprocess(BINS, h, w)({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    model = get_model(name, **fields)
    model.load_state_dict(params)
    model.double().train()
    cast = {k: v.cpu().double() if v.is_floating_point() else v.cpu() for k, v in grids.items()}
    _, preds = model(cast["event_volume_old"], cast["event_volume_new"], train=True)
    sequence_loss(preds, cast["flow"], cast["valid"])[0].backward()
    g64 = {n: p.grad.detach() for n, p in model.named_parameters()}

    def dist(g):
        top = max(float(r.abs().max()) for r in g64.values())
        worst = {enc: max((float((g[n].double() - r).abs().max()) for n, r in g64.items()
                           if n.startswith(TRANSFORMER_ENCODERS) == enc), default=0.0) / top for enc in (True, False)}
        whole = float(torch.cat([(g[n].double() - r).flatten() for n, r in g64.items()]).norm()
                      / torch.cat([r.flatten() for r in g64.values()]).norm())
        return worst[True], worst[False], whole

    # the card again without cuDNN (the native convolutions and norms), for
    # the report: where the card's float32 error comes from
    torch.backends.cudnn.enabled = False
    try:
        model = get_model(name, **fields)
        model.load_state_dict(params)
        model.to(device).train()
        _, preds = model(grids["event_volume_old"], grids["event_volume_new"], train=True)
        sequence_loss(preds, grids["flow"], grids["valid"])[0].backward()
        g_native = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.enabled = True
    card, cpu, native = dist(g_gpu), dist(g_cpu), dist(g_native)
    say(f"{name}: one float32 train step at {h}x{w} B={B}, card (K1 calls, K2 launches {n_gpu}) vs CPU ({n_cpu}): "
        f"loss {loss_gpu:.7f} vs {loss_cpu:.7f} (|Δ| relative {abs(loss_gpu - loss_cpu) / loss_cpu:.3e}, tolerance "
        f"{TRAIN_LOSS_RTOL:g}); grads against the float64 step on the CPU from the card's voxel grids, in units "
        f"of its largest |g|: the card's encoder "
        f"leaves {card[0]:.3e} (tolerance {ENCODER_GRAD_TOL:g}), the rest {card[1]:.3e} (tolerance {TRAIN_GRAD_TOL:g}), "
        f"the whole gradient {card[2]:.3e} relative L2 (tolerance {WHOLE_GRAD_TOL:g}); the card without cuDNN "
        f"{native[0]:.3e}, {native[1]:.3e}, {native[2]:.3e}; the CPU's float32 {cpu[0]:.3e}, {cpu[1]:.3e}, {cpu[2]:.3e}")
    require(n_gpu == (2, 0) and n_cpu == (0, 0), f"{name}: the card's train step did not run K1 twice")
    require(np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)
            and card[0] <= ENCODER_GRAD_TOL and card[1] <= TRAIN_GRAD_TOL and card[2] <= WHOLE_GRAD_TOL,
            f"{name}: the train step on the card disagrees with the CPU's float64 step")


def times_transformers(device, tmp: str) -> dict:
    """Phase 4 for GMFlow and FlowFormer: each model's 720x1280 B=1 eval
    forward (golden weights) and 256x256 B=1 forward, back to back (CUDA
    events), the device's busy time in one profiled run, the first kernels
    by device time and the peak memory; each model's MVSEC train step at its
    config's batch (host grids) in bf16 and float32: ms back to back, busy
    share, peak memory."""
    from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
    from eemflow_tpu_torch.models.registry import get_eval_model

    fixtures = os.path.join(REPO, "tests", "fixtures")
    out = {}
    for name in TRANSFORMERS:
        for h, w in ((H, W), (MVSEC_CROP, MVSEC_CROP)):
            model = get_eval_model(name)
            load_model_checkpoint(model, os.path.join(fixtures, TRANSFORMER_GOLDENS[name][0]), name, log=say)
            model.to(device)
            x1, x2 = (torch.randn(1, h, w, BINS, device=device) for _ in range(2))

            def forward(m=model):
                with torch.inference_mode():
                    return m(x1, x2)[1][-1]

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            flow = forward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
            require(tuple(flow.shape) == (1, h, w, 2) and bool(torch.isfinite(flow).all()),
                    f"the {h}x{w} {name} forward is not finite or has the wrong shape")
            b2b = cuda_ms(forward, reps=3 if h == H else 10, warmup=1)
            prof = profiled_step(forward, reps=1, tmp=tmp)
            _, line = top_kernels(forward, 5)
            say(f"{name} forward {h}x{w} B=1: {b2b:.3f} ms back to back ({1e3 / b2b:.1f} fps); the device busy "
                f"{prof['busy_ms']:.3f} ms of {prof['profiled_ms']:.3f} ms a profiled call "
                f"({100 * prof['busy_share']:.1f}%, {prof['device_ops']:.0f} kernels and copies); peak allocated "
                f"{peak / 2**30:.3f} GiB; first kernels by device time {line}")
            out[f"{name}_{h}x{w}"] = {"ms": b2b, "peak_gib": peak / 2**30, **prof}
            del model, forward
            torch.cuda.empty_cache()

    root = os.path.join(tmp, "mvsec_3e")
    for name in TRANSFORMERS:
        bs = TRANSFORMER_BATCH[name]
        data = mvsec_train_batch(root, device, f"mvsec_{name}.json", raw=False, batch=bs, frames=MVSEC_3E_FRAMES)
        for label, mp in (("bf16", True), ("float32", False)):
            state = mvsec_train_state(device, name, TRANSFORMER_LR)
            step = mvsec_step(name, mp)
            run = lambda: step(state, data)
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
            b2b = cuda_ms(run, reps=3, warmup=1)
            prof = profiled_step(run, reps=1, tmp=tmp)
            say(f"train step {name} 256x256 B={bs} host grids (its config), {label}: {b2b:.3f} ms back to back "
                f"({bs * 1e3 / b2b:.1f} samples/s); under torch.profiler {prof['profiled_ms']:.3f} ms a step, the "
                f"device busy {prof['busy_ms']:.3f} ms of it ({100 * prof['busy_share']:.1f}%, "
                f"{prof['device_ops']:.0f} kernels and copies); peak allocated {peak / 2**30:.3f} GiB")
            out[f"train_{name}_{label}"] = {"ms": b2b, "peak_gib": peak / 2**30, **prof}
            del state, step, run
            torch.cuda.empty_cache()
    return out


# The IRR-PWC and FlowNet line (phase 3f): the two golden checkpoints on the
# JAX package's golden MVSEC sequence (seed 55, dt1 dense, one sample), each
# on the host path and with --device_voxelize; all 15 names at 256x256 B=1
# on seeded weights, the card against the CPU; test_hrem at 720x1280 for
# five of them on seeded weights; train_mvsec with the JAX CLI's default
# config (configs/mvsec_event_flow_dense.json: B=8, bf16) on phase 3e's
# eight-sample MVSEC train sequence
PWC_LINE = ("irrpwc", "irrpwc_occ", "pwcnet", "pwcnet_bi", "pwcnet_occ", "pwcnet_occ_bi", "pwcnet_irr_bi",
            "pwcnet_irr_occ", "pwcnet_irr_occ_bi", "flownet1s", "flownet1s_irr", "flownet1s_irr_bi",
            "flownet1s_irr_occ", "flownet1s_irr_occ_bi", "irr_flownet")
# K2 launches a forward: one a direction and level of the 5 PWC levels; none
# in the FlowNet nets, which have no correlation
PWC_K2 = {name: 0 if "flownet" in name else 10 if name == "irrpwc_occ" or name.endswith("_bi") else 5
          for name in PWC_LINE}
PWC_GOLDENS = {"irrpwc": ("irrpwc_mvsec_golden.pth.tar", "mvsec_golden_irrpwc.json"),
               "pwcnet_irr_occ_bi": ("pwcnet_irr_occ_bi_mvsec_golden.pth.tar", "mvsec_golden_pwcnet_irr_occ_bi.json")}
PWC_HREM = ("irrpwc", "irrpwc_occ", "pwcnet_irr_occ_bi", "flownet1s", "irr_flownet")
PWC_TRAIN = ("irrpwc", "pwcnet_irr_occ_bi", "flownet1s", "irr_flownet")
PWC_STEP = ("irrpwc", "irr_flownet")
# the type of the card-vs-CPU step (``pwc_step_card_vs_cpu``): IRR-FlowNet's
# float32 step is not a function of its inputs to 1e-3 of the largest |g|.
# The CPU's float32 step against itself, each grid cell moved by one float32
# rounding step, moves by up to 1.944e-3 (``refine_flow.kernel.convs.4.0.
# weight``); on the card the same draws gave 1.7e-6, 2.1e-4 and 1.644e-3 in
# three runs of one call, PR 17's tree failing as well.  In float64 one
# rounding step moves it by under 1e-15: the check holds the card's float64
# step there
PWC_STEP_DTYPE = {"irrpwc": torch.float32, "irr_flownet": torch.float64}
PWC_CONFIG = "mvsec_event_flow_dense.json"  # the MVSEC training CLI's default
PWC_BATCH = 8  # its batch_size
PWC_PATH_TOL = 1e-4
# the card against the CPU, an occlusion map relative to max(1, its largest
# |value|): IRR-PWC-Occ's and IRR-FlowNet's occlusion upsamplers read the
# input warped at full resolution by the flow, so the flow's float32
# difference (~8e-4 px of flows up to 130 px) moves the warped white-noise
# grid by ~1e-3: IRR-FlowNet's maps 5.9e-5 to 1.2e-4 of it over two runs,
# IRR-PWC-Occ's 6.2e-5, the others' at most 1.4e-5 (H100 80GB HBM3, 700 W)
PWC_OCC_TOL = 1e-3
PWC_LR = 1e-4  # the 20-step loss check
# IRR-FlowNet's loss reaches its FlowNet core only through the warps'
# coordinates: its refinement takes the core's flow detached, as JAX stops
# its gradient, so its gradient leaves out the path through the flow it
# refines and its steps need not lower its loss.  JAX's own 20 steps (CPU,
# 64x96 B=2, dense grids, lr 2e-4 over a 100-step OneCycle) go 35.63 →
# 18.85 → 70.86 at one draw and 32.45 → 21.73 at another, the port's first
# steps following them; the port's (the same schedule, B=8, the MVSEC
# batch, on the CPU) 21.00 → 15.96 and 8.10 → 14.62 at two draws; on an
# H100 80GB HBM3 (700 W) at that schedule float32 31.25 → 24.82 (step 15)
# → 31.99, and at this lr 31.25 → 30.70, → 31.42 and → 31.05 in three runs.
# Its 20 steps are held to finite gradients, losses and parameters only;
# the others' loss must fall.
PWC_NO_DESCENT = ("irr_flownet",)


def pwc_seeded(model, rng):
    """Draw the model's conv and transposed-conv weights from ``rng``,
    normal with variance 2/fan_in (He, as flax initialises the JAX model;
    a stride-2 transposed conv's fan-in a quarter of Cin·kh·kw), biases
    N(0, 0.01²).  Returns the model."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel() if isinstance(m, torch.nn.Conv2d) else m.weight.shape[0] * 4
                m.weight.copy_(torch.from_numpy(rng.standard_normal(m.weight.shape) * np.sqrt(2.0 / fan_in)))
                if m.bias is not None:
                    m.bias.copy_(torch.from_numpy(rng.standard_normal(m.bias.shape) * 0.01))
    return model


def pwc_outputs(model, ev1, ev2):
    """(predictions stacked, occlusion maps) of one forward, on the CPU."""
    maps, preds = model(ev1, ev2)
    occ = [m.float().cpu() for m in maps if m is not None and m.shape[-1] == 1]
    return torch.stack([p.float().cpu() for p in preds]), occ


def phase_pwc(device: torch.device, tmp: str) -> dict:
    """The IRR-PWC and FlowNet line through the port's CLIs: the golden
    checkpoints through ``test_mvsec`` on the host path and with
    ``--device_voxelize`` (K1), with K2's launches; the 15 names at 256x256
    B=1 on seeded weights, the card against the CPU, every prediction and
    occlusion map; ``test_hrem`` at 720x1280 for five of them on seeded
    weights, host path against ``--device_voxelize``; ``train_mvsec`` with
    the default config at B=8 for four of them in bf16 (host grids) and
    float32 (``--device_voxelize``), each run's launch counts set to 0 just
    before it and read just after; on sparse event grids, finite gradients
    and 20 steps on one batch lowering its loss in bf16 and float32; one
    train step at 128x128 B=2 on the card against the CPU for ``irrpwc``
    (float32) and ``irr_flownet`` (float64).  Draws from a generator of its
    own.
    Returns the K1 calls and K2 launches of its runs."""
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model
    from eemflow_tpu_torch.tools.test_hrem import main as test_hrem
    from eemflow_tpu_torch.tools.test_mvsec import main as test_mvsec
    from eemflow_tpu_torch.tools.train_mvsec import main as train_mvsec

    phase("3f IRR-PWC and FlowNet: goldens (MVSEC dt1 dense), the 15 names card vs CPU, test_hrem at 720x1280, "
          "train_mvsec with the default config")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    fixtures = os.path.join(REPO, "tests", "fixtures")
    calls = {"voxel_scatter": 0, "local_corr": 0}
    others = ("fused_convs_pool", "coarse_head", "update_block")

    def counted(label, k1, k2):
        counts = dict(launch_counts)
        require(counts["voxel_scatter"] == k1 and counts["local_corr"] == k2 and all(counts[k] == 0 for k in others),
                f"{label}: launches {counts}, not K1 {k1}, K2 {k2} and no other kernel")
        calls["voxel_scatter"] += counts["voxel_scatter"]
        calls["local_corr"] += counts["local_corr"]
        return counts

    golden_root = golden_mvsec_split(tmp)
    for name, (ckpt, golden_json) in PWC_GOLDENS.items():
        with open(os.path.join(fixtures, golden_json)) as f:
            golden = json.load(f)
        aee = {}
        for label, extra, k1 in (("host voxelize", [], 0), ("device voxelize", ["--device_voxelize"], 2)):
            reset_launch_counts()
            t0 = time.perf_counter()
            res = test_mvsec(["-model", name, "-int", golden["dt"], "--checkpoint", os.path.join(fixtures, ckpt),
                              "--max_samples", str(golden["max_samples"]), "--device", str(device), "--sequence",
                              "indoor_flying1", "--eval_type", "dense", "--data_root", golden_root, "--frames", "3",
                              "9", "--stride", "1", "--save_dir", os.path.join(tmp, "out_pwc"), *extra])
            aee[label] = res["AEE"]
            counts = counted(f"{name} golden {label}", k1, PWC_K2[name])
            say(f"{name} golden (MVSEC dt1 dense), {label}: AEE {aee[label]:.7f} in {time.perf_counter() - t0:.1f} "
                f"s; launches {counts}")
        host, dev = aee["host voxelize"], aee["device voxelize"]
        say(f"{name}: golden AEE {golden['aee']:.7f}, host path |Δ| {abs(host - golden['aee']):.3e} (tolerance "
            f"{GOLDEN_TOL:g}); device voxelize vs host path |Δ| {abs(dev - host):.3e} (tolerance {PWC_PATH_TOL:g})")
        require(abs(host - golden["aee"]) < GOLDEN_TOL and abs(dev - host) <= PWC_PATH_TOL,
                f"{name}: the golden AEE drifted or the device path differs from the host path")

    # the 15 names at 256x256 B=1, seeded weights, the card against the CPU
    for name in PWC_LINE:
        model = pwc_seeded(get_eval_model(name), rng)
        ev1, ev2 = (torch.from_numpy(rng.standard_normal((1, MVSEC_CROP, MVSEC_CROP, BINS)).astype(np.float32))
                    for _ in range(2))
        with torch.inference_mode():
            ref, ref_occ = pwc_outputs(model, ev1, ev2)
            model.to(device)
            reset_launch_counts()
            got, got_occ = pwc_outputs(model, ev1.to(device), ev2.to(device))
            counted(f"{name} forward", 0, PWC_K2[name])
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max())
        occ_err = [float((g - r).abs().max()) / max(1.0, float(r.abs().max())) for g, r in zip(got_occ, ref_occ)]
        say(f"{name} forward 256x256 B=1 ({len(ref)} predictions, {len(ref_occ)} occlusion maps), card vs CPU: max|Δ| "
            f"{err:.3e} (tolerance {FORWARD_TOL:g}·{scale:.3f}); occlusion maps {[f'{e:.2e}' for e in occ_err]} of "
            f"max(1, |map|) (tolerance {PWC_OCC_TOL:g}); K2 launches {PWC_K2[name]}")
        require(bool(torch.isfinite(got).all()) and err <= FORWARD_TOL * scale and len(got_occ) == len(ref_occ)
                and all(e <= PWC_OCC_TOL for e in occ_err), f"{name}: the forward on the card disagrees with the CPU")
        del model

    # test_hrem at 720x1280, seeded weights: host path against device voxelize
    hrem_root = hrem_split(tmp)
    for name in PWC_HREM:
        ckpt = os.path.join(tmp, f"{name}_seeded.pth.tar")
        torch.save({"state_dict": pwc_seeded(get_eval_model(name), rng).state_dict()}, ckpt)
        aee = {}
        for label, extra, k1 in (("host voxelize", [], 0), ("device voxelize", ["--device_voxelize"], 2)):
            reset_launch_counts()
            t0 = time.perf_counter()
            res = test_hrem(["-model", name, "-int", "dt1", "--checkpoint", ckpt, "--max_samples", "1", "--device",
                             str(device), "--data_root", hrem_root, "--save_dir", os.path.join(tmp, "out_pwc"), *extra])
            aee[label] = res["mean"]["AEE"]
            counts = counted(f"{name} test_hrem {label}", k1, PWC_K2[name])
            say(f"{name} test_hrem 720x1280 (seeded weights), {label}: AEE {aee[label]:.7f} in "
                f"{time.perf_counter() - t0:.1f} s; launches {counts}")
        host, dev = aee["host voxelize"], aee["device voxelize"]
        require(np.isfinite(host) and abs(dev - host) <= PWC_PATH_TOL * max(1.0, host),
                f"{name}: test_hrem's device path differs from its host path ({dev} vs {host})")
        os.remove(ckpt)

    # train_mvsec with the default config at B=8, then 20 steps on one batch
    mvsec = mvsec_3e_split(tmp)
    with mvsec_train_frames(MVSEC_3E_FRAMES):
        for name in PWC_TRAIN:
            for label, mp, extra, k1_step in ZOO_TRAIN_PATHS:
                save = os.path.join(tmp, f"pwc_train_{name}_{int(mp)}")
                reset_launch_counts()
                t0 = time.perf_counter()
                state = train_mvsec([
                    "-model", name, "--config", train_config(tmp, mp, PWC_CONFIG), "--data_root", mvsec,
                    "--sequence", MVSEC_TRAIN_SEQUENCE, "-bs", str(PWC_BATCH), "--train_iters",
                    str(MVSEC_TRAIN_STEPS), "--val_iters", str(MVSEC_TRAIN_STEPS // 2), "--save_dir", save,
                    "--device", str(device), *extra,
                ])
                counts = counted(f"train_mvsec {name} {label}", k1_step * MVSEC_TRAIN_STEPS,
                                 PWC_K2[name] * MVSEC_TRAIN_STEPS)
                run = os.path.join(save, os.listdir(save)[0])
                recs = [r for r in read_jsonl(os.path.join(run, "metrics.jsonl")) if r["kind"] == "epoch"]
                say(f"train_mvsec {name} {label} (the default config), B={PWC_BATCH}: {MVSEC_TRAIN_STEPS} steps in "
                    f"{time.perf_counter() - t0:.1f} s; epochs {[(r['epoch'], r['n_steps'], r['mean_loss']) for r in recs]}"
                    f"; launches {counts}")
                require(state.step == MVSEC_TRAIN_STEPS and len(recs) == 2
                        and all(np.isfinite(r["mean_loss"]) for r in recs)
                        and all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
                        f"{name} {label}: the run did not take its steps with finite losses")
                del state
            pwc_steps_lower_the_loss(device, mvsec, name, rng)
            torch.cuda.empty_cache()
    for name in PWC_STEP:
        pwc_step_card_vs_cpu(device, name, rng)
    say(f"phase 3f took {time.perf_counter() - t_phase:.1f} s; its K1 calls and K2 launches {calls}")
    return calls


def pwc_steps_lower_the_loss(device, root: str, name: str, rng) -> None:
    """20 steps on one fixed MVSEC batch of host grids (B=8, the default
    config's augmentation) from seeded weights (``pwc_seeded``: He, as
    flax initialises the JAX model), in bf16 and float32: every gradient of
    the first step finite (the grids are zero at most pixels, where
    ‖diff‖₂'s gradient is 0 in the port), every loss and parameter finite,
    and the loss lowered but for ``PWC_NO_DESCENT``'s."""
    from eemflow_tpu_torch.models.registry import get_model
    from eemflow_tpu_torch.train.optim import make_optimizer
    from eemflow_tpu_torch.train.trainer import create_train_state

    data = mvsec_train_batch(root, device, PWC_CONFIG, raw=False, batch=PWC_BATCH, frames=MVSEC_3E_FRAMES)
    zero = float((data["event_volume_old"] == 0).all(dim=-1).float().mean())
    params = pwc_seeded(get_model(name), rng).state_dict()
    for label, mp in (("bf16", True), ("float32", False)):
        state = create_train_state(get_model(name), 0, make_optimizer(PWC_LR, num_steps=1000), params=params,
                                   device=device)
        step = mvsec_step(name, mp)
        finite = []
        opt_step = state.opt.step

        def checking_step(state=state, opt_step=opt_step, finite=finite):
            if not finite:
                finite.append(all(bool(torch.isfinite(p.grad).all()) for p in state.model.parameters()
                                  if p.grad is not None))
            return opt_step()

        state.opt.step = checking_step
        losses = [float(step(state, data)[1]["loss"]) for _ in range(20)]
        say(f"20 {label} MVSEC {name} steps (lr {PWC_LR:g}) on one 256x256 B={PWC_BATCH} batch (grids zero at "
            f"{100 * zero:.1f}% of their pixels): first step's gradients finite {finite[0]}; loss {losses[0]:.6f} → "
            f"{losses[-1]:.6f} (every 5th: {[round(x, 6) for x in losses[::5]]})")
        lowered = losses[-1] < losses[0] or name in PWC_NO_DESCENT
        require(finite[0] and all(np.isfinite(losses)) and lowered
                and all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
                f"20 {label} MVSEC {name} steps on one batch did not keep finite gradients and lower its loss")


def pwc_step_card_vs_cpu(device: torch.device, name: str, rng) -> None:
    """One float32 train step of ``name`` (forward, loss, backward, clip,
    AdamW) from the same seeded parameters at 128x128, B=2, on the card and
    on the CPU (PyTorch's own CPU convolutions: oneDNN's transposed-conv
    backward is less exact, ``tests/test_torch_train_irrpwc.py``), both from
    the grids the card's K1 makes of one raw-event batch with flips: the
    loss and every gradient in units of the model's largest |g| (phase 3b's
    ERAFT rule), and the whole gradient, in ``PWC_STEP_DTYPE[name]`` (the
    parameters and grids cast).  The same grids on both sides,
    because IRR-FlowNet's decoders take their whole gradient through the
    bilinear warps' coordinate derivatives (its refinement takes their flow
    detached), which jump where a sample crosses a pixel: K1's atomics move
    a cell by ~1e-7 from run to run, and with each side voxelizing its own
    the same draws put the worst leaf 2.1e-4 and 1.6e-3 of the largest |g|
    from the CPU's in two runs on an H100 80GB HBM3."""
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.models.registry import get_model
    from eemflow_tpu_torch.train.optim import make_optimizer
    from eemflow_tpu_torch.train.trainer import create_train_state, make_train_step

    h, w, B, N = 128, 128, 2, 4096
    dtype = PWC_STEP_DTYPE[name]
    params = {k: v.to(dtype) if v.is_floating_point() else v for k, v in pwc_seeded(get_model(name), rng).state_dict().items()}
    ev, nv = k1_batch(rng, (N, N - 100, N - 7, N), N=N, h=h, w=w)
    raw = {
        "events_old": ev[:B], "events_new": ev[B:], "n_old": nv[:B], "n_new": nv[B:],
        "flip_h": np.array([True, False]), "flip_v": np.array([False, True]),
        "flow": (rng.standard_normal((B, h, w, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, h, w), np.float32),
    }
    before = dict(launch_counts)
    with torch.no_grad():
        grids = make_device_preprocess(BINS, h, w)({k: torch.from_numpy(v).to(device) for k, v in raw.items()})
    runs = {}
    for key, dev in (("cpu", torch.device("cpu")), ("card", device)):
        state = create_train_state(get_model(name).to(dtype), 0, make_optimizer(1e-4, num_steps=100), params=params,
                                   device=dev)
        grads = {}
        opt_step = state.opt.step

        def step_recording_grads(state=state, grads=grads, opt_step=opt_step):
            # a parameter the loss does not reach has no .grad (the optimizer
            # gives it zeros)
            grads.update({n: torch.zeros(p.shape) if p.grad is None else p.grad.detach().cpu().clone()
                          for n, p in state.model.named_parameters()})
            return opt_step()

        state.opt.step = step_recording_grads
        with torch.backends.mkldnn.flags(enabled=False):
            _, metrics = make_train_step()(state, {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                                                   for k, v in grids.items()})
        runs[key] = (float(metrics["loss"]), grads)
    launches = (launch_counts["voxel_scatter"] - before["voxel_scatter"],
                launch_counts["local_corr"] - before["local_corr"])
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = runs["cpu"], runs["card"]
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst, leaf = max((float((g_gpu[n] - g).abs().max()) / top, n) for n, g in g_cpu.items())
    whole = float(torch.cat([(g_gpu[n] - g).flatten() for n, g in g_cpu.items()]).norm()
                  / torch.cat([g.flatten() for g in g_cpu.values()]).norm())
    say(f"{name}: one {str(dtype)[6:]} train step at {h}x{w} B={B} from the card's grids (K1 calls, K2 launches "
        f"{launches}), "
        f"card vs CPU: loss {loss_gpu:.7f} vs {loss_cpu:.7f} (|Δ| relative {abs(loss_gpu - loss_cpu) / loss_cpu:.3e}, "
        f"tolerance {TRAIN_LOSS_RTOL:g}); grads: the worst parameter's max|Δ| is {worst:.3e} of the model's largest "
        f"|g| ({leaf}; tolerance {TRAIN_GRAD_TOL:g}); the whole gradient {whole:.3e} relative L2")
    require(launches == (2, PWC_K2[name]), f"{name}: the card's step did not run K1 twice and K2 {PWC_K2[name]} times")
    require(np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)
            and worst <= TRAIN_GRAD_TOL and whole <= TRAIN_GRAD_TOL,
            f"{name}: the train step on the card disagrees with the CPU")


# phase 4: the line's 720x1280 forwards timed, and its MVSEC train steps
PWC_TIMED = ("irrpwc", "pwcnet_irr_occ_bi", "flownet1s", "irr_flownet")
PWC_TIMED_TRAIN = ("irrpwc", "flownet1s")


def times_pwc(device, tmp: str) -> dict:
    """Phase 4 for the IRR-PWC and FlowNet line: the 720x1280 B=1 eval
    forward of four of its nets (seeded weights) back to back (CUDA events),
    the device's busy share of one profiled run, the peak memory, the first
    kernels by device time and K2's share of the device time; the MVSEC
    train step at the default config's B=8 (host grids) of ``irrpwc`` and
    ``flownet1s`` in bf16 and float32: ms back to back, busy share, device
    ops, peak memory."""
    from eemflow_tpu_torch.models.registry import get_eval_model

    rng = np.random.default_rng(20)
    out = {}
    for name in PWC_TIMED:
        model = pwc_seeded(get_eval_model(name), rng).to(device)
        x1, x2 = (torch.randn(1, H, W, BINS, device=device) for _ in range(2))

        def forward(m=model):
            with torch.inference_mode():
                return m(x1, x2)[1][-1]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        flow = forward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        require(tuple(flow.shape) == (1, H, W, 2) and bool(torch.isfinite(flow).all()),
                f"the 720x1280 {name} forward is not finite or has the wrong shape")
        b2b = cuda_ms(forward, reps=5, warmup=1)
        prof = profiled_step(forward, reps=1, tmp=tmp)
        kernels = device_kernels(forward)
        summed = sum(ms for _, ms in kernels)
        k2_ms = sum(ms for k, ms in kernels if "local_corr" in k)
        by_name = {}
        for k, ms in kernels:
            t, c = by_name.get(k, (0.0, 0))
            by_name[k] = (t + ms, c + 1)
        line = "; ".join(f"{k[:80]} {t:.3f} ms ({c})" for k, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5])
        say(f"{name} forward 720x1280 B=1 (seeded weights): {b2b:.3f} ms back to back ({1e3 / b2b:.1f} fps); the device "
            f"busy {prof['busy_ms']:.3f} ms of {prof['profiled_ms']:.3f} ms a profiled call "
            f"({100 * prof['busy_share']:.1f}%, {prof['device_ops']:.0f} kernels and copies); peak allocated "
            f"{peak / 2**30:.3f} GiB; K2 {k2_ms:.3f} ms of {summed:.3f} ms summed device time "
            f"({100 * k2_ms / summed:.1f}%, {sum('local_corr' in k for k, _ in kernels)} launches); first kernels "
            f"by device time: {line}")
        out[f"{name}_720x1280"] = {"ms": b2b, "peak_gib": peak / 2**30, "k2_share": k2_ms / summed, **prof}
        del model, forward
        torch.cuda.empty_cache()

    root = mvsec_3e_split(tmp)
    data = mvsec_train_batch(root, device, PWC_CONFIG, raw=False, batch=PWC_BATCH, frames=MVSEC_3E_FRAMES)
    for name in PWC_TIMED_TRAIN:
        for label, mp in (("bf16", True), ("float32", False)):
            state = mvsec_train_state(device, name, PWC_LR)
            step = mvsec_step(name, mp)
            run = lambda: step(state, data)
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
            b2b = cuda_ms(run, reps=3, warmup=1)
            prof = profiled_step(run, reps=1, tmp=tmp)
            say(f"train step {name} 256x256 B={PWC_BATCH} host grids (the default config), {label}: {b2b:.3f} ms back "
                f"to back ({PWC_BATCH * 1e3 / b2b:.1f} samples/s); under torch.profiler {prof['profiled_ms']:.3f} ms a "
                f"step, the device busy {prof['busy_ms']:.3f} ms of it ({100 * prof['busy_share']:.1f}%, "
                f"{prof['device_ops']:.0f} kernels and copies); peak allocated {peak / 2**30:.3f} GiB")
            out[f"train_{name}_{label}"] = {"ms": b2b, "peak_gib": peak / 2**30, **prof}
            del state, step, run
            torch.cuda.empty_cache()
    return out


RESEARCH_HREM_MODES = ("save_flow", "low_epe", "warp", "density", "dsec_submission")
# K1 calls of a device-voxelize research run on one sample: two frames, and
# two more where the mode reads the input volumes (warp, density)
RESEARCH_K1 = {"warp": 4, "density": 4}
RESEARCH_TOL = 1e-5  # a mode's flow or AEE against the standard path's (the same function)
DSEC_TOL = 1 / 128  # the 16-bit code's step
EEMFLOW_OPTIONS = (("standard", {}), ("s2d_stem", {"s2d_stem": True}), ("stacked_coarse", {"stacked_coarse": True}),
                   ("s2d_stem + stacked_coarse", {"s2d_stem": True, "stacked_coarse": True}))
# time_eval --bf16 at 720x1280: (label, model, flags)
BF16_TIMED = (("EEMFlow", "eemflow", []), ("EEMFlow --fast", "eemflow", ["--fast"]),
              ("EEMFlow+", "eemflow_plus", []), ("ERAFT", "eraft", []))
SERVE_TOL_BF16 = 0.02  # the serving bf16 limit (PERF.md section 2), of the flow's L2


def png_shape(path: str) -> tuple:
    from eemflow_tpu_torch.viz.png import read_png

    return read_png(path).shape


def phase_research(device: torch.device, tmp: str) -> dict:
    """The research eval surface through the port's CLIs: on the seed-99
    HREM split at 720x1280 with the golden EEMFlow and ``--device_voxelize``,
    one sample each, ``test_hrem --mode`` save_flow, low_epe, warp, density
    and dsec_submission, and save_flow under ``--fast``, each run's launch
    counts set to 0 just before it and read just after (K1, K2; K3, K4 under
    ``--fast``), the ``.flo`` against the standard path's flow, the density
    mode's AEE against the standard AEE and the DSEC file decoded back; on
    phase 3c's MVSEC dt1 sequence ``test_mvsec --mode`` warp_loss and
    multi_key, the card against the CPU; EEMFlow's ``s2d_stem`` and
    ``stacked_coarse`` at 720x1280, B=1 and 2, golden weights, against the
    standard forward, back to back in time_eval's timing, K2 once a forward;
    ``time_eval --bf16`` for EEMFlow (standard and ``--fast``), EEMFlow+ and
    ERAFT; ``train_hrem --viz --device_voxelize`` (2 steps, pictures every
    step) and ``serve --viz`` on phase 3's stream, their PNGs decoded.
    Draws from a generator of its own.  Returns its runs' K1-K4 launches."""
    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.data.dsec import flow_16bit_to_float
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.data.hrem import HREMEventFlow
    from eemflow_tpu_torch.eval.runner import ResearchTester
    from eemflow_tpu_torch.events.io import read_flo
    from eemflow_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model
    from eemflow_tpu_torch.tools.serve import main as serve
    from eemflow_tpu_torch.tools.test_hrem import main as test_hrem
    from eemflow_tpu_torch.tools.test_mvsec import main as test_mvsec
    from eemflow_tpu_torch.tools.time_eval import main as time_eval
    from eemflow_tpu_torch.viz.flow_viz import flow_to_image
    from eemflow_tpu_torch.viz.png import read_png

    phase("3g research eval: test_hrem and test_mvsec --mode, EEMFlow's s2d_stem and stacked_coarse, time_eval "
          "--bf16, train_hrem and serve --viz")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(19)
    kernels = ("voxel_scatter", "local_corr", "fused_convs_pool", "coarse_head")
    calls = dict.fromkeys(kernels, 0)

    def counted(label, want):
        counts = dict(launch_counts)
        got = {k: counts[k] for k in kernels}
        require(got == {k: want.get(k, 0) for k in kernels} and counts["update_block"] == 0,
                f"{label}: launches {counts}, not {want}")
        for k in kernels:
            calls[k] += counts[k]
        return got

    # the standard path's flow and AEE on the split's first sample (one model build)
    root = hrem_split(tmp)
    sd = to_state_dict(load_torch_checkpoint(GOLDEN_CKPT))
    ds = HREMEventFlow(root, dt="dt1", raw_events=True)
    ds.change_test_sequence("indoor_fast")
    model = get_eval_model("eemflow")
    model.load_state_dict(sd)
    tester = ResearchTester(model, device, preprocess=make_device_preprocess(ds.num_bins, ds.image_height,
                                                                             ds.image_width))
    std_flow = tester.run_sample(ds[0])
    scale = max(1.0, float(np.abs(std_flow).max()))
    del tester, model
    out = os.path.join(tmp, "out_research")

    def hrem_args(save_dir, *extra):
        return ["-model", "eemflow", "-int", "dt1", "--data_root", root, "--checkpoint", GOLDEN_CKPT, "--max_samples",
                "1", "--save_dir", save_dir, "--device", str(device), "--device_voxelize", *extra]

    reset_launch_counts()
    std_aee = test_hrem(hrem_args(out))["indoor_fast"]["AEE"]
    counted("test_hrem standard", {"voxel_scatter": 2, "local_corr": 1})
    res = {}
    for mode in RESEARCH_HREM_MODES:
        reset_launch_counts()
        t0 = time.perf_counter()
        res[mode] = test_hrem(hrem_args(out, "--mode", mode))
        got = counted(f"test_hrem --mode {mode}", {"voxel_scatter": RESEARCH_K1.get(mode, 2), "local_corr": 1})
        say(f"test_hrem --mode {mode} --device_voxelize, 720x1280, one sample: {res[mode]} in "
            f"{time.perf_counter() - t0:.1f} s; launches {got}")
    mode_dir = os.path.join(out, "eemflow_dt1")
    flo = read_flo(os.path.join(mode_dir, "save_flow", "000000.flo"))
    flo_err = float(np.abs(flo - std_flow).max())
    density = [aee for aee, n in res["density"].values() if n]
    dsec_flow, valid = flow_16bit_to_float(read_png(os.path.join(mode_dir, "dsec_submission", "00000.png"))[..., ::-1])
    dsec_err = float(np.abs(dsec_flow - std_flow).max())
    pictures = {m: sorted(os.listdir(os.path.join(mode_dir, m))) for m in ("save_flow", "low_epe", "warp")}
    say(f"save_flow .flo vs the standard path's flow: max|Δ| {flo_err:.3e} (tolerance {RESEARCH_TOL:g}·{scale:.3f}); "
        f"density AEE {density} vs standard {std_aee:.7f} (tolerance {RESEARCH_TOL:g}); DSEC file decoded vs the "
        f"flow: max|Δ| {dsec_err:.3e} (tolerance {DSEC_TOL:g}); pictures {pictures}")
    require(flo_err <= RESEARCH_TOL * scale and len(density) == 1 and abs(density[0] - std_aee) <= RESEARCH_TOL
            and bool(valid.all()) and dsec_err <= DSEC_TOL + 1e-6
            and all(png_shape(os.path.join(mode_dir, m, f)) in ((H, W), (H, W, 3))
                    for m, fs in pictures.items() for f in fs if f.endswith(".png"))
            and len(pictures["warp"]) == 2 and res["save_flow"] == res["warp"] == res["dsec_submission"] == 1,
            "a research mode disagrees with the standard path or wrote no pictures")
    reset_launch_counts()
    fast_out = os.path.join(tmp, "out_research_fast")
    test_hrem(hrem_args(fast_out, "--fast", "--mode", "save_flow"))
    got = counted("test_hrem --mode save_flow --fast",
                  {"voxel_scatter": 2, "fused_convs_pool": 6, "coarse_head": 1})
    fast_err = float(np.abs(read_flo(os.path.join(fast_out, "eemflow_dt1", "save_flow", "000000.flo")) - std_flow).max())
    say(f"test_hrem --mode save_flow --fast: launches {got}; .flo vs the standard path's flow max|Δ| {fast_err:.3e} "
        f"(tolerance {RESEARCH_TOL:g}·{scale:.3f})")
    require(fast_err <= RESEARCH_TOL * scale, "save_flow under --fast disagrees with the standard path")

    # MVSEC: warp_loss and multi_key on phase 3c's dt1 sequence, the card against the CPU
    mroot = mvsec_split(tmp)
    margs = mvsec_eval_args(mroot, tmp, device, "dt1", "indoor_flying1", "dense") + ["--max_samples", "1"]
    cpu_args = [a if a != str(device) else "cpu" for a in margs]
    for mode in ("warp_loss", "multi_key"):
        reset_launch_counts()
        card = test_mvsec(margs + ["--mode", mode])
        got = counted(f"test_mvsec --mode {mode}", {"local_corr": 1})
        cpu = test_mvsec(cpu_args + ["--mode", mode])
        a, b = (card, cpu) if mode == "warp_loss" else (card[0], cpu[0])
        say(f"test_mvsec --mode {mode} (MVSEC dt1 dense, one sample): card {a:.7f}, CPU {b:.7f}, |Δ| {abs(a - b):.3e} "
            f"(tolerance {RESEARCH_TOL:g}); launches {got}")
        require(np.isfinite(a) and abs(a - b) <= RESEARCH_TOL, f"test_mvsec --mode {mode}: the card disagrees with the CPU")

    # EEMFlow's options at 720x1280 against the standard forward, back to back
    for batch in (1, 2):
        x1, x2 = (torch.from_numpy(rng.standard_normal((batch, H, W, BINS)).astype(np.float32)).to(device)
                  for _ in range(2))
        flows, times = {}, {}
        for label, kw in EEMFLOW_OPTIONS:
            model = get_eval_model("eemflow", **kw)
            model.load_state_dict(sd)
            model.to(device)
            with torch.inference_mode():
                reset_launch_counts()
                flows[label] = model(x1, x2)[1][-1]
                counted(f"{label} forward B={batch}", {"local_corr": 1})
                times[label] = cuda_ms(lambda: model(x1, x2))
        ref = flows["standard"]
        ref_scale = max(1.0, float(ref.abs().max()))
        errs = {k: float((v - ref).abs().max()) for k, v in flows.items() if k != "standard"}
        say(f"EEMFlow 720x1280 B={batch} (golden weights), back to back ms a forward: "
            f"{', '.join(f'{k} {v:.3f}' for k, v in times.items())}; against the standard flow max|Δ| "
            f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tolerance {RESEARCH_TOL:g}·{ref_scale:.3f}); "
            f"K2 one launch a forward")
        require(all(e <= RESEARCH_TOL * ref_scale for e in errs.values()), "an EEMFlow option disagrees with the "
                "standard forward")
        del model, x1, x2

    # time_eval --bf16 at 720x1280
    for label, name, flags in BF16_TIMED:
        reset_launch_counts()
        r = time_eval(["-model", name, "--size", str(H), str(W), "-bs", "1", "--reps", "10", "--bf16", "--device",
                       str(device), *flags])
        counts = dict(launch_counts)
        for k in kernels:
            calls[k] += counts[k]
        say(f"time_eval --bf16 {label} 720x1280 B=1: {r['ms_per_img']:.3f} ms/img; flow {r['rel_l2']:.3e} relative "
            f"L2 from float32; launches {counts}")
        require(np.isfinite(r["rel_l2"]) and r["ms_per_img"] > 0 and counts["update_block"] == 0
                and (name != "eemflow" or (counts["local_corr"] > 0) != ("--fast" in flags))
                and ("--fast" not in flags or counts["fused_convs_pool"] > 0 and counts["coarse_head"] > 0),
                f"time_eval --bf16 {label}: no result or not the kernels of its path")
        torch.cuda.empty_cache()

    # train_hrem --viz --device_voxelize: 2 steps, pictures every step
    import eemflow_tpu_torch.tools.train_hrem as train_hrem
    from eemflow_tpu_torch.train.trainer import Trainer

    train_root = os.path.join(tmp, "hrem_train")
    if not os.path.isdir(train_root):
        make_hrem_train_fixture(tmp)
    save = os.path.join(tmp, "viz_train")
    cls = train_hrem.Trainer
    train_hrem.Trainer = lambda **kw: Trainer(viz_every=1, **kw)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        state = train_hrem.main(["-model", "eemflow", "-int", "dt1", "--data_root", train_root, "--config",
                                 train_config(tmp, True), "-bs", "2",
                                 "--train_iters", "2", "--val_iters", "2", "--save_dir", save, "--device_voxelize",
                                 "--viz", "--device", str(device)])
    finally:
        train_hrem.Trainer = cls
    got = counted("train_hrem --viz", {"voxel_scatter": 8, "local_corr": 4})
    viz_dir = os.path.join(save, os.listdir(save)[0], "viz")
    shapes = {f: png_shape(os.path.join(viz_dir, f)) for f in sorted(os.listdir(viz_dir))}
    say(f"train_hrem --viz --device_voxelize, B=2, 2 steps: {time.perf_counter() - t0:.1f} s; launches {got} (K1 "
        f"and K2 also in the pictures' forwards); pictures {shapes}")
    require(state.step == 2 and sorted(shapes) == sorted(f"{i}_{t}.png" for i in (1, 2)
                                                          for t in ("flow_gt", "flow_est", "map1", "map2"))
            and all(shapes[f"{i}_flow_gt.png"] == (16, 16, 3) for i in (1, 2))
            and all(shapes[f"{i}_flow_est.png"] == shapes[f"{i}_map1.png"] == shapes[f"{i}_map2.png"]
                    and len(shapes[f"{i}_flow_est.png"]) == 3 for i in (1, 2)),
            "train_hrem --viz did not write its pictures at the flow's shapes")
    del state

    # serve --viz on phase 3's stream: a .png beside each .flo
    stream = os.path.join(tmp, "serve")
    if not os.path.isdir(stream):
        make_serve_stream(tmp)
    sout = os.path.join(tmp, "serve_viz")
    reset_launch_counts()
    serve(["--data_root", stream, "--checkpoint", GOLDEN_CKPT, "--warmup", "0", "--out_dir", sout, "--viz",
           "--device", str(device)])
    got = counted("serve --viz", {"voxel_scatter": 2 * SERVE_FRAMES, "local_corr": SERVE_FRAMES})
    flos = sorted(f for f in os.listdir(sout) if f.endswith(".flo"))
    same = [np.array_equal(read_png(os.path.join(sout, f[:-4] + ".png")),
                           flow_to_image(read_flo(os.path.join(sout, f)))[:, :, ::-1]) for f in flos]
    say(f"serve --viz on the {SERVE_FRAMES}-frame stream: {len(flos)} .flo, each .png its colour-wheel picture at "
        f"{png_shape(os.path.join(sout, flos[0][:-4] + '.png'))}: {all(same)}; launches {got}")
    require(len(flos) == SERVE_FRAMES and all(same), "serve --viz did not write a picture beside each flow")
    say(f"phase 3g took {time.perf_counter() - t_phase:.1f} s; its launches {calls}")
    return calls


PHASES = ("0", "1", "2", "3", "3b", "3c", "3d", "3e", "3f", "3g", "4")
# what phase 4 reads from the phases before it: the kernels' errors (2), the
# main paths' launch counts (3, 3b, 3d, 3e, 3f, 3g), the two-volume train
# batch (3b) and the MVSEC paths' launches and fixture (3c)
PHASE_4_NEEDS = ("2", "3", "3b", "3c", "3d", "3e", "3f", "3g")


def run(device: torch.device, phases=PHASES) -> dict:
    """The named phases (0 and 1 always), in order; the ``kernels`` line
    only with phase 4, which needs every phase before it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    dev_info = phase_device(device)
    with tempfile.TemporaryDirectory(prefix="eemflow_smoke_") as tmp:
        phase_build()
        errs = phase_parity(device) if "2" in phases else None
        launches = {}
        if "3" in phases:
            launches.update(phase_end_to_end(device, tmp))
        if "3b" in phases:
            launches.update(phase_train(device, tmp))
            two_volume = phase_train_two_volume(device, tmp)
        if "3c" in phases:
            mvsec = phase_mvsec(device, tmp)
        if "3d" in phases:
            zoo = phase_zoo(device, tmp)
        if "3e" in phases:
            transformers = phase_transformers(device, tmp)
        if "3f" in phases:
            pwc = phase_pwc(device, tmp)
        if "3g" in phases:
            research = phase_research(device, tmp)
        if "4" in phases:
            launches["voxel_scatter"] += zoo["voxel_scatter"] + transformers["voxel_scatter"] + pwc["voxel_scatter"]
            launches["local_corr"] += transformers["local_corr"] + pwc["local_corr"]
            for k, n in research.items():  # phase 3g's launches of K1-K4
                launches[k] += n
            kernels, train = phase_times(device, tmp, errs, launches, two_volume, mvsec)
            stamp("the zoo")
            train["zoo"] = times_zoo(device, tmp)
            stamp("the transformers")
            train["transformers"] = times_transformers(device, tmp)
            stamp("the IRR-PWC and FlowNet line")
            train["pwc"] = times_pwc(device, tmp)
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s" if phases == PHASES else
        f"phases {', '.join(phases)} passed in {time.perf_counter() - t0:.1f} s")
    if "4" in phases:
        say(json.dumps({"train_step": train}))
        say(json.dumps({"kernels": kernels}))
    return dev_info


def parse_phases(arg: str) -> tuple:
    """``--phases 0,1,2,3e`` → the named phases with 0 and 1, in run order;
    a name it does not know, or phase 4 without the phases it reads, exits."""
    names = {p.strip() for p in arg.split(",") if p.strip()}
    unknown = sorted(names - set(PHASES))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phase(s) {unknown}; the phases are {', '.join(PHASES)}")
    names |= {"0", "1"}
    missing = [p for p in PHASE_4_NEEDS if "4" in names and p not in names]
    if missing:
        raise SystemExit(f"chip_smoke: phase 4 reads phases {', '.join(PHASE_4_NEEDS)}; add {', '.join(missing)}")
    return tuple(p for p in PHASES if p in names)


def sweep_k3_bf16(device: torch.device, seeds: int) -> None:
    """K3's bf16 check on EEMFlow+'s chains over ``seeds`` draws (generators
    seeded 1000, 1001, ...): each chain's largest share of
    ``bf16_chain_bound``'s limit, for the kernel and the plain version
    alike, over the draws; a draw that breaks the limit is reported and the
    next one taken."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_device(device)
    phase_build()
    phase(f"K3 bf16 on EEMFlow+'s chains against exact sums over {seeds} draws")
    ratios, failed = {}, []
    for k in range(seeds):
        try:
            phase_parity_k3_plus(device, np.random.default_rng(1000 + k), (torch.bfloat16,), ratios)
        except SmokeFailure as e:
            failed.append(f"seed {1000 + k}: {e}")
    for label, r in ratios.items():
        r = np.asarray(r)
        say(f"K3 bf16 {label}: share of the limit over {len(r)} draws: largest {r.max():.3f}, median "
            f"{np.median(r):.3f}, smallest {r.min():.3f}")
    say(f"draws past the limit: {len(failed)} of {seeds}" + "".join(f"\n  {f}" for f in failed))


def main() -> int:
    phases = PHASES
    if sys.argv[1:2] == ["--phases"]:
        phases = parse_phases(sys.argv[2] if len(sys.argv) > 2 else "")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, REPO)
    try:
        if sys.argv[1:2] == ["--k3-bf16-seeds"]:
            sweep_k3_bf16(torch.device("cuda"), int(sys.argv[2]))
            return 0
        dev_info = run(torch.device("cuda"), phases)
    except Exception as e:  # the smoke run's boundary: report, exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 1
    say(json.dumps({"ok": True, "device": dev_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
