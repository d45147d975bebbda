#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``eemflow_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right and runs
its main path on the card.

    python3 chip_smoke.py

Phases, each announced on a flushed line so a run that is cut off shows
where it stopped:

  0. device: the card's name, the device count, and the card's name and
     power limit as ``nvidia-smi`` reports them;
  1. build: the kernels' ``nvcc`` calls, one per source, all started
     together (seconds, and the ``-Xptxas -v`` lines: registers and spills
     of each kernel);
  2. each kernel against its plain PyTorch twin at the main paths' shapes
     (K1 voxel scatter, K2 local correlation and its backward, K3 fused
     conv chain + pool at the three 720×1280 pyramid levels in float32 and
     at level 2 in bf16, and on a small concat chain; K4 coarse head at the
     three 12×20 levels for B=1 and 2, groups 5 and 1; K5 update block,
     both entry points, at ERAFT's 92×160 and 64×120 grids and an odd
     28×12 one, in float32 and bf16, with He-scaled random weights), with
     the tolerance stated;
  3. end to end: the port's HREM eval CLI at 720×1280 on the seed-99
     synthetic split with the golden checkpoints, each path's launch
     counts set to 0 just before it and read just after: EEMFlow on the
     host-voxelize path, the device-voxelize path and the batched device
     path (the main path of K1 and K2), then with ``--fast_head
     --fast_pyramid`` (the main path of K3 and K4); ERAFT (one sample,
     12 iterations) on the module path, then with ``--config
     {"fused_update": true}`` (the main path of K5, 24 launches) and with
     bf16 operands; the golden AEEs, the agreement of the paths, and small
     forwards on the card against the same forwards on the CPU;
  4. times (CUDA events after a warm-up): each kernel on the device
     (calls queued behind a sleep kernel, so the host's issue time is not
     counted) and per wrapper call back to back, beside its bound, its
     twin, the library yardstick and, for K3, K4 and K5, the port's
     standard path for the same work; one 720×1280 B=1 EEMFlow forward in
     the standard and in the fused modes; one whole device-voxelize eval
     sample; the ERAFT forward at 720×1280 and 512×960, B=1, on the module
     path and with ``fused_update``.

Then one JSON line of every ported kernel (``ms`` is device time; for K3
and K4 with the L2 cache flushed before each call, as a forward leaves
their weights, and ``warm_ms`` without the flush; for K5 one pair of
calls, one iteration, at the 92×160 grid; ``wrapper_ms`` the time per
wrapper call back to back; ``standard_ms`` the device time of the
standard path that K3, K4 or K5 replaces), and as the last line
``{"ok": true, "device": {...}}``.  Any fault exits non-zero without the
``ok`` line, as does a machine without CUDA.  Synthetic data goes to a
temporary directory outside the repository.  Parity phases run float32
convolutions and matmuls in full float32 (TF32 off).
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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, float32
# outside the tensor cores and bf16 on them, FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

H, W, BINS = 720, 1280, 5
K1_TOL_REL = 1e-5  # of the largest cell: atomics sum in no fixed order
K2_TOL = 1e-5
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
GOLDEN_TOL = 0.01
PATH_TOL = 1e-5
FORWARD_TOL = 1e-4
# K5 relative to max(1, largest |plain|): float32 differs in summation
# order only; bf16 as K3
K5_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# ERAFT's 1/8 grids at 720x1280 (padded 736x1280) and 512x960, and an odd
# small one no row tiling of the TPU kernels takes
K5_GRIDS = ((92, 160), (64, 120), (28, 12))
K2_GRAD_TOL = 1e-5
# ERAFT AEE: the fused update against the module path (summation order
# carried through 12 iterations); bf16 operands against float32
ERAFT_FUSED_TOL = 1e-3
ERAFT_BF16_TOL = 0.05


class SmokeFailure(RuntimeError):
    pass


def say(line: str) -> None:
    print(line, flush=True)


def phase(name: str) -> None:
    say(f"=== phase {name}")


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
    work alone, not the wrapper's Python and launch overhead.  Fails if the
    host was still issuing when the sleep ended."""
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
    torch.cuda._sleep(int(cycles_per_ms * (2 * issue_ms + 5)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    still_queued = not start.query()
    torch.cuda.synchronize()
    require(still_queued, "the host fell behind the sleep: the queued time is not device time")
    return start.elapsed_time(end) / reps


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


def k1_batch(rng, n_valid, N: int = 1 << 18, dt_zero=()):
    """[B, N, 4] padded event rows: sorted relative µs timestamps, x/y
    drawn two pixels past every edge (out-of-frame events), p in {0, 1};
    samples listed in ``dt_zero`` share one timestamp (ΔT == 0)."""
    ev = np.zeros((len(n_valid), N, 4), np.float32)
    for b, n in enumerate(n_valid):
        t = np.zeros(n) if b in dt_zero else np.sort(rng.uniform(0, 50_000, n))
        ev[b, :n, 0] = t
        ev[b, :n, 1] = rng.integers(-2, W + 2, n)
        ev[b, :n, 2] = rng.integers(-2, H + 2, n)
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
        for i, ((cout, _, g, _), (wt, bs)) in enumerate(zip(packed["meta"], packed["levels"][lvl])):
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


def phase_parity(device: torch.device) -> dict:
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.kernels import voxel_scatter as k1
    from eemflow_tpu_torch.models.eemflow import INDEX_53

    phase("2 kernels against their twins")
    rng = np.random.default_rng(0)
    ev, nv = k1_batch(rng, (200_000, 150_000), dt_zero=(1,))
    ev_t = torch.from_numpy(ev).to(device)
    nv_t = torch.from_numpy(nv).to(device)
    got = k1.voxel_scatter(ev_t, nv_t, BINS, H, W)
    ref = k1.plain(ev_t, nv_t, BINS, H, W)
    torch.cuda.synchronize()
    k1_err = float((got - ref).abs().max())
    k1_scale = float(ref.abs().max())
    say(f"K1 voxel_scatter B=2 N=2^18 n_valid={nv.tolist()} (sample 1: ΔT==0) "
        f"bins={BINS} {H}x{W}: max|Δ| {k1_err:.3e}, largest cell {k1_scale:.3f}, "
        f"tolerance {K1_TOL_REL:g}·largest = {K1_TOL_REL * k1_scale:.3e}")
    require(k1_scale > 0 and k1_err <= K1_TOL_REL * k1_scale, "K1 disagrees with its twin")

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
    phase_parity_k2_backward(device, rng)
    k3_err = phase_parity_k3(device, rng)
    k4_err = phase_parity_k4(device, rng)
    k5_err = phase_parity_k5(device, rng)
    return {"voxel_scatter": k1_err, "local_corr": k2_err, "fused_convs_pool": k3_err,
            "coarse_head": k4_err, "update_block": k5_err}


def phase_parity_k2_backward(device: torch.device, rng) -> None:
    """K2 as an autograd.Function on the card: the kernel's forward, the
    twin's autograd as its backward; the grads against plain autograd
    through the twin on the same inputs."""
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


def phase_parity_k5(device: torch.device, rng) -> float:
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
        for h, w in K5_GRIDS:
            net, inp, corr, flow = k5_inputs(rng, h, w, device)
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


def phase_parity_k3(device: torch.device, rng) -> float:
    from eemflow_tpu_torch.kernels import fused_convs as k3

    worst = 0.0
    cases = [(lvl, torch.float32, 2) for lvl in range(3)] + [(1, torch.bfloat16, 2)]
    for lvl, dtype, B in cases:
        (cin, h, w), widths, pool, emit_full = K3_LEVELS[lvl]
        x = torch.from_numpy(rng.standard_normal((B, cin, h, w)).astype(np.float32)).to(device)
        ws, bs = conv_params(rng, (cin,) + widths[:-1], widths, device)
        full, pooled = k3.fused_convs(x, ws, bs, pool, dtype, emit_full)
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
    # a concat chain (the EEMFlow+ FlowEstimatorDense pattern), no pool, ragged
    x = torch.from_numpy(rng.standard_normal((2, 16, 37, 45)).astype(np.float32)).to(device)
    ws, bs = conv_params(rng, (16, 24, 32), (8, 8, 3), device)
    flags = dict(relus=(True, True, False), concat=(True, True, False))
    got, _ = k3.fused_convs(x, ws, bs, None, **flags)
    ref, _ = k3.plain(x, ws, bs, None, **flags)
    torch.cuda.synchronize()
    err, scale = rel_err(got, ref)
    worst = max(worst, err)
    say(f"K3 concat chain [2,16,37,45] convs [8,8,3] no pool: max|Δ| {err:.3e} "
        f"(tolerance {K3_TOL['float32']:g}·{scale:.2f})")
    require(err <= K3_TOL["float32"] * scale, "K3 disagrees with its twin on the concat chain")
    return worst


def phase_parity_k4(device: torch.device, rng) -> float:
    from eemflow_tpu_torch.models.eemflow import INDEX_53
    from eemflow_tpu_torch.ops.coarse_head import HeadWeights, coarse_head

    worst = 0.0
    for groups in (5, 1):
        weights = HeadWeights(head_params(rng, groups, device), groups)
        for B in (1, 2):
            f1, f2 = (
                [torch.from_numpy(rng.standard_normal((B, 12, 20, c)).astype(np.float32)).to(device)
                 for c in HEAD_CHANNELS]
                for _ in range(2)
            )
            got = coarse_head(f1, f2, weights, groups, INDEX_53, 4)
            ref = coarse_head(f1, f2, weights, groups, INDEX_53, 4, impl="plain")
            torch.cuda.synchronize()
            err, scale = rel_err(got, ref)
            worst = max(worst, err)
            say(f"K4 coarse_head B={B} 12x20 C=16/32/64 groups {groups}: max|Δ| {err:.3e}, "
                f"largest |flow| {float(ref.abs().max()):.3f} (tolerance {K4_TOL:g}·{scale:.2f})")
            require(tuple(got.shape) == (B, 12, 20, 2) and err <= K4_TOL * scale,
                    f"K4 disagrees with its twin (B={B}, groups {groups})")
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
    # each main path: (label, its CLI runs, the kernels it must launch)
    paths = (
        ("standard", (
            ("host voxelize", []),
            ("device voxelize", ["--device_voxelize"]),
            ("device voxelize, eval_batch 2", ["--device_voxelize", "--eval_batch", "2"]),
        ), ("voxel_scatter", "local_corr")),
        ("fused", (
            ("fused modes (--fast_head --fast_pyramid)", ["--fast_head", "--fast_pyramid"]),
        ), ("fused_convs_pool", "coarse_head")),
    )
    aee = {}
    launches = {}
    for path, runs, kernels in paths:
        reset_launch_counts()
        for label, extra in runs:
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
        counts = dict(launch_counts)
        say(f"launches on the {path} path: {counts}")
        for k in kernels:
            require(counts[k] > 0, f"kernel {k} was not launched on the {path} path")
            launches[k] = counts[k]
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
    require(counts["module path"]["update_block"] == 0, "the module path launched K5")
    # one sample, 12 iterations, two entry points each
    for label in ("fused_update", "fused_update bf16"):
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
    return {"update_block": counts["fused_update"]["update_block"]}


def phase_times(device: torch.device, tmp: str, errs: dict, launches: dict) -> list:
    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.data.hrem import HREMEventFlow
    from eemflow_tpu_torch.eval.runner import Tester
    from eemflow_tpu_torch.events.voxel import voxel_votes
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.kernels import voxel_scatter as k1
    from eemflow_tpu_torch.models.eemflow import INDEX_53
    from eemflow_tpu_torch.models.registry import get_eval_model

    phase("4 times (CUDA events, after a warm-up)")
    rng = np.random.default_rng(2)
    ev, nv = k1_batch(rng, (200_000, 200_000))
    ev_t = torch.from_numpy(ev).to(device)
    nv_t = torch.from_numpy(nv).to(device)
    idx, val = voxel_votes(ev_t, nv_t, BINS, H, W)
    grid_bytes = len(nv) * BINS * H * W * 4
    # the least the function must move: each valid event read once, the
    # grid written once; the kernel's zero-fill and its atomic
    # read-modify-writes are costs of its design, not of the function
    k1_bytes = int(nv.sum()) * 16 + grid_bytes
    k1_design_bytes = grid_bytes + idx.numel() * 8
    k1_bound, k1_by = bound_ms(k1_bytes, 2 * idx.numel())
    k1_ms = queued_ms(lambda: k1.voxel_scatter(ev_t, nv_t, BINS, H, W), reps=20)
    k1_wrapper = cuda_ms(lambda: k1.voxel_scatter(ev_t, nv_t, BINS, H, W))
    k1_plain = cuda_ms(lambda: k1.plain(ev_t, nv_t, BINS, H, W), reps=5)

    def library():
        g = torch.zeros(len(nv) * BINS * H * W, device=device)
        g.index_put_((idx,), val, accumulate=True)

    k1_lib = cuda_ms(library)
    say(f"K1 voxel_scatter B=2 N=2^18 n_valid=2e5 {H}x{W}: {k1_ms:.4f} ms on the device "
        f"(zero-fill + kernel, queued), {k1_wrapper:.4f} ms per wrapper call back to back; "
        f"bound {k1_bound:.4f} ms ({k1_by}: {k1_bytes} B; the design adds {k1_design_bytes} B "
        f"of zero-fill and atomic read-modify-writes for {idx.numel()} votes); twin "
        f"{k1_plain:.4f} ms; index_put_(accumulate=True) on the same votes {k1_lib:.4f} ms "
        f"(twin and library back to back)")

    shapes = ((1, 12, 20, 16), (1, 12, 20, 32), (1, 12, 20, 64))
    pairs = [
        tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device) for _ in range(2))
        for s in shapes
    ]
    k2_bytes = k2_flops = 0
    for (b, h, w, c) in shapes:
        k2_bytes += 2 * b * h * w * c * 4 + 53 * 4 + b * h * w * 53 * 4
        k2_flops += 2 * b * h * w * 53 * c
    k2_bound, k2_by = bound_ms(k2_bytes, k2_flops)
    k2_ms = queued_ms(lambda: [k2.local_corr(x, y, 4, INDEX_53) for x, y in pairs], reps=50)
    k2_wrapper = cuda_ms(lambda: [k2.local_corr(x, y, 4, INDEX_53) for x, y in pairs], reps=50)
    k2_plain = cuda_ms(lambda: [k2.plain(x, y, 4, INDEX_53) for x, y in pairs], reps=20)
    for (x, y), s in zip(pairs, shapes):
        one = queued_ms(lambda: k2.local_corr(x, y, 4, INDEX_53), reps=50)
        one_wrapper = cuda_ms(lambda: k2.local_corr(x, y, 4, INDEX_53), reps=50)
        say(f"K2 local_corr {list(s)} K=53: {one:.4f} ms on the device (queued), "
            f"{one_wrapper:.4f} ms per wrapper call back to back")
    say(f"K2 local_corr, the three 12x20 levels of one forward (C=16/32/64, K=53): "
        f"{k2_ms:.4f} ms on the device (queued), {k2_wrapper:.4f} ms of wrapper calls back "
        f"to back; bound {k2_bound:.6f} ms ({k2_by}: {k2_bytes} B, {k2_flops} FLOP); "
        f"twin {k2_plain:.4f} ms (back to back); no single PyTorch call computes it")

    sd = to_state_dict(load_torch_checkpoint(GOLDEN_CKPT))
    model = get_eval_model("eemflow")
    model.load_state_dict(sd)
    model.to(device)
    x1, x2 = (torch.randn(1, H, W, BINS, device=device) for _ in range(2))
    k3_row, k4_row = times_k3_k4(device, model, x1, x2, errs, launches)

    flows = {}
    fwd = {}
    fused = get_eval_model("eemflow", fast_head=True, fast_pyramid=True)
    fused.load_state_dict(sd)
    fused.to(device)
    for label, m in (("standard", model), ("fused (--fast_head --fast_pyramid)", fused)):
        def forward(m=m):
            with torch.inference_mode():
                return m(x1, x2)[1][-1]

        flows[label] = flow = forward()
        require(tuple(flow.shape) == (1, H, W, 2) and bool(torch.isfinite(flow).all()),
                f"720x1280 {label} forward is not finite or has the wrong shape")
        fwd[label] = (cuda_ms(forward, reps=20), queued_ms(forward, reps=2))
        say(f"EEMFlow forward 720x1280 B=1, {label} (host-voxelized input on the card): "
            f"{fwd[label][0]:.3f} ms per call back to back ({1e3 / fwd[label][0]:.1f} fps), "
            f"{fwd[label][1]:.3f} ms on the device (queued)")
    err = float((flows["standard"] - flows["fused (--fast_head --fast_pyramid)"]).abs().max())
    say(f"720x1280 fused vs standard forward: max|Δ| {err:.3e} (tolerance {FORWARD_TOL:g})")
    require(err <= FORWARD_TOL, "the fused 720x1280 forward disagrees with the standard one")

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
    sample_ms = (time.perf_counter() - t0) / reps * 1e3
    say(f"whole eval sample, device voxelize (packed events from the host → K1 ×2 + "
        f"normalize → forward → flow on the host): {sample_ms:.3f} ms ({1e3 / sample_ms:.1f} fps)")

    k5_row = times_k5(device, errs, launches)
    times_eraft(device)

    return [
        {
            "name": "voxel_scatter", "route": "cuda",
            "source": "eemflow_tpu_torch/kernels/csrc/voxel_scatter.cu",
            "replaces": "eemflow_tpu/ops/pallas/voxel_scatter.py:101",
            "launches": launches["voxel_scatter"], "max_abs_err": errs["voxel_scatter"],
            "ms": k1_ms, "wrapper_ms": k1_wrapper, "plain_ms": k1_plain,
            "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
            "standard_ms": None,
        },
        {
            "name": "local_corr", "route": "cuda",
            "source": "eemflow_tpu_torch/kernels/csrc/local_corr.cu",
            "replaces": "eemflow_tpu/ops/pallas/local_corr.py:104",
            "launches": launches["local_corr"], "max_abs_err": errs["local_corr"],
            "ms": k2_ms, "wrapper_ms": k2_wrapper, "plain_ms": k2_plain,
            "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
            "standard_ms": None,
        },
        k3_row,
        k4_row,
        k5_row,
    ]


def times_k5(device, errs: dict, launches: dict) -> dict:
    """One K5 pair (the two entry points of one iteration) at ERAFT's
    720x1280 and 512x960 grids, float32 and bf16: device time (queued),
    wrapper calls back to back, the plain version, the bound, and the
    standard path for the same work (``BasicUpdateBlock`` without its mask
    head: cuDNN convs, TF32 off, and the concatenations)."""
    from eemflow_tpu_torch.kernels import update_block as k5
    from eemflow_tpu_torch.ops.update_block import gru_flowhead_plain, make_fused_update, motion_encoder_plain
    from eemflow_tpu_torch.tools.update_block_bound import update_block_work

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
            for dtype, rate in ((torch.float32, PEAK_FP32_FLOP_PER_S), (torch.bfloat16, PEAK_BF16_FLOP_PER_S)):
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
                b_ms, b_by = bound_ms(nbytes, flops, rate)
                kind = str(dtype)[6:]
                say(f"K5 update_block pair B=1 {h}x{w} {kind}: {dev:.4f} ms on the device after an L2 "
                    f"flush ({warm:.4f} warm, queued), {wrapper:.4f} ms per wrapper pair back to back "
                    f"({flops / dev / 1e9:.1f} TFLOP/s); bound {b_ms:.4f} ms ({b_by} at the {kind} "
                    f"peak: {flops} FLOP, {nbytes} B); plain version {plain_ms:.4f} ms; standard path "
                    f"(BasicUpdateBlock without the mask, cuDNN float32) {std:.4f} ms on the device "
                    f"after an L2 flush ({std_warm:.4f} warm)")
                if (h, w) == K5_GRIDS[0] and dtype == torch.float32:
                    row = {
                        "name": "update_block", "route": "cuda",
                        "source": "eemflow_tpu_torch/kernels/csrc/update_block.cu",
                        "replaces": "eemflow_tpu/ops/pallas/update_block.py:236",
                        "launches": launches["update_block"], "max_abs_err": errs["update_block"],
                        "ms": dev, "warm_ms": warm, "wrapper_ms": wrapper, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "standard_ms": std,
                    }
    return row


def times_eraft(device) -> None:
    """The ERAFT eval forward (golden weights, 12 iterations, the mask head
    once) at 720x1280 and 512x960, B=1: module path against K5."""
    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.models.registry import get_eval_model

    sd = to_state_dict(load_torch_checkpoint(ERAFT_CKPT))
    models = {}
    for label, kw in (("module path", {}), ("fused_update", {"fused_update": True}),
                      ("fused_update bf16", {"fused_update": True, "fused_dtype": "bf16"})):
        models[label] = get_eval_model("eraft", **kw)
        models[label].load_state_dict(sd)
        models[label].to(device)
    for h, w in ((720, 1280), (512, 960)):
        x1, x2 = (torch.randn(1, h, w, BINS, device=device) for _ in range(2))
        flows = {}
        for label, m in models.items():
            def forward(m=m):
                with torch.inference_mode():
                    return m(x1, x2)[1][-1]

            flows[label] = flow = forward()
            require(tuple(flow.shape) == (1, h, w, 2) and bool(torch.isfinite(flow).all()),
                    f"ERAFT {h}x{w} {label} forward is not finite or has the wrong shape")
            ms = cuda_ms(forward, reps=5, warmup=2)
            say(f"ERAFT forward {h}x{w} B=1, {label}: {ms:.3f} ms per call back to back "
                f"({1e3 / ms:.1f} fps)")
        err = float((flows["fused_update"] - flows["module path"]).abs().max())
        say(f"ERAFT {h}x{w} fused_update vs module path forward: max|Δ| {err:.3e}")


def times_k3_k4(device, model, x1, x2, errs: dict, launches: dict):
    """K3 per pyramid level and over the six calls of one 720x1280 B=1
    forward, and K4 on the forward's pooled grids: device time (queued),
    wrapper calls back to back, the twin, the bound, and the standard path
    for the same work (cuDNN convs + LeakyReLU + ``F.avg_pool2d`` of the
    level; the standard coarse stage: K2, rconvs, decoders, ``out_conv``)."""
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
        packs = [pack_chain(ws, bs, False, device) for ws, bs in chains]

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

        flops_all = bytes_all = 0
        for lvl in range(3):
            (cin, h, w), widths, pool, emit_full = K3_LEVELS[lvl]
            require(tuple(inputs[0][lvl].shape) == (1, cin, h, w), "K3 level shape differs from the forward's")
            flops, nbytes = k3_flops_bytes(1, cin, h, w, widths, emit_full, pool)
            flops_all += 2 * flops
            bytes_all += 2 * nbytes
            b_ms, b_by = bound_ms(nbytes, flops)
            one = cold_queued_ms(lambda: fused(0, lvl), 20, device)
            one_warm = queued_ms(lambda: fused(0, lvl), reps=20)
            one_wrapper = cuda_ms(lambda: fused(0, lvl))
            one_plain = cuda_ms(lambda: plain(0, lvl))
            one_std = cold_queued_ms(lambda: standard(0, lvl), 10, device)
            say(f"K3 level {lvl + 1} [1,{cin},{h},{w}] convs {list(widths)} pool {pool}: {one:.4f} ms "
                f"on the device after an L2 flush ({one_warm:.4f} warm, queued), {one_wrapper:.4f} ms "
                f"per wrapper call; bound {b_ms:.4f} ms "
                f"({b_by}: {flops} FLOP, {nbytes} B); twin {one_plain:.4f} ms; standard path "
                f"(cuDNN conv{'s' if len(widths) > 1 else ''} + LeakyReLU + avg_pool2d) {one_std:.4f} ms "
                f"on the device after an L2 flush")
        six = lambda fn: [fn(f, l) for f in range(2) for l in range(3)]
        k3_ms = cold_queued_ms(lambda: six(fused), 10, device)
        k3_warm = queued_ms(lambda: six(fused), reps=10)
        k3_wrapper = cuda_ms(lambda: six(fused))
        k3_plain = cuda_ms(lambda: six(plain))
        k3_std = cold_queued_ms(lambda: six(standard), 5, device)
        k3_bound, k3_by = bound_ms(bytes_all, flops_all)
        say(f"K3, the six calls of one forward (3 levels x 2 frames): {k3_ms:.4f} ms on the device "
            f"after an L2 flush ({k3_warm:.4f} warm, queued), {k3_wrapper:.4f} ms of wrapper calls; "
            f"bound {k3_bound:.4f} ms ({k3_by}: {flops_all} FLOP, {bytes_all} B); twin "
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
                dec(torch.cat([model._corr(a, b), rconv(a)], dim=1))
                for a, b, rconv, dec in zip(pooled[0], pooled[1],
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
        say(f"K4 coarse_head B=1 {ph}x{pw} (groups {model.groups}): {k4_ms:.4f} ms on the device "
            f"after an L2 flush ({k4_warm:.4f} warm, queued), {k4_wrapper:.4f} ms per wrapper call; "
            f"bound {k4_bound:.6f} ms ({k4_by}: {k4_flops} FLOP, {k4_bytes} B); twin "
            f"{k4_plain:.4f} ms; standard coarse stage {k4_std:.4f} ms on the device after an L2 "
            f"flush ({k4_std_warm:.4f} warm; max|Δ| to it {err:.3e}); no single PyTorch call "
            f"computes it")

    k3_row = {
        "name": "fused_convs_pool", "route": "cuda",
        "source": "eemflow_tpu_torch/kernels/csrc/fused_convs.cu",
        "replaces": "eemflow_tpu/ops/pallas/fused_convs.py:176",
        "launches": launches["fused_convs_pool"], "max_abs_err": errs["fused_convs_pool"],
        "ms": k3_ms, "warm_ms": k3_warm, "wrapper_ms": k3_wrapper, "plain_ms": k3_plain,
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None, "standard_ms": k3_std,
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


def run(device: torch.device) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    dev_info = phase_device(device)
    phase_build()
    errs = phase_parity(device)
    with tempfile.TemporaryDirectory(prefix="eemflow_smoke_") as tmp:
        launches = phase_end_to_end(device, tmp)
        kernels = phase_times(device, tmp, errs, launches)
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": kernels}))
    return dev_info


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, REPO)
    try:
        dev_info = run(torch.device("cuda"))
    except Exception as e:  # the smoke run's boundary: report, exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 1
    say(json.dumps({"ok": True, "device": dev_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
