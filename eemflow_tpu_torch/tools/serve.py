"""Sustained serving CLI of the port: raw event ``.npz`` pairs → optical
flow, steady state, double-buffered (the twin of the JAX ``tools/serve.py``).

Batch i is queued on the card (kernel K1 voxelizes each frame, then the
forward), the flow of batch i−1 is fetched (through a pinned buffer), and
then, while the card runs batch i, the host decodes and bucket-packs
batch i+1 (the C++ packer, ``eemflow_tpu_torch.native``) straight into
pinned buffers (``data.staging``).  The decode runs on the dispatch
thread: the dispatch of an eager PyTorch forward releases and retakes the
GIL at every op, and a decode thread that holds it between them slows
that dispatch (``PERF.md`` has the card's numbers).  ``--data_root`` is scanned
recursively for sample directories holding ``events1.npz`` +
``events2.npz`` (the HREM test layout); ``--out_dir`` receives
``<relpath with os.sep → _>.flo``.

Modes:
  * pair (default): K1 twice a sample (one call a frame of the batch), then
    the forward;
  * ``--stream``: the sample list is a consecutive stream (sample i's
    ``events2`` is sample i+1's ``events1``, the dt1 layout); the previous
    grid stays on the card and K1 runs once a frame.  A row (re-)primes
    from its sample's ``events1`` at its start and wherever its global
    index wraps the sample list (a ``--loops`` boundary).  ``--batch B``
    splits the list into B contiguous streams, one row each;
  * ``--chunk K`` (with ``--stream``): K consecutive frames a stream in one
    dispatch group, primed only at chunk starts.  The JAX CLI unrolls them
    into one XLA program; here the K frames are issued in order on one CUDA
    stream with one fetch a chunk, and the outputs equal ``--stream``.
    Overlapping them on a side stream is later work: K4 keeps its counters
    in its packed weights, so two streams sharing one ``HeadWeights`` would
    race;
  * ``--host_voxelize``: the port's ``HostVoxelizer`` (C++, sparse, without
    the GIL) runs on a prefetch thread two batches ahead (as the JAX CLI),
    one instance owned by it, its grids in pinned memory; its ring grows
    to the grids in use (the ones queued, and those whose copy has not
    completed), so no chunk size waits on it; the card runs the forward
    only;
  * ``--bf16``: a bf16 copy of the model's floating parameters and buffers,
    bf16 volumes, the flow cast back to float32 (a cast, not autocast, as
    the JAX ``cast_floating``); K2 takes bf16 operands.  Not
    checkpoint-parity;
  * ``--fast``: ``models/registry.FAST_EVAL_KWARGS`` (the card's fastest
    parity-safe modes, see the comment there).

Prints which packer runs, the bucket-overflow warning, and the report
line of the JAX CLI (frames, wall fps, host decode and dispatch ms a
frame, the device's name); with ``--profile`` the device's busy share of
the timed window (the union of its kernels' and copies' intervals in a
``torch.profiler`` trace); returns the report's numbers.  Without
``--checkpoint`` the weights are a seeded random init.  Runs on the card
unless ``--device cpu``; TF32 off.  ``--viz`` and ``--shard`` are not
ported yet (``ROADMAP.md``).

Usage:
  python -m eemflow_tpu_torch.tools.serve --data_root <dir> --checkpoint ckpt.pth.tar \\
      [-model eemflow|eemflow_plus|eraft] [--stream [--chunk K]] [--batch B] \\
      [--host_voxelize] [--fast] [--bf16] [--loops N] [--warmup N] [--out_dir <dir>] \\
      [--profile <dir>] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
from eemflow_tpu_torch.data.loader import prefetch
from eemflow_tpu_torch.data.staging import Staging
from eemflow_tpu_torch.device import resolve_device
from eemflow_tpu_torch.events.io import write_flo
from eemflow_tpu_torch.events.voxel import voxelize_batch_nhwc
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model
from eemflow_tpu_torch.native import HostVoxelizer, decode_pack_npz, native_status

PREFETCH_DEPTH = 2  # --host_voxelize: batches its thread runs ahead
# the fused modes take float32 volumes (kernels K3 and K4)
FLOAT32_ONLY = ("fast_head", "fast_pyramid", "fast_decoders", "fast_sgu")


def find_samples(root: str):
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        fs = set(filenames)
        if "events1.npz" in fs and "events2.npz" in fs:
            out.append(dirpath)
    return sorted(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve raw event pairs as optical flow (PyTorch port)")
    p.add_argument("-model", "--model", default="eemflow", choices=["eemflow", "eemflow_plus", "eraft"])
    p.add_argument("--checkpoint", default=None,
                   help=".pth/.pth.tar release or the port's epoch_N.pt; omitted = seeded "
                   "random init (pipeline smoke only)")
    p.add_argument("--data_root", required=True)
    p.add_argument("--size", type=int, nargs=2, default=[720, 1280], metavar=("H", "W"))
    p.add_argument("--bins", type=int, default=5)
    p.add_argument("--bucket_size", type=int, default=1 << 16)
    p.add_argument("--batch", type=int, default=1, help="samples per forward")
    p.add_argument("--loops", type=int, default=1,
                   help="passes over the sample list (steady-state timing)")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed leading batches (kernel build, cache warm)")
    p.add_argument("--fast", action="store_true",
                   help="the card's fastest parity-safe serving modes of the family "
                   "(registry.fast_eval_kwargs)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 parameters and volumes (not checkpoint-parity)")
    p.add_argument("--out_dir", default=None, help="write <sample>.flo final flows here")
    p.add_argument("--stream", action="store_true",
                   help="treat the sample list as consecutive dt1 stream(s): voxelize only each "
                   "sample's events2 and reuse the previous grid (sample i's events2 must be "
                   "sample i+1's events1); with --batch B the list is split into B contiguous "
                   "streams")
    p.add_argument("--chunk", type=int, default=1,
                   help="stream mode: consecutive frames per stream per dispatch group, one "
                   "fetch a chunk; requires --stream")
    p.add_argument("--host_voxelize", action="store_true",
                   help="voxelize on a prefetch thread (the C++ sparse voxelizer) instead of "
                   "on the card; composable with --stream")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="on the card: trace the timed window with torch.profiler (device "
                   "activity), write LOGDIR/serve_trace.json and report the device's busy share")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def _check_args(args, n_samples: int) -> None:
    """The JAX CLI's checks (``tools/serve.py:116-145``)."""
    if args.chunk < 1:
        raise SystemExit("--chunk must be >= 1")
    if args.chunk > 1 and not args.stream:
        raise SystemExit("--chunk is a --stream lever (per-frame batching for the non-stream "
                         "path is --batch)")
    if args.chunk > 1:
        # carried grids can only be (re-)primed at chunk starts, so a --loops
        # wrap landing mid-chunk would pair a frame against the previous
        # loop's last grid — reject up front
        B = args.batch
        per_stream = (n_samples * args.loops) // B
        for b in range(B):
            for j0 in range(0, per_stream - per_stream % args.chunk, args.chunk):
                for jj in range(1, args.chunk):
                    if (b * per_stream + j0 + jj) % n_samples == 0:
                        raise SystemExit(
                            "--chunk: a --loops stream-wrap falls mid-chunk (re-priming is only "
                            "possible at chunk starts); pick --chunk dividing the per-stream "
                            "sample count or drop --loops")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    H, W = args.size
    B = args.batch
    bins = args.bins
    samples = find_samples(args.data_root)
    if not samples:
        raise SystemExit(f"no events1.npz/events2.npz pairs under {args.data_root}")
    _check_args(args, len(samples))

    kwargs = fast_eval_kwargs(args.model) if args.fast else {}
    if args.bf16 and any(kwargs.get(k) for k in FLOAT32_ONLY):
        raise SystemExit(f"--fast maps {args.model} to {kwargs}, whose kernels take float32 volumes; "
                         "drop --bf16 or --fast")
    torch.manual_seed(0)
    model = get_eval_model(args.model, n_first_channels=bins, **kwargs)
    if args.checkpoint:
        try:
            load_model_checkpoint(model, args.checkpoint, args.model, log=lambda m: print(m, flush=True))
        except ValueError as e:
            raise SystemExit(str(e)) from None
    else:
        print("WARNING: no --checkpoint; serving random-init weights", flush=True)
    model.to(device)
    if args.bf16:
        model.to(torch.bfloat16)
    vol_dtype = torch.bfloat16 if args.bf16 else torch.float32
    print(f"packer: {native_status()}", flush=True)

    staging = Staging(device)
    bucket = args.bucket_size
    hvox = hvox_rows = None
    if args.host_voxelize:
        hvox = HostVoxelizer(bins, H, W, ring=2, alloc=staging.buffer, claim=staging.claim)
        hvox_rows = np.empty((bucket, 4), np.float32)  # the prefetch thread's packed rows

    def forward(vol1, vol2):
        """NHWC volumes → the final flow [B, H, W, 2], float32."""
        with torch.inference_mode():
            _, preds = model(vol1.to(vol_dtype), vol2.to(vol_dtype))
            return preds[-1].float()

    def to_volume(grids):
        """Host grids [bins, H, W] → an NHWC view of one NCHW device batch."""
        vol = torch.empty((len(grids), bins, H, W), dtype=torch.float32, device=device)
        for b, g in enumerate(grids):
            staging.upload(g, out=vol[b])
        return vol.permute(0, 2, 3, 1)

    order = samples * args.loops
    if len(order) % B:
        print(f"note: dropping {len(order) % B} tail sample(s) not filling a batch of {B}", flush=True)
    dropped_total = [0, 0]  # events dropped, samples affected

    def pack(path, out):
        with np.load(path) as npz:
            _, n, drops = decode_pack_npz(npz, bucket, out=out)
        if drops:
            dropped_total[0] += drops
            dropped_total[1] += 1
        return n

    def frames(paths):
        """Frames of the same position in ``len(paths)`` rows: host grids
        [bins, H, W], or (packed events [rows, bucket, 4], counts [rows])
        in pinned buffers."""
        if hvox is not None:
            return [hvox(hvox_rows, pack(path, hvox_rows)) for path in paths]
        ev = staging.take((len(paths), bucket, 4))
        n = staging.take((len(paths),), np.int32)
        for b, path in enumerate(paths):
            n[b] = pack(path, ev[b])
        return ev, n

    def pair_batches():
        t_host = 0.0
        for i in range(0, len(order) - len(order) % B, B):
            group = order[i : i + B]
            t0 = time.perf_counter()
            pair = tuple(frames([os.path.join(s, f) for s in group]) for f in ("events1.npz", "events2.npz"))
            t_host += time.perf_counter() - t0
            yield group, pair, t_host

    def stream_batches(K):
        """K consecutive frames of each of the B streams a batch (K=1
        without --chunk), j-major like the [K, B] output; primes at chunk
        starts and wraps."""
        t_host = 0.0
        n_samp = len(samples)
        per_stream = len(order) // B
        for j0 in range(0, per_stream - per_stream % K, K):
            t0 = time.perf_counter()
            group = [None] * (K * B)
            primes = []
            for b in range(B):
                gidx = b * per_stream + j0
                if j0 == 0 or gidx % n_samp == 0:
                    primes.append((b, frames([os.path.join(order[gidx], "events1.npz")])))
            rows = []
            for jj in range(K):
                paths = [order[b * per_stream + j0 + jj] for b in range(B)]
                group[jj * B : (jj + 1) * B] = paths
                rows.append(frames([os.path.join(s, "events2.npz") for s in paths]))
            t_host += time.perf_counter() - t0
            yield group, (rows, primes), t_host

    state = {"vol_prev": None}

    def volume(fr):
        """A ``frames`` result on the card: an NHWC view of an NCHW batch."""
        if hvox is not None:
            return to_volume(fr)
        ev, n = fr
        return voxelize_batch_nhwc(staging.upload(ev), staging.upload(n), bins, H, W)

    def dispatch_pair(pair):
        return staging.fetch(forward(volume(pair[0]), volume(pair[1])))

    def dispatch_stream(item):
        rows, primes = item
        prev = state["vol_prev"]
        if primes:
            # (re-)prime carried rows: stream starts, chunk starts at a wrap
            if prev is None:
                prev = torch.zeros((B, bins, H, W), dtype=torch.float32, device=device).permute(0, 2, 3, 1)
            prev_nchw = prev.permute(0, 3, 1, 2)
            for b, fr in primes:
                prev_nchw[b] = volume(fr).permute(0, 3, 1, 2)[0]
        flows = []
        for fr in rows:
            new = volume(fr)
            flows.append(forward(prev, new))
            prev = new
        state["vol_prev"] = prev
        return staging.fetch(torch.stack(flows) if len(flows) > 1 else flows[0])

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    counters = {"frames": 0}

    def drain(item):
        group, fetch = item
        flow = fetch.numpy()
        if flow.ndim == 5:  # --chunk: [K, B, H, W, 2], j-major like group
            flow = flow.reshape(-1, *flow.shape[2:])
        counters["frames"] += len(group)
        if args.out_dir:
            for s, fl in zip(group, flow):
                name = os.path.relpath(s, args.data_root).replace(os.sep, "_")
                write_flo(fl, os.path.join(args.out_dir, name + ".flo"))

    if args.stream:
        batches, dispatch = stream_batches(args.chunk), dispatch_stream
    else:
        batches, dispatch = pair_batches(), dispatch_pair
    prof = None

    def begin_window() -> float:
        """Start of the timed window (and of its trace, with --profile)."""
        nonlocal prof
        if args.profile and device.type == "cuda":
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        return time.perf_counter()

    t_wall0 = begin_window() if args.warmup == 0 else None
    t_host_base = t_dispatch = t_host_total = 0.0
    done_warm = 0
    pending = None  # (group, flow fetch in flight): fetch overlapped with the next dispatch
    for group, item, t_host_total in (prefetch(batches, depth=PREFETCH_DEPTH) if hvox is not None else batches):
        t0 = time.perf_counter()
        fetch = dispatch(item)
        t_dispatch += time.perf_counter() - t0
        if pending is not None:
            drain(pending)
        pending = (group, fetch)
        if done_warm < args.warmup:
            # reset the clocks after the warm-up batches
            done_warm += 1
            if done_warm == args.warmup:
                drain(pending)
                pending = None
                counters["frames"] = 0
                t_dispatch = 0.0
                t_wall0 = begin_window()
                t_host_base = t_host_total
    if pending is not None:
        drain(pending)
    t_end = time.perf_counter()
    busy_ms = None
    if prof is not None:
        from eemflow_tpu_torch.tools.profile_model import device_busy_ms

        prof.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "serve_trace.json")
        prof.export_chrome_trace(trace)
        busy_ms = device_busy_ms(trace)

    if dropped_total[0]:
        print(f"WARNING: bucket overflow — {dropped_total[0]} events dropped across {dropped_total[1]} "
              f"sample(s); raise --bucket_size (currently {bucket})", flush=True)
    n_frames = counters["frames"]
    result = {"frames": n_frames, "packer": native_status(), "dropped_events": dropped_total[0]}
    if t_wall0 is None or n_frames == 0:
        print("no batches past warmup to time (outputs were written); lower --warmup or add --loops "
              "for a timed report", flush=True)
        return result
    wall = t_end - t_wall0
    host_ms = (t_host_total - t_host_base) * 1e3 / n_frames
    dispatch_ms = t_dispatch * 1e3 / n_frames
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"{args.model} serve @{H}x{W} b={B}"
        f"{' stream' if args.stream else ''}"
        f"{f' chunk={args.chunk}' if args.chunk > 1 else ''}"
        f"{' hostvox' if args.host_voxelize else ''}"
        f"{' fast' if args.fast else ''}{' bf16' if args.bf16 else ''}: "
        f"{n_frames} frames in {wall:.2f}s = {n_frames / wall:.1f} fps wall "
        f"(host decode {host_ms:.2f} ms/frame, dispatch {dispatch_ms:.2f} ms/frame, {kind})",
        flush=True,
    )
    busy_share = None if busy_ms is None else busy_ms / (wall * 1e3)
    if args.profile:
        print("device busy share of the timed window: "
              + ("not measured (no card)" if busy_share is None else
                 f"{100 * busy_share:.1f}% ({busy_ms:.3f} ms of {wall * 1e3:.3f}; {trace})"), flush=True)
    result.update(wall_s=wall, fps=n_frames / wall, host_ms=host_ms, dispatch_ms=dispatch_ms, device=kind,
                  busy_share=busy_share)
    return result


if __name__ == "__main__":
    main()
