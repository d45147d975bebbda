"""The least time an H100 could take for the RAFT update block that the
TPU kernel K5 (``eemflow_tpu/ops/pallas/update_block.py``
``motion_encoder_fused`` + ``gru_flowhead_fused``) computes, reckoned from
its layer shapes.  K5 is not ported yet: this is a computed bound, not a
measurement.

Per iteration the two kernels run the motion encoder (convc1 1×1
324→256, convc2 3×3 →192, convf1 7×7 2→128, convf2 3×3 →64, conv 3×3
256→126, concat flow) and the SepConvGRU (1×5 then 5×1 stage, z/r/q gates
over [h, inp, motion]) with the 2-conv flow head, on the 1/8 grid.  Bytes
count each input and output of a launch once (the correlation features,
flow, net, inp, the motion features between the two launches, the
weights); operations are 2 per multiply-add.

Usage:
  python -m eemflow_tpu_torch.tools.update_block_bound --size 512 960 -bs 1 --iters 12
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, float32 outside
# the tensor cores and bf16 on them, FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12


def update_block_work(h: int, w: int, batch: int = 1, hidden: int = 128, context: int = 128,
                      corr_levels: int = 4, corr_radius: int = 4):
    """(FLOP, bytes) of one iteration on an h×w grid (the /8 grid)."""
    cor = corr_levels * (2 * corr_radius + 1) ** 2
    motion_out = 128  # conv's 126 channels + the 2 of flow
    x = context + motion_out
    # (kh*kw, cin, cout) of every conv, in kernel order
    motion = [(1, cor, 256), (9, 256, 192), (49, 2, 128), (9, 128, 64), (9, 256, 126)]
    gru = [(5, hidden + x, hidden)] * 6 + [(9, hidden, 256), (9, 256, 2)]
    convs = motion + gru
    pixels = batch * h * w
    macs = sum(k * cin * cout for k, cin, cout in convs)
    weights = sum(k * cin * cout + cout for k, cin, cout in convs)
    feature_floats = pixels * (
        cor + 2 + motion_out  # motion launch: corr, flow in; motion out
        + hidden + context + motion_out + hidden + 2  # gru launch: net, inp, motion in; net, delta out
    )
    return 2 * macs * pixels, 4 * (weights + feature_floats)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="Computed H100 bound of the RAFT update block (K5)")
    p.add_argument("--size", type=int, nargs=2, default=[512, 960], help="input H W (grid is /8)")
    p.add_argument("-bs", "--batch_size", type=int, default=1)
    p.add_argument("--iters", type=int, default=12)
    args = p.parse_args(argv)
    h, w = args.size[0] // 8, args.size[1] // 8
    flops, nbytes = update_block_work(h, w, args.batch_size)
    flops *= args.iters
    nbytes *= args.iters
    res = {
        "kernel": "K5 update_block (motion_encoder_fused + gru_flowhead_fused)",
        "grid": [h, w], "batch": args.batch_size, "iters": args.iters,
        "launches": 2 * args.iters, "flop": flops, "bytes": nbytes,
        "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "fp32_ms": flops / PEAK_FP32_FLOP_PER_S * 1e3,
        "bf16_tensor_core_ms": flops / PEAK_BF16_FLOP_PER_S * 1e3,
    }
    res["bound_ms"] = max(res["bytes_ms"], res["fp32_ms"])
    res["bound_by"] = "operations" if res["fp32_ms"] >= res["bytes_ms"] else "bytes"
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
