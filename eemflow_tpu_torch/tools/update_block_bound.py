"""The least time an H100 could take for the RAFT update block that kernel
K5 computes (``kernels/csrc/update_block.cu``; the TPU kernels
``eemflow_tpu/ops/pallas/update_block.py`` ``motion_encoder_fused`` +
``gru_flowhead_fused``), reckoned from its layer shapes: a computed bound,
not a measurement.

Per iteration the two kernels run the motion encoder (convc1 1×1
324→256, convc2 3×3 →192, convf1 7×7 2→128, convf2 3×3 →64, conv 3×3
256→126, concat flow) and the SepConvGRU (1×5 then 5×1 stage, z/r/q gates
over [h, inp, motion]) with the 2-conv flow head, on the 1/8 grid of the
input as ERAFT pads it (``ops/pad.py``'s "chairs" mode at ERAFT's default
``pad_rate`` of 32: 720×1280 → 736×1280, a 92×160 grid).  Bytes count each
input and output of a launch once (the correlation features, flow, net,
inp, the motion features between the two launches, the weights);
operations are 2 per multiply-add.

Both of K5's operand modes run on the tensor cores, so each has its own
bound: float32 mode counts the three TF32 products of its split (big·big +
big·small + small·big, the least that keeps float32 accuracy on these
units) at the TF32 peak (``bound_ms``); bf16 mode its one product at the
bf16 peak (``bf16_bound_ms``).  The float32 SIMT figure (67 TFLOP/s, the
bound before K5 used tensor cores) is kept as ``fp32_simt_ms``.

Usage:
  python -m eemflow_tpu_torch.tools.update_block_bound --size 512 960 -bs 1 --iters 12
"""

from __future__ import annotations

import argparse
import inspect
import json
from typing import Optional, Sequence

from eemflow_tpu_torch.models.eraft import ERAFT
from eemflow_tpu_torch.ops.pad import InputPadder

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, float32 outside
# the tensor cores, TF32 and bf16 on them, FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12
TF32_SPLIT_PRODUCTS = 3


def update_block_convs(hidden: int = 128, context: int = 128, corr_levels: int = 4, corr_radius: int = 4):
    """(name, kh·kw, Cin, Cout) of each conv launch of one iteration, in
    kernel order (z and r of a GRU stage are one 2·hidden-wide conv)."""
    cor = corr_levels * (2 * corr_radius + 1) ** 2
    x = hidden + context + 128  # [h, inp, motion]: conv's 126 channels + the 2 of flow
    return [
        ("convc1 1x1", 1, cor, 256), ("convc2 3x3", 9, 256, 192), ("convf1 7x7", 49, 2, 128),
        ("convf2 3x3", 9, 128, 64), ("conv 3x3", 9, 256, 126),
        ("z|r 1x5", 5, x, 2 * hidden), ("q 1x5", 5, x, hidden),
        ("z|r 5x1", 5, x, 2 * hidden), ("q 5x1", 5, x, hidden),
        ("head1 3x3", 9, hidden, 256), ("head2 3x3", 9, 256, 2),
    ]


def update_block_work(h: int, w: int, batch: int = 1, hidden: int = 128, context: int = 128,
                      corr_levels: int = 4, corr_radius: int = 4):
    """(FLOP, bytes) of one iteration on an h×w grid (the /8 grid)."""
    cor = corr_levels * (2 * corr_radius + 1) ** 2
    motion_out = 128  # conv's 126 channels + the 2 of flow
    convs = update_block_convs(hidden, context, corr_levels, corr_radius)
    pixels = batch * h * w
    macs = sum(k * cin * cout for _, k, cin, cout in convs)
    weights = sum(k * cin * cout + cout for _, k, cin, cout in convs)
    feature_floats = pixels * (
        cor + 2 + motion_out  # motion launch: corr, flow in; motion out
        + hidden + context + motion_out + hidden + 2  # gru launch: net, inp, motion in; net, delta out
    )
    return 2 * macs * pixels, 4 * (weights + feature_floats)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="Computed H100 bound of the RAFT update block (K5)")
    p.add_argument("--size", type=int, nargs=2, default=[512, 960],
                   help="input H W (the grid is 1/8 of the padded input)")
    p.add_argument("-bs", "--batch_size", type=int, default=1)
    p.add_argument("--iters", type=int, default=12)
    args = p.parse_args(argv)
    pad_rate = inspect.signature(ERAFT).parameters["pad_rate"].default
    ph, pw = InputPadder(args.size, mode="chairs", eval_pad_rate=pad_rate).padded_shape
    h, w = ph // 8, pw // 8
    flops, nbytes = update_block_work(h, w, args.batch_size)
    flops *= args.iters
    nbytes *= args.iters
    res = {
        "kernel": "K5 update_block (motion_encoder_fused + gru_flowhead_fused)",
        "grid": [h, w], "batch": args.batch_size, "iters": args.iters,
        "launches": 2 * args.iters, "flop": flops, "bytes": nbytes,
        "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "tf32_split_ms": TF32_SPLIT_PRODUCTS * flops / PEAK_TF32_FLOP_PER_S * 1e3,
        "bf16_tensor_core_ms": flops / PEAK_BF16_FLOP_PER_S * 1e3,
        "fp32_simt_ms": flops / PEAK_FP32_FLOP_PER_S * 1e3,
    }
    res["bound_ms"] = max(res["bytes_ms"], res["tf32_split_ms"])
    res["bound_by"] = "operations" if res["tf32_split_ms"] >= res["bytes_ms"] else "bytes"
    res["bf16_bound_ms"] = max(res["bytes_ms"], res["bf16_tensor_core_ms"])
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
