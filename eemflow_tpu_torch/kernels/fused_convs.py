"""K3 wrapper: a fused 3×3 conv chain + average pool on the card
(``csrc/fused_convs.cu``), its plain twin on the CPU.

Replaces ``eemflow_tpu/ops/pallas/fused_convs.py`` ``fused_convs_pool``.
The kernel reads its input through strides (the model's NCHW, or an NHWC
view) and writes NCHW outputs.  A chain whose tiles do not fit in shared
memory is split into two launches at its midpoint, as the JAX function
splits one that does not fit in VMEM; where even one conv does not fit,
the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from eemflow_tpu_torch.kernels import build, launch_counts
from eemflow_tpu_torch.ops.fused_convs import check_args, fused_convs_pool_plain

plain = fused_convs_pool_plain

MAX_CONVS = 8
COT = 8  # output channels per thread (csrc/fused_convs.cu)
# shared memory one block may opt into on sm_90 (227 KB)
MAX_SMEM = 232_448
FIXED_TILE = 16  # tile edge when there is no pool


class _Args(ctypes.Structure):
    """Mirror of ``struct FusedConvsArgs`` in ``csrc/fused_convs.cu``."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("full", ctypes.c_void_p), ("pooled", ctypes.c_void_p),
        ("w", ctypes.c_void_p * MAX_CONVS), ("bias", ctypes.c_void_p * MAX_CONVS),
        ("sb", ctypes.c_longlong), ("sc", ctypes.c_longlong),
        ("sy", ctypes.c_longlong), ("sx", ctypes.c_longlong),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("pool", ctypes.c_int), ("TH", ctypes.c_int), ("TW", ctypes.c_int),
        ("n", ctypes.c_int), ("bf16", ctypes.c_int),
        ("buf1_off", ctypes.c_int), ("pool_off", ctypes.c_int), ("smem_bytes", ctypes.c_int),
        ("cin", ctypes.c_int * (MAX_CONVS + 1)), ("cout", ctypes.c_int * MAX_CONVS),
        ("cout_pad", ctypes.c_int * MAX_CONVS), ("relu", ctypes.c_int * MAX_CONVS),
        ("concat", ctypes.c_int * MAX_CONVS),
    ]


def _library() -> ctypes.CDLL:
    lib = build.load()
    if lib.fused_convs_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("fused_convs_pool: the binding's argument struct differs from the kernel's")
    return lib


def smem_bytes(chain: Sequence[int], tile: Tuple[int, int], pooled: bool) -> Tuple[int, int, int]:
    """(bytes, offset of buffer 1, offset of the pool sums), in floats for
    the offsets: buffer 0 holds the inputs of the even convs, buffer 1 those
    of the odd ones; conv j's input region is the tile grown by n − j
    pixels on each side."""
    n = len(chain) - 1
    th, tw = tile
    caps = [0, 0]
    for j in range(n):
        m = n - j
        caps[j % 2] = max(caps[j % 2], chain[j] * (th + 2 * m) * (tw + 2 * m))
    pool_ch = chain[-1] if pooled else 0
    return 4 * (caps[0] + caps[1] + pool_ch), caps[0], caps[0] + caps[1]


def pack_weight(w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] → [Cin][9][Cout padded to COT], float32
    (values rounded to bf16 in bf16 mode)."""
    cout, cin = w.shape[:2]
    pad = -cout % COT
    p = w.detach().float().permute(1, 2, 3, 0).reshape(cin, 9, cout)
    if bf16:
        p = p.to(torch.bfloat16).float()
    return torch.nn.functional.pad(p, (0, pad)).contiguous()


def pack_bias(b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(b.detach().float(), (0, -b.shape[0] % COT)).contiguous()


def pack_chain(
    weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor], bf16: bool, device
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every conv's (weight, bias) in the kernel's layout on ``device``;
    a caller that runs the same chain again keeps this and passes it as
    ``packed``."""
    return [(pack_weight(w.to(device), bf16), pack_bias(b.to(device))) for w, b in zip(weights, biases)]


def _plan_tile(chain: Sequence[int], pool: Optional[int]) -> Optional[Tuple[int, int]]:
    """The tile the launch uses, or None when the chain does not fit."""
    if pool is not None:
        tiles = [(pool, pool)]
    else:
        tiles = [(t, t) for t in (FIXED_TILE, 8, 4)]
    for tile in tiles:
        if smem_bytes(chain, tile, pool is not None)[0] <= MAX_SMEM:
            return tile
    return None


def _launch(
    x: torch.Tensor,
    pool: Optional[int],
    bf16: bool,
    emit_full: bool,
    relus: Sequence[bool],
    concat: Sequence[bool],
    chain: List[int],
    tile: Tuple[int, int],
    weights: Sequence[torch.Tensor],
    packed: Sequence[Tuple[torch.Tensor, torch.Tensor]],
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    B, _, H, W = x.shape
    n = len(weights)
    c_out = chain[-1]
    dev = x.device
    full = torch.empty((B, c_out, H, W), dtype=torch.float32, device=dev) if emit_full else None
    pooled = (
        torch.empty((B, c_out, H // pool, W // pool), dtype=torch.float32, device=dev)
        if pool is not None else None
    )
    nbytes, buf1, pool_off = smem_bytes(chain, tile, pool is not None)
    a = _Args()
    a.x = x.data_ptr()
    a.full = full.data_ptr() if full is not None else None
    a.pooled = pooled.data_ptr() if pooled is not None else None
    a.sb, a.sc, a.sy, a.sx = x.stride()
    a.B, a.H, a.W = B, H, W
    a.pool = pool or 0
    a.TH, a.TW = tile
    a.n, a.bf16 = n, int(bf16)
    a.buf1_off, a.pool_off, a.smem_bytes = buf1, pool_off, nbytes
    for j, (w, b) in enumerate(packed):
        if w.device != dev or b.device != dev:
            raise ValueError("fused_convs_pool: packed weights must be on the input's device")
        a.w[j] = w.data_ptr()
        a.bias[j] = b.data_ptr()
        a.cout[j] = weights[j].shape[0]
        a.cout_pad[j] = w.shape[-1]
        a.relu[j] = int(relus[j])
        a.concat[j] = int(concat[j])
    for j, c in enumerate(chain):
        a.cin[j] = c
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    rc = lib.fused_convs_launch(ctypes.byref(a), ctypes.c_void_p(stream))
    build.check(rc, "fused_convs_pool")
    launch_counts["fused_convs_pool"] += 1
    return full, pooled


def fused_convs(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    pool: Optional[int],
    compute_dtype: torch.dtype = torch.float32,
    emit_full: bool = True,
    relus: Optional[Sequence[bool]] = None,
    concat: Optional[Sequence[bool]] = None,
    packed: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """x [B, C, H, W] float32, any strides; OIHW weights; ``packed`` from
    ``pack_chain`` (made here when None).  Returns NCHW (full or None,
    pooled or None)."""
    if x.device.type == "cpu":
        return plain(x, weights, biases, pool, compute_dtype, emit_full, relus, concat)
    if x.device.type != "cuda":
        raise ValueError(f"fused_convs_pool: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError("fused_convs_pool: float32 input only")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_convs_pool: compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    relus, concat, chain = check_args(tuple(x.shape), weights, biases, pool, emit_full, relus, concat)
    if len(weights) > MAX_CONVS:
        raise ValueError(f"fused_convs_pool: at most {MAX_CONVS} convs per chain")
    bf16 = compute_dtype == torch.bfloat16
    if packed is None:
        packed = pack_chain(weights, biases, bf16, x.device)
    if len(packed) != len(weights):
        raise ValueError("fused_convs_pool: one packed (weight, bias) per conv")
    tile = _plan_tile(chain, pool)
    if tile is None:
        n = len(weights)
        if n == 1:
            raise ValueError(
                f"fused_convs_pool: one conv with channels {chain} and pool {pool} does not fit "
                f"in {MAX_SMEM} bytes of shared memory"
            )
        s = n // 2
        mid, _ = fused_convs(x, weights[:s], biases[:s], None, compute_dtype, True,
                             relus[:s], concat[:s], packed[:s])
        return fused_convs(mid, weights[s:], biases[s:], pool, compute_dtype, emit_full,
                           relus[s:], concat[s:], packed[s:])
    return _launch(x, pool, bf16, emit_full, relus, concat, chain, tile, weights, packed)
