"""Hand-written Hopper kernels of the port, built by plain ``nvcc`` into
one C-ABI shared library (``build.py``) and bound with ``ctypes``.

  * K1 ``voxel_scatter`` / ``voxelize`` — events → voxel grid, without or
    with its normalization, the grid written once by tiles
    (replaces ``eemflow_tpu/ops/pallas/voxel_scatter.py`` ``voxel_scatter_pallas``);
  * K2 ``local_corr`` / ``local_corr_levels`` — windowed local correlation,
    up to three levels in one launch
    (replaces ``eemflow_tpu/ops/pallas/local_corr.py`` ``local_correlation_pallas``);
  * K3 ``fused_convs_pool`` — a 3×3 conv chain (concat, grouped and
    shuffled convs included) + average pool on the tensor cores
    (replaces ``eemflow_tpu/ops/pallas/fused_convs.py`` ``fused_convs_pool``);
  * K4 ``coarse_head`` — EEMFlow's whole coarse stage, one thread-block
    cluster per level
    (replaces ``eemflow_tpu/ops/pallas/coarse_head.py`` ``coarse_head``);
  * K5 ``update_block`` — the RAFT update block without its mask head, two
    entry points per iteration (replaces ``eemflow_tpu/ops/pallas/
    update_block.py`` ``motion_encoder_fused`` and ``gru_flowhead_fused``).

Each wrapper sends a CPU tensor to its plain PyTorch twin and a CUDA tensor
to its kernel, and adds one to ``launch_counts[name]`` per kernel launch
(K5: per entry call), so a run can show that its main path went through
the kernels.  K2 has a backward (``autograd.Function``, the twin's
autograd, as the JAX custom VJP is XLA's); the others are eval-only and
refuse, on the card, an input that would need one (``refuse_grad``).
"""

import torch

launch_counts = {
    "voxel_scatter": 0, "local_corr": 0, "fused_convs_pool": 0,
    "coarse_head": 0, "update_block": 0,
    # not a launch: inputs K5's wrapper had to copy into a layout its
    # loader reads (0 on ERAFT's main path)
    "update_block_relayout": 0,
}


# operand dtypes of the fused modes (K3's ``fast_pyramid_dtype``, K5's
# ``fused_dtype``), by the name a config gives
COMPUTE_DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: an eval-only
    kernel has no backward, and its output would silently drop the
    gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel is eval-only and has no backward; call it under "
            "torch.no_grad() or torch.inference_mode(), or train on the standard path"
        )


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, the stream a
    wrapper launches on, read without building a ``torch.cuda.Stream``
    object (which costs a host-bound wrapper several microseconds a call)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
