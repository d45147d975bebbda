"""Hand-written Hopper kernels of the port, built by plain ``nvcc`` into
one C-ABI shared library (``build.py``) and bound with ``ctypes``.

  * K1 ``voxel_scatter`` — event → voxel-grid scatter
    (replaces ``eemflow_tpu/ops/pallas/voxel_scatter.py`` ``voxel_scatter_pallas``);
  * K2 ``local_corr`` — windowed local correlation
    (replaces ``eemflow_tpu/ops/pallas/local_corr.py`` ``local_correlation_pallas``);
  * K3 ``fused_convs_pool`` — a 3×3 conv chain + average pool
    (replaces ``eemflow_tpu/ops/pallas/fused_convs.py`` ``fused_convs_pool``);
  * K4 ``coarse_head`` — EEMFlow's whole coarse stage
    (replaces ``eemflow_tpu/ops/pallas/coarse_head.py`` ``coarse_head``).

Each wrapper sends a CPU tensor to its plain PyTorch twin and a CUDA tensor
to its kernel, and adds one to ``launch_counts[name]`` per kernel launch,
so a run can show that its main path went through the kernels.
"""

launch_counts = {"voxel_scatter": 0, "local_corr": 0, "fused_convs_pool": 0, "coarse_head": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
