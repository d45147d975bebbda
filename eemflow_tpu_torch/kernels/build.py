"""Build the port's CUDA kernels: one ``nvcc -c`` per source, all started
together, then one link into a C-ABI shared library loaded with
``ctypes``.

No ``torch.utils.cpp_extension``, no PyTorch headers, no pybind and no
ninja: a source that includes PyTorch's headers takes minutes to compile,
a plain C interface seconds.  The library goes into ``_build/`` next to
this file (git-ignored); its name carries a hash of the sources and the
flags, so an edited source builds anew and a built one is reused.  The
build runs at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
SOURCES = ("voxel_scatter.cu", "local_corr.cu", "fused_convs.cu", "coarse_head.cu", "update_block.cu")
ARCH = "sm_90a"
COMPILE_FLAGS = (
    "-gencode", f"arch=compute_90a,code={ARCH}",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared", "-gencode", f"arch=compute_90a,code={ARCH}")

_lib: Optional[ctypes.CDLL] = None
# what this process's build printed (``-Xptxas -v``: registers, spills)
# and how long it took; empty when the library was already built
build_log = ""
build_seconds = 0.0


def source_paths() -> List[str]:
    return [os.path.join(CSRC, s) for s in SOURCES]


def library_path() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in source_paths():
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libeemflow_kernels-{h.hexdigest()[:16]}.so")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def nvcc_commands(out_path: str, nvcc: str = "nvcc") -> Tuple[List[List[str]], List[str]]:
    """(one compile command per source, the link command) for a library
    at ``out_path``; the objects go beside it."""
    objs = [f"{out_path}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    compiles = [[nvcc, *COMPILE_FLAGS, "-c", "-o", o, src] for o, src in zip(objs, source_paths())]
    return compiles, [nvcc, *LINK_FLAGS, "-o", out_path, *objs]


def build() -> str:
    """Compile the library if it is missing; returns its path."""
    global build_log, build_seconds
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    compiles, link = nvcc_commands(tmp, find_nvcc())
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in compiles
    ]
    logs = []
    failed = []
    try:
        for cmd, proc in zip(compiles, procs):
            out, _ = proc.communicate(timeout=600)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(cmd[-1])} ({proc.returncode})")
    finally:
        for proc in procs:  # a timeout leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True, timeout=600)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode})")
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for cmd in compiles:
        obj = cmd[cmd.index("-o") + 1]
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{build_log}")
    # atomic rename: a half-written library is never loadable
    os.replace(tmp, so)
    return so


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.voxel_scatter_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.voxel_scatter_launch.restype = i
    lib.local_corr_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, f, p]
    lib.local_corr_launch.restype = i
    lib.fused_convs_launch.argtypes = [p, p]
    lib.fused_convs_launch.restype = i
    lib.coarse_head_launch.argtypes = [p, p]
    lib.coarse_head_launch.restype = i
    lib.update_block_motion_launch.argtypes = [p, p]
    lib.update_block_motion_launch.restype = i
    lib.update_block_gru_launch.argtypes = [p, p]
    lib.update_block_gru_launch.restype = i
    lib.fused_convs_args_size.restype = i
    lib.coarse_head_args_size.restype = i
    lib.update_block_args_size.restype = i
    lib.eemflow_error_string.argtypes = [i]
    lib.eemflow_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        _declare(lib)
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = load().eemflow_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} ({msg})")
