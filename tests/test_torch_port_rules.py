"""Rules of the PyTorch port that hold without a card: it imports nothing
of JAX or of the JAX package, nor ``cv2`` or ``pandas`` (not on the
card's path), and ``h5py`` (which the card's machine lacks) at most inside
a host-only function, never when a module is imported; its entry points
refuse to fall back from
the card to the CPU, ``chip_smoke.py`` fails where there is no card, and
the kernel build targets ``sm_90a`` into a git-ignored directory."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "eemflow_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "eemflow_tpu", "cv2", "pandas")
# packages a port module may import only inside a function (the offline
# MVSEC encoder reads the raw recordings through h5py), so the import of
# every module must succeed without them
BLOCKED_AT_IMPORT = FORBIDDEN + ("h5py",)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py")]
    return out


def _module_name(path):
    rel = os.path.relpath(path, REPO)[: -len(".py")]
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_port_sources_import_no_jax():
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{os.path.relpath(path, REPO)}:{node.lineno} imports {bad}"


BLOCKER = r"""
import importlib, importlib.abc, sys
FORBIDDEN = {forbidden!r}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Blocker())
for mod in {modules!r}:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not leaked, leaked
print("imported", len({modules!r}), "modules")
"""


def test_port_imports_with_jax_blocked():
    modules = [_module_name(p) for p in _port_files()]
    assert "eemflow_tpu_torch.tools.test_mvsec" in modules and "eemflow_tpu_torch.data.mvsec" in modules
    assert {f"eemflow_tpu_torch.models.{m}" for m in ("gma", "skflow", "kpaflow")} <= set(modules)
    code = BLOCKER.format(forbidden=BLOCKED_AT_IMPORT, modules=modules)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"imported {len(modules)} modules" in proc.stdout


def test_resolve_device_refuses_to_fall_back(monkeypatch):
    from eemflow_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    for req in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(req)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cli_without_card_raises(monkeypatch):
    from eemflow_tpu_torch.tools.test_hrem import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--checkpoint", "unused.pth.tar", "--data_root", "unused"])


def test_chip_smoke_fails_without_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_wrappers_refuse_other_devices():
    from eemflow_tpu_torch.kernels.local_corr import local_corr
    from eemflow_tpu_torch.kernels.voxel_scatter import voxel_scatter

    x = torch.empty(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        local_corr(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        voxel_scatter(torch.empty(1, 128, 4, device="meta"),
                      torch.empty(1, dtype=torch.int32, device="meta"), 5, 4, 4)


def test_fused_kernel_wrappers_refuse_other_devices():
    from eemflow_tpu_torch.kernels.coarse_head import coarse_head_fused
    from eemflow_tpu_torch.kernels.fused_convs import fused_convs
    from eemflow_tpu_torch.ops.coarse_head import HeadWeights

    x = torch.empty(1, 8, 16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_convs(x, [torch.empty(8, 8, 3, 3)], [torch.empty(8)], 8)
    f = [torch.empty(1, 2, 3, c, device="meta") for c in (16, 32, 64)]
    with pytest.raises(ValueError, match="unsupported device"):
        coarse_head_fused(f, f, HeadWeights({}, 5), (0,), 4)


def test_update_block_wrapper_refuses_other_devices():
    from eemflow_tpu_torch.kernels.update_block import update_gru, update_motion
    from eemflow_tpu_torch.models.raft_core import BasicUpdateBlock
    from eemflow_tpu_torch.ops.update_block import make_fused_update

    fused = make_fused_update(BasicUpdateBlock())
    t = lambda c: torch.empty(1, 4, 4, c, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        update_motion(t(324), t(2), fused)
    with pytest.raises(ValueError, match="unsupported device"):
        update_gru(t(128), t(128), t(128), fused)


def test_build_targets_sm90a_into_an_ignored_directory():
    from eemflow_tpu_torch.kernels import build

    compiles, link = build.nvcc_commands("out.so")
    for cmd in compiles:
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3", "-c", "-fPIC", "-v"):
            assert flag in cmd
    # one compile per source, all five kernels (K3 on the tensor cores, one
    # route for every chain; K5's conv in one file per operand mode), linked
    # once into out.so
    assert [c[-1] for c in compiles] == build.source_paths()
    assert [os.path.basename(p) for p in build.source_paths()] == [
        "voxel_scatter.cu", "local_corr.cu", "fused_convs_tc.cu", "coarse_head.cu",
        "update_block.cu", "update_block_tf32.cu", "update_block_bf16.cu"]
    assert link[link.index("-o") + 1] == "out.so" and "-shared" in link
    assert [c[c.index("-o") + 1] for c in compiles] == [p for p in link if p.endswith(".o")]
    assert all(os.path.exists(s) for s in build.source_paths())
    lib = build.library_path()
    assert os.path.dirname(lib) == build.BUILD_DIR and lib.endswith(".so")
    rel = os.path.relpath(lib, REPO)
    proc = subprocess.run(["git", "check-ignore", "-q", rel], cwd=REPO, capture_output=True)
    if proc.returncode == 128:  # not a git work tree: read the ignore file
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert "eemflow_tpu_torch/kernels/_build/" in f.read().split()
    else:
        assert proc.returncode == 0, f"{rel} is not git-ignored"
