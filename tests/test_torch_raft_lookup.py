"""ERAFT's stacked lookup, RAFT and ``upflow8`` in the port against the JAX
package on the CPU: ``build_corr_stack`` and ``lookup_corr_stack`` against
JAX's stacked lookup and the port's per-level lookup (levels down to 1×1
and 1-wide), with their gradients; the stacked lookup's tap weights
against JAX's ``_tap_matrix``; ERAFT with ``stacked_lookup`` (the module
path and K5's plain version) against JAX's; RAFT at 3 and 5 input
channels against JAX's; ``upflow8``; RAFT's registry entry, converter and
checkpoint loading; and the HREM eval CLI with ``-model raft`` and
ERAFT's ``stacked_lookup`` from ``--config``.

Tolerances: the lookups 2e-5 absolute on correlations of order 1 (the
same bilinear weights and order of sums; JAX contracts dense tap matrices
of zeros around them, which adds exact zeros); their gradients 2e-5 of
the largest; the flows of ERAFT and RAFT after 3 iterations as
``tests/test_torch_eraft.py`` (1e-4 on flows of order 1: float32 in other
summation orders through every iteration) for ERAFT, and 2e-5 of
max(1, largest |flow|) for RAFT, whose inputs normalised to [-1, 1] keep
its flows small; ``upflow8`` 1e-6 (the same interpolation).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eemflow_tpu.models.eraft import ERAFT as JaxERAFT
from eemflow_tpu.models.raft import RAFT as JaxRAFT
from eemflow_tpu.ops import corr_block as jax_corr
from eemflow_tpu.ops.upsample import upflow8 as jax_upflow8

from eemflow_tpu_torch.compat.from_jax import eraft_state_dict_from_jax, raft_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
from eemflow_tpu_torch.data.hrem import HREMEventFlow
from eemflow_tpu_torch.events.io import write_flo
from eemflow_tpu_torch.models.raft import RAFT
from eemflow_tpu_torch.models.registry import get_eval_model, get_model
from eemflow_tpu_torch.ops import corr_block
from eemflow_tpu_torch.ops.upsample import upflow8
from eemflow_tpu_torch.tools.test_hrem import main as hrem_cli
from eemflow_tpu_torch.train.adapters import get_family

LOOKUP_TOL = 2e-5
FLOW_TOL = 1e-4
RAFT_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, H, W, C, levels): ERAFT's 4 levels down to 1×1; 5 levels whose last
# three repeat a 1×2 level; a 1-wide grid (every level Wl == 1)
PYRAMIDS = {"levels4": (1, 8, 12, 16, 4), "levels5_1x2": (2, 6, 9, 8, 5), "width1": (1, 5, 1, 8, 3)}


def _pyramid_case(case):
    B, H, W, C, L = PYRAMIDS[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    f1, f2 = (rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(2))
    # coordinates across the grid and past its edges, on and off the cells
    coords = (rng.random((B, H, W, 2)) * np.array([W, H]) * 1.4 - 2).astype(np.float32)
    coords[0, 0, 0] = (0.0, 0.0)
    return f1, f2, coords, L


@pytest.mark.parametrize("case", sorted(PYRAMIDS))
def test_corr_stack_and_lookup_match_jax(case):
    f1, f2, coords, L = _pyramid_case(case)
    jp = jax_corr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), L)
    pp = corr_block.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), L)
    stack, shapes = corr_block.build_corr_stack(pp)
    jstack, jshapes = jax_corr.build_corr_stack(jp)
    assert shapes == [tuple(s) for s in jshapes] and stack.shape == jstack.shape
    np.testing.assert_allclose(stack.numpy(), np.asarray(jstack), rtol=0, atol=LOOKUP_TOL)
    got = corr_block.lookup_corr_stack(stack, shapes, torch.from_numpy(coords)).numpy()
    want = np.asarray(jax.jit(jax_corr.lookup_corr_pyramid_stacked)(jp, jnp.asarray(coords)))
    per_level = corr_block.lookup_corr_pyramid(pp, torch.from_numpy(coords)).numpy()
    assert got.shape == want.shape == (*coords.shape[:3], L * 81)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOOKUP_TOL)
    np.testing.assert_allclose(got, per_level, rtol=0, atol=LOOKUP_TOL)
    one = corr_block.lookup_corr_pyramid_stacked(pp, torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(one, got)


@pytest.mark.parametrize("case", ["levels4", "levels5_1x2"])
def test_stacked_lookup_gradient(case):
    """The feature maps' gradients through the pyramid, the stack and the
    lookup: against the per-level lookup's and JAX's stacked lookup's."""
    f1, f2, coords, L = _pyramid_case(case)
    w = np.random.default_rng(7).standard_normal((*coords.shape[:3], L * 81)).astype(np.float32)

    def port(stacked):
        a, b = (torch.from_numpy(x).requires_grad_() for x in (f1, f2))
        pyr = corr_block.build_corr_pyramid(a, b, L)
        lookup = corr_block.lookup_corr_pyramid_stacked if stacked else corr_block.lookup_corr_pyramid
        (lookup(pyr, torch.from_numpy(coords)) * torch.from_numpy(w)).sum().backward()
        return a.grad.numpy(), b.grad.numpy()

    def jax_loss(a, b):
        pyr = jax_corr.build_corr_pyramid(a, b, L)
        return jnp.sum(jax_corr.lookup_corr_pyramid_stacked(pyr, jnp.asarray(coords)) * w)

    want = [np.asarray(g) for g in jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jnp.asarray(f1), jnp.asarray(f2))]
    got, per_level = port(True), port(False)
    for g, p, j in zip(got, per_level, want):
        scale = np.abs(j).max()
        assert scale > 0
        np.testing.assert_allclose(g, j, rtol=0, atol=LOOKUP_TOL * scale)
        np.testing.assert_allclose(g, p, rtol=0, atol=LOOKUP_TOL * scale)


def test_stack_taps_are_jax_tap_matrices():
    """Every level's (cell, weight) pairs, written out as a dense [N, taps,
    size] matrix, are JAX's ``_tap_matrix``: bilinear weights with the zero
    padding of a separable window, and every tap on cell 0 with weight 1
    on a size-1 axis."""
    shapes = [(9, 12), (5, 6), (3, 1), (1, 1)]
    consts = corr_block._stack_consts(shapes, 9, 12, 4, torch.device("cpu"))
    pos = np.array([-3.5, 0.0, 0.25, 5.0, 11.75, 14.2], np.float32)
    offs = jnp.arange(-4, 5, dtype=jnp.float32)
    for axis, (last, one) in enumerate(((consts["x_last"], consts["x_one"]), (consts["y_last"], consts["y_one"]))):
        idx, wts = corr_block._stack_taps(torch.from_numpy(pos), consts, last, one)
        for lvl, hw in enumerate(shapes):
            size = hw[1 - axis]
            dense = np.zeros((len(pos), 9, size), np.float32)
            for k in range(2):
                np.add.at(dense, (np.arange(len(pos))[:, None], np.arange(9)[None], idx[:, lvl, :, k].numpy()),
                          wts[:, lvl, :, k].numpy())
            p = jnp.asarray(pos) * 0.5 ** lvl
            want = (jax_corr._tap_matrix(jnp.zeros_like(p), jnp.zeros_like(offs), size) if size == 1
                    else jax_corr._tap_matrix(p, offs, size))
            np.testing.assert_allclose(dense, np.asarray(want), rtol=0, atol=1e-7, err_msg=f"axis {axis} level {lvl}")


def _raft_variables(model, shape, seed=11):
    """RAFT-lineage variables drawn as the JAX init draws them (``tests/
    test_torch_eraft.py``), shapes from ``eval_shape``."""
    ev = jnp.zeros((1, *shape))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), ev, ev)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            kh, kw, cin, cout = s.shape
            if keys[1] in ("fnet", "cnet"):
                var = 2.0 / (kh * kw * cout)
            elif "gru" in keys:
                var = 1.0 / (kh * kw * cin)
            else:
                var = 2.0 / (kh * kw * cin)
            return (rng.standard_normal(s.shape) * np.sqrt(var)).astype(np.float32)
        if keys[-1] in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def eraft_stacked():
    """JAX ERAFT with ``stacked_lookup`` (eval mode, 3 iterations, 64×96:
    a 4th level of 1×1), its variables and its flow."""
    variables = _raft_variables(JaxERAFT(iters=1), (64, 96, 5))
    rng = np.random.default_rng(12)
    ev1, ev2 = (rng.standard_normal((1, 64, 96, 5)).astype(np.float32) for _ in range(2))
    m = JaxERAFT(iters=3, upsample_all=False, stacked_lookup=True)
    _, flows = jax.jit(m.apply)(variables, jnp.asarray(ev1), jnp.asarray(ev2))
    return variables, (ev1, ev2), np.asarray(flows)


@pytest.mark.parametrize("fused_update", [False, True], ids=["module", "fused_update"])
def test_eraft_stacked_lookup_matches_jax(eraft_stacked, fused_update):
    variables, (ev1, ev2), want = eraft_stacked
    models = {}
    for stacked in (True, False):
        models[stacked] = get_eval_model("eraft", iters=3, stacked_lookup=stacked, fused_update=fused_update)
        models[stacked].load_state_dict(eraft_state_dict_from_jax(variables))
    with torch.no_grad():
        got, per_level = (models[s](torch.from_numpy(ev1), torch.from_numpy(ev2))[1].numpy() for s in (True, False))
    assert got.shape == want.shape == (1, 1, 64, 96, 2) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL)
    np.testing.assert_allclose(got, per_level, rtol=0, atol=FLOW_TOL)


def test_eraft_stacked_lookup_trains_like_the_per_level_lookup():
    """One training forward and backward (BatchNorm in training mode, every
    iteration's prediction): the stacked lookup's loss and gradients are
    the per-level lookup's."""
    rng = np.random.default_rng(13)
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((2, 32, 64, 5)).astype(np.float32)) for _ in range(2))
    sd = get_model("eraft").state_dict()
    grads = {}
    for stacked in (False, True):
        model = get_model("eraft", iters=2, stacked_lookup=stacked)
        model.load_state_dict(sd)
        _, flows = model.train()(ev1, ev2, train=True)
        flows.square().mean().backward()
        grads[stacked] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads[False].items():
        assert torch.allclose(grads[True][n], g, rtol=0, atol=1e-5 * float(g.abs().max()) + 1e-12), n


@pytest.mark.parametrize("channels", [3, 5])
def test_raft_matches_jax(channels):
    """RAFT (eval mode, 3 iterations) on a 44×76 input (sintel-padded to
    48×80) of values in [0, 255], against JAX's RAFT on the same variables."""
    variables = _raft_variables(JaxRAFT(iters=1), (44, 76, channels), seed=20 + channels)
    rng = np.random.default_rng(channels)
    im1, im2 = (rng.uniform(0, 255, (1, 44, 76, channels)).astype(np.float32) for _ in range(2))
    m = JaxRAFT(iters=3, upsample_all=False)
    (j1, _), want = jax.jit(m.apply)(variables, jnp.asarray(im1), jnp.asarray(im2))
    model = get_eval_model("raft", iters=3, n_first_channels=channels)
    assert model.upsample_all is False
    model.load_state_dict(raft_state_dict_from_jax(variables))
    with torch.no_grad():
        (n1, _), got = model(torch.from_numpy(im1), torch.from_numpy(im2))
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 1, 44, 76, 2)
    np.testing.assert_allclose(n1.numpy(), np.asarray(j1), rtol=0, atol=1e-6)  # 2·x/255 − 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RAFT_TOL * max(1.0, np.abs(want).max()))


def test_upflow8_matches_jax():
    flow = np.random.default_rng(2).standard_normal((2, 5, 7, 2)).astype(np.float32)
    got = upflow8(torch.from_numpy(flow)).numpy()
    want = np.asarray(jax_upflow8(jnp.asarray(flow)))
    assert got.shape == want.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_raft_registry_converter_and_checkpoint(tmp_path):
    """``raft`` in the registry (eval mode: the mask head once) and in the
    two-volume family; JAX RAFT variables carried across with ERAFT's
    converter, ``batch_stats`` into the BatchNorm buffers; a released-style
    checkpoint (``module.`` prefixes, ``state_dict`` wrapper) loaded
    strictly with ERAFT's layout."""
    assert get_eval_model("raft").upsample_all is False and get_model("raft").upsample_all is True
    assert get_family("raft").name == "two_volume"
    variables = _raft_variables(JaxRAFT(iters=1), (32, 48, 3))
    variables["batch_stats"] = jax.tree_util.tree_map(lambda v: v + 0.5, variables["batch_stats"])
    sd = raft_state_dict_from_jax(variables)
    model = RAFT()
    model.load_state_dict(sd, strict=True)
    assert float(model.cnet.norm1.running_mean[0]) == 0.5
    assert torch.equal(model.cnet.layer2[0].norm3.running_var, model.cnet.layer2[0].downsample[1].running_var)
    path = str(tmp_path / "raft.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, path)
    other = RAFT()
    load_model_checkpoint(other, path, "raft")
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k


SENSOR = (64, 128)


def _eval_split(base, seed=3, n_events=3000):
    """A synthetic HREM test split (one sequence, one sample) at a 64×128 sensor."""
    rng = np.random.default_rng(seed)
    h, w = SENSOR
    d = os.path.join(base, "hrem", "test", "dt1", "indoor_fast", "00000")
    os.makedirs(d)
    for name in ("events1.npz", "events2.npz"):
        np.savez(os.path.join(d, name), x=rng.integers(0, w, n_events).astype(np.int32),
                 y=rng.integers(0, h, n_events).astype(np.int32),
                 t=np.sort(rng.integers(0, 10**9, n_events)).astype(np.int64),
                 p=rng.integers(0, 2, n_events).astype(np.int8))
    write_flo((rng.standard_normal((h, w, 2)) * 2).astype(np.float32), os.path.join(d, "flow.flo"))
    return os.path.join(base, "hrem")


def test_hrem_eval_cli_raft_and_stacked_lookup(tmp_path, monkeypatch):
    """``test_hrem -model raft`` builds RAFT at the data's 5 bins and runs a
    checkpoint of it; ``-model eraft --config {"stacked_lookup": true}``
    gives the per-level lookup's AEE.  (A 64×128 sensor, the dataset's class
    attributes, so that the CPU run takes a second.)"""
    monkeypatch.setattr(HREMEventFlow, "image_height", SENSOR[0])
    monkeypatch.setattr(HREMEventFlow, "image_width", SENSOR[1])
    root = _eval_split(str(tmp_path))
    aee = {}
    for name, cfg in (("raft", {"iters": 2}), ("eraft", {"iters": 2}), ("eraft", {"iters": 2, "stacked_lookup": True})):
        ckpt = tmp_path / f"{name}.pth.tar"
        if not ckpt.exists():
            torch.manual_seed(0)
            torch.save({"state_dict": get_model(name, n_first_channels=5).state_dict()}, ckpt)
        path = tmp_path / f"{name}_{len(cfg)}.json"
        path.write_text(json.dumps(cfg))
        res = hrem_cli(["-model", name, "--data_root", root, "--checkpoint", str(ckpt), "--config", str(path),
                        "--device", "cpu", "--save_dir", str(tmp_path / "out")])
        aee[(name, len(cfg))] = res["mean"]["AEE"]
    assert all(np.isfinite(v) for v in aee.values())
    assert abs(aee[("eraft", 2)] - aee[("eraft", 1)]) <= 1e-5
