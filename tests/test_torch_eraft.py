"""The port's ERAFT (``models/eraft.py``) against the JAX ERAFT on the same
numpy-seeded weights, drawn as the JAX model's init draws them, carried
across by ``eraft_state_dict_from_jax``, on numpy-seeded event volumes; the
ERAFT golden checkpoint loads strictly and runs through the port's HREM
eval CLI at protocol resolution (720×1280) with ``--config``,
``--max_samples`` and ``--stride``; the tools' ERAFT modes; K5's computed
bound takes ERAFT's padded grid.  On the CPU ``fused_update`` runs K5's
plain version.  Final flows agree within 1e-4 (float32 on both sides, the
refinement loop carrying summation-order differences through every
iteration)."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eemflow_tpu.models.eraft import ERAFT as JaxERAFT
from test_golden_acceptance import ERAFT_CKPT, ERAFT_GOLDEN, make_hrem_fixture

from eemflow_tpu_torch.compat.from_jax import eraft_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
from eemflow_tpu_torch.models.eraft import ERAFT, coords_grid
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model
from eemflow_tpu_torch.tools.test_hrem import main as hrem_cli


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLOW_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_variables():
    """Variables of the JAX ERAFT (shapes from ``eval_shape``, no JAX init
    run) drawn from a numpy seed with the JAX init's distributions: conv
    kernels normal with variance 2/fan_out in the encoders (``kaiming_out``),
    1/fan_in in the GRU (flax's default) and 2/fan_in elsewhere
    (``kaiming_in``); zero biases; BatchNorm at its init statistics.  (With
    larger GRU weights and random biases the 3-iteration flows reach the
    same size but amplify float32 summation-order differences past 1e-4.)"""
    ev = jnp.zeros((1, 40, 56, 5))
    shapes = jax.eval_shape(JaxERAFT(iters=1).init, jax.random.PRNGKey(0), ev, ev)
    rng = np.random.default_rng(11)

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
def port_state_dict(jax_variables):
    return eraft_state_dict_from_jax(jax_variables)


def _events(seed, h, w):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, w, 5)).astype(np.float32) for _ in range(2)]


def _port_flows(model, ev1, ev2):
    with torch.no_grad():
        _, flows = model(torch.from_numpy(ev1), torch.from_numpy(ev2))
    return flows.numpy()


@pytest.fixture(scope="module")
def jax_eval_flow(jax_variables):
    ev1, ev2 = _events(12, 64, 96)
    m = JaxERAFT(iters=3, upsample_all=False)
    _, flows = jax.jit(m.apply)(jax_variables, jnp.asarray(ev1), jnp.asarray(ev2))
    return np.asarray(flows)


@pytest.mark.parametrize("fused_update", [False, True], ids=["standard", "fused_update"])
def test_eraft_matches_jax(port_state_dict, jax_eval_flow, fused_update):
    """64×96, 3 iterations, eval mode (the mask head once, on the final
    net): the module path and K5's plain version against the JAX module
    path.  The grid is 8×12, whose 4th correlation level is 1×1."""
    model = get_eval_model("eraft", iters=3, fused_update=fused_update)
    assert model.upsample_all is False
    model.load_state_dict(port_state_dict, strict=True)
    got = _port_flows(model, *_events(12, 64, 96))
    assert got.shape == jax_eval_flow.shape == (1, 1, 64, 96, 2)
    assert np.isfinite(got).all() and np.abs(jax_eval_flow).max() > 0.1
    np.testing.assert_allclose(got, jax_eval_flow, rtol=0, atol=FLOW_TOL)


@pytest.fixture(scope="module")
def jax_all_flows(jax_variables):
    ev1, ev2 = _events(13, 40, 56)
    m = JaxERAFT(iters=3, upsample_all=True)
    _, flows = jax.jit(m.apply)(jax_variables, jnp.asarray(ev1), jnp.asarray(ev2))
    return np.asarray(flows)


@pytest.mark.parametrize("fused_update", [False, True], ids=["standard", "fused_update"])
def test_eraft_all_iterations_match_jax(port_state_dict, jax_all_flows, fused_update):
    """40×56 (padded to 64×64), ``upsample_all=True``: every iteration's
    upsampled prediction."""
    model = ERAFT(iters=3, upsample_all=True, fused_update=fused_update).eval()
    model.load_state_dict(port_state_dict, strict=True)
    got = _port_flows(model, *_events(13, 40, 56))
    assert got.shape == jax_all_flows.shape == (3, 1, 40, 56, 2)
    np.testing.assert_allclose(got, jax_all_flows, rtol=0, atol=FLOW_TOL)


def test_golden_checkpoint_loads_strictly():
    model = get_eval_model("eraft")
    sd = to_state_dict(load_torch_checkpoint(ERAFT_CKPT))
    assert any(k.endswith("downsample.1.running_mean") for k in sd)
    assert any(k.endswith("norm3.running_mean") for k in sd) and "update_block.mask.2.weight" in sd
    model.load_state_dict(sd, strict=True)


def test_model_fields_and_registry():
    assert fast_eval_kwargs("eraft") == {}
    assert get_eval_model("eraft", upsample_all=True).upsample_all
    assert ERAFT(stacked_lookup=True).stacked_lookup
    with pytest.raises(ValueError):
        ERAFT(fused_dtype="float16")
    g = coords_grid(2, 3, 4)
    assert tuple(g.shape) == (2, 3, 4, 2) and g[0, 2, 3].tolist() == [3.0, 2.0]


def test_fused_update_follows_in_place_edits(port_state_dict):
    """K5's plain version reads the update block's parameters themselves
    and its kernel layout is repacked when one changes (``PackCache``): an
    in-place edit reaches the next fused forward."""
    fused = get_eval_model("eraft", iters=2, fused_update=True)
    std = get_eval_model("eraft", iters=2)
    for m in (fused, std):
        m.load_state_dict(port_state_dict)
    ev = _events(14, 40, 56)
    _port_flows(fused, *ev)
    for m in (fused, std):
        with torch.no_grad():
            m.update_block.flow_head.conv2.weight.mul_(1.5)
    np.testing.assert_allclose(_port_flows(fused, *ev), _port_flows(std, *ev), rtol=0, atol=FLOW_TOL)


def test_cli_eraft_config_max_samples_stride(tmp_path, monkeypatch):
    """One CLI run on the seed-99 split's two samples with ``--config``
    ``{"iters": 2, "fused_update": true}``, ``--stride 2`` and
    ``--max_samples 1``: one sample, whose two iterations went through K5's
    entry points (its plain version here), at an AEE that is not the
    12-iteration golden one.  (The golden AEE is checked on the card by
    ``chip_smoke.py`` and for the JAX package by
    ``test_golden_acceptance.py``.)"""
    from eemflow_tpu_torch.kernels import update_block as k5

    with open(ERAFT_GOLDEN) as f:
        golden = json.load(f)
    root = make_hrem_fixture(str(tmp_path / "data"), seed=golden["fixture_seed"])
    calls = []
    real = k5.update_motion
    monkeypatch.setattr(k5, "update_motion", lambda *a: calls.append(a[0].shape) or real(*a))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"iters": 2, "fused_update": True}))
    out = tmp_path / "out"
    res = hrem_cli([
        "-model", "eraft", "-int", "dt1", "--data_root", root, "--checkpoint", ERAFT_CKPT,
        "--save_dir", str(out), "--save_csv", "--device", "cpu", "--config", str(cfg),
        "--stride", "2", "--max_samples", "1",
    ])
    with open(os.path.join(str(out), "eraft_dt1", "test_epe_per_sample.csv")) as f:
        rows = list(csv.DictReader(f))
    assert res["indoor_fast"]["n_samples"] == len(rows) == 1
    assert calls == [(1, 92, 160, 324)] * 2
    assert np.isfinite(res["mean"]["AEE"]) and abs(res["mean"]["AEE"] - golden["aee"]) > 1e-3


@pytest.mark.parametrize("stride,max_samples,want", [(1, None, [0, 1, 2, 3, 4]), (2, None, [0, 2, 4]),
                                                     (2, 2, [0, 2]), (1, 3, [0, 1, 2])])
def test_runner_stride_and_max_samples(stride, max_samples, want):
    """``Tester.test_multi_sequence`` visits every ``stride``-th sample, at
    most ``max_samples`` of them, as the JAX runner does."""
    from eemflow_tpu_torch.eval.runner import Tester

    class Samples:
        def __init__(self):
            self.seen = []

        def change_test_sequence(self, seq):
            pass

        def __len__(self):
            return 5

        def __getitem__(self, i):
            self.seen.append(i)
            vol = np.zeros((4, 4, 5), np.float32)
            return {"event_volume_old": vol, "event_volume_new": vol,
                    "flow": np.full((4, 4, 2), float(i), np.float32)}

    class Zero(torch.nn.Module):
        def forward(self, ev1, ev2):
            return (ev1, ev2), [torch.zeros(ev1.shape[:3] + (2,))]

    ds = Samples()
    res = Tester(Zero(), "cpu").test_multi_sequence(ds, ["s"], stride=stride, max_samples=max_samples)
    assert ds.seen == want and res["s"]["n_samples"] == len(want)
    # the EPE of sample i against a zero flow is i·√2
    assert abs(res["mean"]["AEE"] - np.mean(want) * np.sqrt(2)) < 1e-5


def test_tools_eraft_on_cpu(tmp_path):
    from eemflow_tpu_torch.tools.profile_model import main as profile_main
    from eemflow_tpu_torch.tools.time_eval import main as time_main

    res = time_main(["-model", "eraft", "--device", "cpu", "--size", "40", "56", "-bs", "1",
                     "--reps", "1", "--fused_update_bf16", "--corr_fast"])
    assert res["model"] == "eraft" and res["device"] == "cpu" and res["ms_per_img"] > 0
    assert res["modes"] == {"corr_fast": True, "fused_update": True, "fused_dtype": "bf16"}
    prof = profile_main(["-model", "eraft", "--device", "cpu", "--size", "40", "56", "--reps", "1",
                         "--logdir", str(tmp_path), "--fused_update"])
    assert prof["modes"] == {"fused_update": True} and prof["device_busy_share"] is None


@pytest.mark.parametrize("size,grid", [((720, 1280), [92, 160]), ((512, 960), [64, 120])])
def test_update_block_bound_takes_the_padded_grid(size, grid):
    """ERAFT pads 720×1280 to 736×1280 ("chairs", pad_rate 32): the K5 grid
    is 92×160, not 90×160."""
    from eemflow_tpu_torch.tools.update_block_bound import main as bound_main

    res = bound_main(["--size", *map(str, size), "-bs", "1", "--iters", "12"])
    assert res["grid"] == grid and res["launches"] == 24
    assert res["flop"] == 2 * 2_675_968 * grid[0] * grid[1] * 12
