"""The port's GMA (``models/gma.py``) and SKFlow (``models/skflow.py``)
against the JAX package's on the CPU: the attention map and the global
aggregation, SKFlow's ``PCBlock``, and both whole models at 64×96 and
256×256 (3 iterations, every iteration's prediction and the eval mode's
final one, GMA also from a ``flow_init``) on the same numpy-seeded weights
carried across by ``gma_state_dict_from_jax``/``skflow_state_dict_from_jax``;
the golden checkpoints load strictly after their dead keys are dropped;
SKFlow's MVSEC golden AEE through the port's ``test_mvsec`` (12
iterations); GMA's HREM CLI at 720×1280 at reduced iterations (its golden
AEE is checked on the card by ``chip_smoke.py``); the registry and the tools.

Every residual gate (``gamma``) is drawn nonzero, uniform in [0.5, 1.5]:
the golden checkpoints' gates are 0 (flax initialises them so), so their
AEEs never see the attention, and only these parity checks carry its
correctness.  Flows agree within 1e-4·max(1, largest |flow|): float32 on
both sides, summation-order differences carried through the iterations."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eemflow_tpu.models.gma import GMAAggregate as JaxAggregate
from eemflow_tpu.models.gma import GMAAttention as JaxAttention
from eemflow_tpu.models.gma import RAFTGMA as JaxGMA
from eemflow_tpu.models.skflow import PCBlock as JaxPCBlock
from eemflow_tpu.models.skflow import SKFlow as JaxSKFlow
from test_golden_acceptance import make_hrem_fixture
from test_golden_acceptance import make_mvsec_fixture as make_golden_mvsec_fixture

from eemflow_tpu_torch.compat.from_jax import gma_state_dict_from_jax, skflow_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import drop_prefixes, load_model_checkpoint
from eemflow_tpu_torch.models.gma import GMAAggregate, GMAAttention, RAFTGMA
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model
from eemflow_tpu_torch.models.skflow import PCBlock, SKFlow
from eemflow_tpu_torch.tools.test_hrem import main as hrem_cli
from eemflow_tpu_torch.tools.test_mvsec import main as mvsec_cli

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
FLOW_TOL = 1e-4
MODULE_TOL = 1e-5  # one module in float32, relative to max(1, largest |out|)
GOLDEN_TOL = 0.01
LOW_OPT = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_variables(jax_model, shape, seed, *args, scale=1.0):
    """Variables of a JAX model (shapes from ``eval_shape``, no JAX init
    run) filled from a numpy seed: conv kernels normal with variance
    2/fan_out in the encoders, 1/fan_in in a GRU and 2/fan_in elsewhere
    (times ``scale`` outside the encoders), biases N(0, 0.01²), BatchNorm at
    its init statistics, every gate (``gamma``) uniform in [0.5, 1.5] and
    KPAFlow's ``w_prelu`` its init value times uniform [0.5, 1.5]."""
    ev = jnp.zeros((1, *shape))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), ev, ev, *args)
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
            if keys[1] not in ("fnet", "cnet"):
                var *= scale
            return (rng.standard_normal(s.shape) * np.sqrt(var)).astype(np.float32)
        if keys[-1] == "gamma":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if keys[-1] == "w_prelu":
            sc = 19 if keys[-2] == "kpa" else 13
            return (rng.uniform(0.5, 1.5, s.shape) / ((3 * sc - 1) / 2)).astype(np.float32)
        if keys[-1] in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        if keys[-1] == "bias" and keys[0] == "params":
            return (rng.standard_normal(s.shape) * 0.01).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def events(seed, h, w, batch=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, h, w, 5)).astype(np.float32) for _ in range(2)]


def jax_flows(jax_model, variables, ev1, ev2, *args):
    """The JAX model's predictions, jitted at LLVM optimization level 0."""
    f = jax.jit(jax_model.apply).lower(variables, jnp.asarray(ev1), jnp.asarray(ev2), *args)
    return np.asarray(f.compile(compiler_options=LOW_OPT)(variables, jnp.asarray(ev1), jnp.asarray(ev2), *args)[1])


def port_flows(model, ev1, ev2, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(ev1), torch.from_numpy(ev2), **kw)[1].numpy()


def assert_flows_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= FLOW_TOL * scale, f"max|Δ| {err:.3e} of max(1, |flow|) {scale:.3f}"


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("grid", [(8, 12), (5, 7)], ids=["8x12", "5x7"])
def test_attention_and_aggregation_match_jax(grid):
    h, w = grid
    rng = np.random.default_rng(1)
    fmap = rng.standard_normal((2, h, w, 128)).astype(np.float32)
    motion = rng.standard_normal((2, h, w, 128)).astype(np.float32)
    att, agg = JaxAttention(128), JaxAggregate(128)
    p_att = {"params": {"to_qk": {"kernel": (rng.standard_normal((1, 1, 128, 256)) * 0.2).astype(np.float32)}}}
    p_agg = {"params": {"to_v": {"kernel": (rng.standard_normal((1, 1, 128, 128)) * 0.1).astype(np.float32)},
                        "gamma": np.array([0.8], np.float32)}}
    attn = jax.jit(att.apply)(p_att, jnp.asarray(fmap))
    want = np.asarray(jax.jit(agg.apply)(p_agg, attn, jnp.asarray(motion)))

    port_att, port_agg = GMAAttention(128, 128), GMAAggregate(128)
    port_att.to_qk.weight.data = torch.from_numpy(p_att["params"]["to_qk"]["kernel"].transpose(3, 2, 0, 1).copy())
    port_agg.to_v.weight.data = torch.from_numpy(p_agg["params"]["to_v"]["kernel"].transpose(3, 2, 0, 1).copy())
    port_agg.gamma.data = torch.tensor([0.8])
    with torch.no_grad():
        got_attn = port_att(torch.from_numpy(fmap).permute(0, 3, 1, 2))
        got = port_agg(got_attn, torch.from_numpy(motion).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got_attn.shape == (2, h * w, h * w)
    np.testing.assert_allclose(got_attn.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(attn), rtol=0, atol=MODULE_TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODULE_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("k_conv,grid", [((1, 15), (8, 12)), ((1, 15), (20, 20)), ((1, 7), (5, 7))],
                         ids=["k15_8x12", "k15_20x20", "k7_5x7"])
def test_pcblock_matches_jax(k_conv, grid):
    """Two square depthwise convs (1×1, then k×k) between pointwise FFNs
    with exact GELUs; a 15×15 kernel wider than an 8×12 grid."""
    c_in, c_out = 24, 10
    block = JaxPCBlock(c_in, c_out, k_conv)
    x = np.random.default_rng(2).standard_normal((2, *grid, c_in)).astype(np.float32)
    variables = {"params": seeded_variables_block(block, x, seed=3)}
    want = np.asarray(jax.jit(block.apply)(variables, jnp.asarray(x)))
    port = PCBlock(c_in, c_out, k_conv)
    port.load_state_dict(skflow_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MODULE_TOL * max(1.0, np.abs(want).max()))


def seeded_variables_block(block, x, seed):
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            kh, kw, cin, _ = s.shape
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / (kh * kw * cin))).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ---------------------------------------------------------- whole models

# SKFlow's update block at a third of the variance: its residual PCBlocks
# grow the flow ~10^4x an iteration at the full variance (1.7e10 px after 3
# iterations at 64x96); at 0.3 its flows reach 2-6 px and zeroing the gate
# moves them by 0.5-1.5 px
MODELS = {
    "gma": dict(jax=JaxGMA, port=RAFTGMA, to_port=gma_state_dict_from_jax, seed=31, scale=1.0),
    "skflow": dict(jax=JaxSKFlow, port=SKFlow, to_port=skflow_state_dict_from_jax, seed=32, scale=0.3),
}
SIZES = {"64x96": (64, 96), "256x256": (256, 256)}


@pytest.fixture(scope="module")
def zoo_variables():
    return {name: seeded_variables(spec["jax"](iters=1), (64, 96, 5), spec["seed"], scale=spec["scale"])
            for name, spec in MODELS.items()}


@pytest.fixture(scope="module")
def zoo_jax_flows(zoo_variables):
    """Every iteration's JAX prediction, per model and size, computed once."""
    cache = {}

    def get(name, size):
        if (name, size) not in cache:
            ev = events(40 + len(cache), *SIZES[size])
            cache[name, size] = (ev, jax_flows(MODELS[name]["jax"](iters=3, upsample_all=True),
                                               zoo_variables[name], *ev))
        return cache[name, size]

    return get


@pytest.mark.parametrize("upsample_all", [True, False], ids=["all_iterations", "eval_final"])
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(zoo_variables, zoo_jax_flows, name, size, upsample_all):
    """3 iterations with every gate nonzero: with ``upsample_all`` every
    iteration's convex-upsampled prediction, else the eval mode's one (the
    mask head once, on the final net), JAX's last."""
    ev, want = zoo_jax_flows(name, size)
    model = MODELS[name]["port"](iters=3, upsample_all=upsample_all).eval()
    model.load_state_dict(MODELS[name]["to_port"](zoo_variables[name]), strict=True)
    assert all(float(p.detach()) != 0 for n, p in model.named_parameters() if n.endswith("gamma"))
    got = port_flows(model, *ev)
    h, w = SIZES[size]
    assert want.shape == (3, 1, h, w, 2) and 1.0 < np.abs(want).max() < 100.0
    assert_flows_close(got, want if upsample_all else want[-1:])


def test_gma_flow_init_matches_jax(zoo_variables):
    ev1, ev2 = events(50, 64, 96)
    init = (np.random.default_rng(51).standard_normal((1, 8, 12, 2)) * 2).astype(np.float32)
    want = jax_flows(JaxGMA(iters=2, upsample_all=True), zoo_variables["gma"], ev1, ev2, None, jnp.asarray(init))
    model = RAFTGMA(iters=2).eval()
    model.load_state_dict(gma_state_dict_from_jax(zoo_variables["gma"]), strict=True)
    assert_flows_close(port_flows(model, ev1, ev2, flow_init=torch.from_numpy(init)), want)


# ------------------------------------------------- checkpoints and CLIs


@pytest.mark.parametrize("name,ckpt", [("gma", "gma_hrem"), ("GMA", "gma_hrem"), ("skflow", "skflow_mvsec")])
def test_golden_checkpoint_loads_strictly(name, ckpt):
    """The released layout loads strictly once the relative position tables
    (SKFlow's golden carries two 319×128 tables) are dropped; the golden's
    gate is 0, as flax initialises it."""
    model = get_eval_model(name)
    assert drop_prefixes(name) == ("att.pos_emb.",)
    load_model_checkpoint(model, os.path.join(FIXTURES, f"{ckpt}_golden.pth.tar"), name)
    assert float(model.update_block.aggregator.gamma.detach()) == 0.0


def test_registry_and_eval_mode():
    for name, cls in (("gma", RAFTGMA), ("GMA", RAFTGMA), ("skflow", SKFlow)):
        model = get_eval_model(name)
        assert isinstance(model, cls) and model.upsample_all is False and not model.training
        assert fast_eval_kwargs(name) == {}
    gma = get_eval_model("gma")
    assert gma.pad_rate == 32 and gma.update_block.gru.convz1.in_channels == 128 + 384
    sk = get_eval_model("skflow")
    assert sk.pad_rate == 8 and sk.update_block.gru.ffn1[0].in_channels == 512
    assert [c.kernel_size for c in sk.update_block.encoder.convc1.conv_list] == [(1, 1), (15, 15)]
    assert [c.kernel_size for c in sk.update_block.gru.conv_list] == [(1, 1), (7, 7)]
    assert sk.update_block.encoder.convc1.ffn1[0].out_channels == int(1.5 * 324)


@pytest.fixture(scope="module")
def golden_mvsec_root(tmp_path_factory):
    with open(os.path.join(FIXTURES, "mvsec_golden_skflow.json")) as f:
        golden = json.load(f)
    return make_golden_mvsec_fixture(str(tmp_path_factory.mktemp("mvsec_golden")), seed=golden["fixture_seed"])


def run_mvsec_golden(root, tmp_path, name):
    """The port's ``test_mvsec`` on the JAX golden's fixture and protocol
    (dt1 dense, frames 3..9, one sample, 12 iterations) on the CPU."""
    with open(os.path.join(FIXTURES, f"mvsec_golden_{name}.json")) as f:
        golden = json.load(f)
    res = mvsec_cli([
        "-model", name, "-int", golden["dt"], "--sequence", "indoor_flying1", "--data_root", root,
        "--checkpoint", os.path.join(FIXTURES, f"{name}_mvsec_golden.pth.tar"), "--save_dir", str(tmp_path),
        "--stride", "1", "--frames", "3", "9", "--max_samples", str(golden["max_samples"]), "--device", "cpu",
    ])
    assert res["n_samples"] == 1
    return res["AEE"], golden["aee"]


def test_skflow_mvsec_golden_aee(golden_mvsec_root, tmp_path):
    aee, want = run_mvsec_golden(golden_mvsec_root, tmp_path, "skflow")
    assert abs(aee - want) < GOLDEN_TOL, f"SKFlow golden AEE {aee}, committed {want}"


def test_gma_hrem_cli_at_reduced_iterations(tmp_path):
    """``test_hrem -model GMA`` on the seed-99 split at 720×1280 (padded to
    736×1280: a 92×160 grid, a 14,720×14,720 attention map) with the golden
    checkpoint and one iteration: a finite AEE that is not the 12-iteration
    golden one (which the card checks)."""
    with open(os.path.join(FIXTURES, "hrem_golden_gma.json")) as f:
        golden = json.load(f)
    root = make_hrem_fixture(str(tmp_path / "data"), seed=golden["fixture_seed"])
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"iters": 1}))
    out = tmp_path / "out"
    res = hrem_cli([
        "-model", "GMA", "-int", "dt1", "--data_root", root, "--checkpoint",
        os.path.join(FIXTURES, "gma_hrem_golden.pth.tar"), "--save_dir", str(out), "--save_csv", "--device",
        "cpu", "--config", str(cfg), "--max_samples", "1",
    ])
    with open(os.path.join(str(out), "GMA_dt1", "test_epe_per_sample.csv")) as f:
        rows = list(csv.DictReader(f))
    assert res["indoor_fast"]["n_samples"] == len(rows) == 1
    assert np.isfinite(res["mean"]["AEE"]) and abs(res["mean"]["AEE"] - golden["aee"]) > 1e-3


@pytest.mark.parametrize("name", ["gma", "skflow", "kpaflow"])
def test_tools_take_the_zoo(tmp_path, name):
    """``time_eval`` and ``profile_model`` take the three models (SKFlow's
    profile is left out here: on the CPU its depthwise convs run one
    channel a call, ~20,000 calls a forward, and the trace takes a minute
    to write)."""
    from eemflow_tpu_torch.tools.profile_model import main as profile_main
    from eemflow_tpu_torch.tools.time_eval import main as time_main

    res = time_main(["-model", name, "--device", "cpu", "--size", "40", "56", "-bs", "1", "--reps", "1"])
    assert res["model"] == name and res["ms_per_img"] > 0
    if name != "skflow":
        prof = profile_main(["-model", name, "--device", "cpu", "--size", "40", "56", "--reps", "1",
                             "--logdir", str(tmp_path)])
        assert prof["model"] == name and prof["device_busy_share"] is None
