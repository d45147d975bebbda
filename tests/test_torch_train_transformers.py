"""Training GMFlow and FlowFormer in the port against the JAX package on the
CPU: one float32 train step of each (64×96, B=2; GMFlow's shipped
one-scale configuration, FlowFormer at ``encoder_depth`` 1 and
``decoder_depth`` 3 with its GMA gate drawn nonzero) against JAX's
``make_train_step`` from the same parameters and batch (the loss, and
every gradient leaf in units of the model's largest), and the bf16 step
against JAX's bf16 step in aggregate; ``train_mvsec`` with each model's
own MVSEC config (its fields, bins and bf16) and ``train_hrem
--full_res_flow`` on a shrunken sensor.

The weights are ``test_torch_gmflow.seeded_transformer_variables``'s.
GMFlow's LayerNorm scales and encoder output conv are drawn at 0.3 of
them (``GMFLOW_SOFT``, as ``chip_smoke.py`` draws them): at the full draws
its softmax matching is a near-argmax, where one rounding moves a pixel's
match, and JAX's own bf16 gradient lies 92% (relative L2) from its float32
one (21% at 0.3).  FlowFormer's ``channel_convertor`` is drawn at a tenth
of its deviation, as in ``tests/test_torch_flowformer.py``, and so is its
flow head's last conv: at the full deviation three decoder iterations move
the coordinates by ~50 px on the 8×12 grid, far off the cost maps, and both
float32 gradients lie ~1e-3 (relative L2) from JAX's float64 step (JAX's
8.9e-4, the port's 1.2e-3; the GRU's ``convq2`` leaf 1e-3 of the largest
|g| on both sides).  At a tenth JAX's float32 gradient lies 4.3e-5 from
float64, the port's 1.2e-6, and the two 2.6e-6 of the largest |g| apart.
The float32 limits are PERF.md §2's zoo rows: the loss within 1e-5
relative, each gradient leaf within 1e-4 of the model's largest |g| and the
whole gradient within 1e-4 relative L2.

Both JAX models take a bf16 step (JAX's KPAFlow does not), but XLA's CPU
backend computes a fusion of bf16 elementwise ops in float32 and rounds
once where eager torch rounds every op, and flax promotes GMFlow's features
to float32 at its float32 position embedding, where the port keeps them
bf16.  FlowFormer's bf16 step is held to JAX's bf16 step as the zoo's rows
hold it: the loss within 1e-3 relative or JAX's own bf16-to-float32
distance, each leaf's cosine at least 0.9, the whole gradient within
``BF16_L2`` relative L2 (the port's 3.4%; JAX's own distance 3.7%).
GMFlow's against JAX's float32 step (see its test)."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eemflow_tpu.data.mvsec as jax_mvsec
from eemflow_tpu.models.flowformer import FlowFormer as JaxFlowFormer
from eemflow_tpu.models.gmflow import GMFlow as JaxGMFlow
from eemflow_tpu.train.optim import make_optimizer as jax_make_optimizer
from eemflow_tpu.train.trainer import TrainState as JaxTrainState
from eemflow_tpu.train.trainer import make_train_step as jax_make_train_step
from test_torch_gmflow import seeded_transformer_variables, small_hrem_split
from test_torch_mvsec import make_mvsec_fixture
from test_torch_train_two_volume import (BF16_GRAD_COS, BF16_GRAD_NOISE, BF16_LOSS_RTOL, GRAD_TOL, LOSS_RTOL,
                                         NUM_STEPS, WD, _carrying_grads)

import eemflow_tpu_torch.data.mvsec as port_mvsec
from eemflow_tpu_torch.compat.from_jax import transformer_state_dict_from_jax
from eemflow_tpu_torch.models.flowformer import FlowFormer
from eemflow_tpu_torch.models.gmflow import GMFlow
from eemflow_tpu_torch.tools.train_mvsec import main as train_mvsec
from eemflow_tpu_torch.train.optim import make_optimizer
from eemflow_tpu_torch.train.trainer import create_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SHAPE, LR = 2, (64, 96, 5), 1e-5
GMFLOW_SOFT = 0.3  # GMFlow's LayerNorm scales and encoder output conv (chip_smoke.py's GMFLOW_SOFT)
BF16_L2 = 8e-2
# leaves whose true gradient is 0, so that what either side computes is
# rounding: biases that an instance norm cancels, and the attention keys'
# biases (a query's scores all move by q·b, which the softmax cancels)
ZERO_GRAD = re.compile(
    r"^(context_encoder|memory_encoder\.feat_encoder|backbone)\.(conv1|layer\d\.\d\.(conv1|conv2|downsample\.0))\.bias$"
    r"|\.k(_proj)?\.bias$")
MODELS = {
    "gmflow": dict(jax=lambda: JaxGMFlow(), port=lambda: GMFlow(), seed=91),
    "flowformer": dict(jax=lambda: JaxFlowFormer(encoder_depth=1, decoder_depth=3),
                       port=lambda: FlowFormer(encoder_depth=1, decoder_depth=3), seed=92),
}
LOW_OPT = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    h, w, c = SHAPE
    return {
        "event_volume_old": rng.standard_normal((B, h, w, c)).astype(np.float32),
        "event_volume_new": rng.standard_normal((B, h, w, c)).astype(np.float32),
        "flow": (rng.standard_normal((B, h, w, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, h, w), np.float32),
    }


def _variables(name):
    v = seeded_transformer_variables(MODELS[name]["jax"](), SHAPE, MODELS[name]["seed"])
    if name == "gmflow":
        soften = lambda path, a: a * np.float32(GMFLOW_SOFT) if (
            path[-1].key == "scale" or [p.key for p in path[-3:]] == ["backbone", "conv2", "kernel"]) else a
        v = jax.tree_util.tree_map_with_path(soften, v)
    if name == "flowformer":
        p = v["params"]
        for conv in (p["memory_encoder"]["channel_convertor"], p["memory_decoder"]["update_block"]["flow_head"]["conv2"]):
            conv["kernel"] = conv["kernel"] * np.float32(0.1)
    return v


def _jax_run(name):
    """JAX's float32 and bf16 steps of the model, compiled once together:
    the losses and the gradients."""
    model = MODELS[name]["jax"]()
    tx = _carrying_grads(jax_make_optimizer(lr=LR, wdecay=WD, num_steps=NUM_STEPS))
    steps = [jax_make_train_step(model, tx, donate=False, mixed_precision=mp) for mp in (False, True)]
    variables = _variables(name)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          opt_state=tx.init(variables["params"]), batch_stats={})
    fn = jax.jit(lambda st, b: [s(st, b) for s in steps]).lower(state, batch).compile(compiler_options=LOW_OPT)
    run = {"variables": variables}
    for tag, (s, m) in zip(("f32", "bf16"), fn(state, batch)):
        run[tag] = {"loss": float(m["loss"]), "epe": float(m["epe"]),
                    "grads": {n: v.numpy() for n, v in transformer_state_dict_from_jax(
                        jax.tree_util.tree_map(np.asarray, s.opt_state[1])).items()}}
    return run


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_run(name)
        return cache[name]

    return get


def _port_step(name, variables, bf16):
    """One port step from the same variables and batch: (loss, epe, the
    gradients before the clip)."""
    tx = make_optimizer(lr=LR, wdecay=WD, num_steps=NUM_STEPS)
    state = create_train_state(MODELS[name]["port"](), 0, tx, params=transformer_state_dict_from_jax(variables))
    grads = {}
    opt_step = state.opt.step

    def step_recording_grads():
        grads.update({n: p.grad.clone().numpy() for n, p in state.model.named_parameters()})
        return opt_step()

    state.opt.step = step_recording_grads
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, metrics = make_train_step(mixed_precision=bf16)(state, batch)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    return float(metrics["loss"]), float(metrics["epe"]), grads


def _flat(d, names):
    return np.concatenate([np.asarray(d[n]).ravel() for n in names])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_float32_step_matches_jax(jax_runs, name):
    ref = jax_runs(name)["f32"]
    loss, epe, grads = _port_step(name, jax_runs(name)["variables"], bf16=False)
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(epe, ref["epe"], rtol=LOSS_RTOL)
    g = ref["grads"]
    assert set(g) == set(grads)
    if name == "flowformer":  # the aggregation takes part
        assert np.abs(g["memory_decoder.update_block.aggregator.gamma"]).max() > 0
    top = max(np.abs(v).max() for v in g.values())
    for n, got in grads.items():
        err = np.abs(got - g[n]).max()
        assert err <= GRAD_TOL * top, f"{n}: max|Δg| {err:.3e} of the model's max|g| {top:.3e}"
    names = sorted(g)
    assert np.linalg.norm(_flat(grads, names) - _flat(g, names)) <= GRAD_TOL * np.linalg.norm(_flat(g, names))


def test_bf16_step_of_flowformer_matches_jax_in_aggregate(jax_runs):
    run = jax_runs("flowformer")
    theirs, f32 = run["bf16"], run["f32"]
    loss, _, grads = _port_step("flowformer", run["variables"], bf16=True)
    own_noise = abs(theirs["loss"] - f32["loss"]) / abs(f32["loss"])
    assert abs(loss - theirs["loss"]) <= max(BF16_LOSS_RTOL, own_noise) * abs(theirs["loss"]), (
        f"bf16 loss {loss:.6f}, JAX's {theirs['loss']:.6f}")
    names = sorted(theirs["grads"])
    for n in names:
        if ZERO_GRAD.search(n):
            continue
        a, b = grads[n].ravel(), theirs["grads"][n].ravel()
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        assert cos >= BF16_GRAD_COS, f"{n}: cosine {cos:.4f} to JAX's bf16 gradient"
    ours, ref = _flat(grads, names), _flat(theirs["grads"], names)
    rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    assert rel <= BF16_L2, f"the bf16 gradient is {rel:.3%} (relative L2) from JAX's"


def test_bf16_step_of_gmflow_against_jax_float32(jax_runs):
    """GMFlow's bf16 step (its activations bf16 throughout, where flax
    promotes them to float32 at the position embedding) against JAX's
    float32 step: the loss within 1e-3 relative, each leaf's cosine at least
    0.9, and the whole gradient within 3× JAX's own bf16 distance from its
    float32 one (21.4%; the port's 21.3%)."""
    run = jax_runs("gmflow")
    ref = run["f32"]
    loss, _, grads = _port_step("gmflow", run["variables"], bf16=True)
    assert abs(loss - ref["loss"]) <= BF16_LOSS_RTOL * abs(ref["loss"]), f"bf16 loss {loss:.6f}, JAX's {ref['loss']:.6f}"
    names = sorted(ref["grads"])
    for n in names:
        if ZERO_GRAD.search(n):
            continue
        a, b = grads[n].ravel(), ref["grads"][n].ravel()
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        assert cos >= BF16_GRAD_COS, f"{n}: cosine {cos:.4f} to JAX's float32 gradient"
    theirs = _flat(ref["grads"], names)
    rel = np.linalg.norm(_flat(grads, names) - theirs) / np.linalg.norm(theirs)
    noise = np.linalg.norm(_flat(run["bf16"]["grads"], names) - theirs) / np.linalg.norm(theirs)
    assert rel <= BF16_GRAD_NOISE * noise, f"the bf16 gradient is {rel:.3%} from JAX's float32, JAX's own {noise:.3%}"


H, W = 64, 80      # the shrunken MVSEC sensor
CROP = (48, 64)
FRAMES = (3, 9)


@pytest.fixture(scope="module")
def mvsec_root(tmp_path_factory):
    return make_mvsec_fixture(str(tmp_path_factory.mktemp("mvsec_transformers")), ("outdoor_day2",), h=H, w=W,
                              n_events=800, seed=23, first=FRAMES[0], last=FRAMES[1] + 8)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_mvsec_cli_with_its_config(mvsec_root, tmp_path, monkeypatch, name):
    """``train_mvsec -model <name> --config configs/mvsec_<name>.json`` (its
    augmentation, bins and bf16) on a 64×80 sensor, one step: a finite
    loss and a checkpoint; the model takes the config's fields."""
    for mod in (jax_mvsec, port_mvsec):
        monkeypatch.setattr(mod.MvsecEventFlow, "image_height", H)
        monkeypatch.setattr(mod.MvsecEventFlow, "image_width", W)
        monkeypatch.setitem(mod.VALID_TIME_INDEX, "outdoor_day2", [FRAMES])
    with open(os.path.join(REPO, "configs", f"mvsec_{name}.json")) as f:
        cfg = json.load(f)
    assert cfg["train"]["mixed_precision"] is True
    cfg["data_loader"]["train"]["args"]["aug_params"]["crop_size"] = list(CROP)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    state = train_mvsec(["-model", name, "--config", str(path), "--data_root", mvsec_root, "-bs", "2", "--lr", "1e-4",
                         "--train_iters", "1", "--val_iters", "1", "--save_dir", str(out), "--device", "cpu",
                         "--bucket_size", str(1 << 12)])
    assert state.step == 1
    if name == "gmflow":
        assert state.model.attn_splits_list == (2,) and len(state.model.transformer.layers) == 6
    else:
        assert state.model.memory_decoder.decoder_depth == 12
    run = out / os.listdir(out)[0]
    with open(run / "metrics.jsonl") as f:
        epoch = [json.loads(line) for line in f if '"epoch"' in line][-1]
    assert epoch["n_steps"] == 1 and np.isfinite(epoch["mean_loss"])
    assert os.listdir(run / "ckpt") == ["epoch_1.pt"]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_hrem_with_full_res_flow(tmp_path, monkeypatch, name):
    """``train_hrem`` refuses the model against the 16×16 meshflow label
    before any step, naming ``--full_res_flow``; with it, one float32 step
    on a 64×96 sensor (FlowFormer at decoder depth 2) logs a finite loss."""
    from eemflow_tpu_torch.data.hrem import HREMEventFlow
    from eemflow_tpu_torch.tools.train_hrem import main as train_hrem

    save = tmp_path / "runs"
    with pytest.raises(SystemExit) as e:
        train_hrem(["-model", name, "--data_root", str(tmp_path), "--device", "cpu", "--save_dir", str(save)])
    assert "--full_res_flow" in str(e.value.code) and not save.exists()

    monkeypatch.setattr(HREMEventFlow, "image_height", 64)
    monkeypatch.setattr(HREMEventFlow, "image_width", 96)
    root = small_hrem_split(str(tmp_path / "data"), 64, 96)
    os.makedirs(os.path.join(root, "train"))
    os.rename(os.path.join(root, "test", "dt1", "indoor_fast"), os.path.join(root, "train", "dt1"))  # train/dt1/<name>
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"decoder_depth": 2, "train": {"mixed_precision": False}}))
    state = train_hrem(["-model", name, "--full_res_flow", "--config", str(cfg), "--data_root", root, "-bs", "1",
                        "--train_iters", "1", "--val_iters", "1", "--device", "cpu", "--save_dir", str(save)])
    assert state.step == 1
    with open(save / os.listdir(save)[0] / "metrics.jsonl") as f:
        assert np.isfinite([json.loads(line)["mean_loss"] for line in f][-1])
