"""Training GMA, SKFlow and KPAFlow in the port against the JAX package on
the CPU: one float32 train step of each (64×96, B=2, 3 iterations, every
gate drawn nonzero) against JAX's ``make_train_step`` from the same
parameters and batch (the loss, every gradient in units of the model's
largest, the BatchNorm statistics after the step), and one bf16 step
compared in aggregate; ``train_mvsec`` with each model's own MVSEC config
on a shrunken sensor; ``train_hrem``'s ``--full_res_flow`` refusal.

The limits are ``tests/test_torch_train_two_volume.py``'s ERAFT rows
(``PERF.md`` §2): a gradient leaf in units of the model's largest |g|,
1e-4, and the gradient outside the encoders within 1e-4 relative L2; but
the encoders' leaves (``fnet``, ``cnet``) are held against JAX's step run
in float64 (``jax.enable_x64``) instead of its float32 one.  The attention
spreads the loss's gradient nearly evenly over the grid, and the encoders'
norms subtract its mean in their backward: float32 loses digits there, on
either side.  Against float64, JAX's float32 encoder gradients lie up to
1.9e-3 (GMA, its ``cnet.layer3.0.conv1``), 6.6e-6 (SKFlow) and 5.2e-4
(KPAFlow) of the model's largest |g| away, the port's 2.5e-7, 4.4e-5 and
8.3e-5: so the port's are held to ``ENCODER_TOL`` = 2e-4 of float64, and
every other leaf to 1e-4 of JAX's float32 (measured at most 1e-5).  The
whole gradient, encoders included, is held against float64 within
``F64_L2_TOL`` = 1e-3 relative L2: JAX's float32 gradient lies 1.7e-3
(GMA), 2.9e-5 (SKFlow) and 5.1e-4 (KPAFlow) from it, the port's 5.1e-7,
3.7e-4 and 8.3e-5.  SKFlow's share is its ``cnet`` leaves, each ~3e-3
from float64 while the gradient that reaches ``cnet``'s output is 2.4e-6
from it: the train-mode BatchNorm's float32 backward sums a nearly
constant gradient over the batch and the grid.  A wrong backward in an
encoder (a detach, a norm) moves those leaves by their own size (SKFlow's
encoders hold 2.7% of the whole |g|²).  The update blocks' weights are drawn at
0.5 (GMA) and 0.3 (SKFlow) of their variance: at the full variance their
flows grow large enough that the float32 gradients of both sides cross
ReLU kinks that float64 does not (3e-3 of the largest |g| from float64,
on both sides alike).

The bf16 step: GMA's and SKFlow's against JAX's bf16 step (the loss
within 1e-3 relative or JAX's own bf16-to-float32 distance; the gradient
within 3× JAX's own bf16 distance and ``BF16_GRAD_L2_ZOO`` relative L2;
each leaf's cosine at least 0.9).  KPAFlow's against JAX's float32 step at
the same limits, with JAX's bf16 noise taken from GMA's step: KPAFlow's
bf16 step does not run in JAX: its decoder's focus kernel is float32, the
scores it multiplies are promoted, and ``nn.scan`` refuses the promoted
GRU state (a ``TypeError``, pinned below).  The port keeps JAX's promotion
inside the attention and casts its output to the state's dtype.  JAX's own
bf16 gradient lies 3.7% (GMA) and 4.1% (SKFlow) from its float32 one, past
the 3% absolute limit of ERAFT's row; the port's lay 3.8% (GMA) and 4.2%
(SKFlow) from JAX's bf16 one and 5.2% (KPAFlow) from JAX's float32 one: the
absolute limit here is 8%."""

import importlib
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eemflow_tpu.data.mvsec as jax_mvsec
from eemflow_tpu.models.gma import RAFTGMA as JaxGMA
from eemflow_tpu.models.eraft import coords_grid as jax_coords_grid
from eemflow_tpu.models.kpaflow import KPAFlow as JaxKPAFlow
from eemflow_tpu.models.skflow import SKFlow as JaxSKFlow
from eemflow_tpu.train.optim import make_optimizer as jax_make_optimizer
from eemflow_tpu.train.trainer import TrainState as JaxTrainState
from eemflow_tpu.train.trainer import make_train_step as jax_make_train_step
from test_torch_gma import seeded_variables
from test_torch_mvsec import make_mvsec_fixture
from test_torch_train_two_volume import (BF16_GRAD_COS, BF16_GRAD_NOISE, BF16_LOSS_RTOL, GRAD_TOL,
                                         LOSS_RTOL, NORMED_BIAS, NUM_STEPS, STATS_TOL, WD, _carrying_grads)

import eemflow_tpu_torch.data.mvsec as port_mvsec
from eemflow_tpu_torch.compat.from_jax import (gma_state_dict_from_jax, kpaflow_state_dict_from_jax,
                                               skflow_state_dict_from_jax)
from eemflow_tpu_torch.models.gma import RAFTGMA
from eemflow_tpu_torch.models.kpaflow import KPAFlow
from eemflow_tpu_torch.models.skflow import SKFlow
from eemflow_tpu_torch.tools.train_mvsec import main as train_cli
from eemflow_tpu_torch.train.optim import make_optimizer
from eemflow_tpu_torch.train.trainer import create_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SHAPE, LR = 2, (64, 96, 5), 1e-5
ENCODER_TOL = 2e-4
F64_L2_TOL = 1e-3
BF16_GRAD_L2_ZOO = 8e-2
ENCODERS = ("fnet.", "cnet.")
MODELS = {
    "gma": dict(jax=JaxGMA, port=RAFTGMA, to_port=gma_state_dict_from_jax, seed=31, scale=0.5),
    "skflow": dict(jax=JaxSKFlow, port=SKFlow, to_port=skflow_state_dict_from_jax, seed=32, scale=0.3),
    "kpaflow": dict(jax=JaxKPAFlow, port=KPAFlow, to_port=kpaflow_state_dict_from_jax, seed=33, scale=1.0),
}
JAX_BF16 = ("gma", "skflow")  # KPAFlow's against JAX's float32 step (see above)


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
    spec = MODELS[name]
    return seeded_variables(spec["jax"](iters=1), SHAPE, spec["seed"], scale=spec["scale"])


def _jax_run(name):
    """JAX's float32 step (and bf16 step, where it runs) in one compile: the
    losses, the gradients and the BatchNorm statistics after the step."""
    spec = MODELS[name]
    model = spec["jax"](iters=3)
    tx = _carrying_grads(jax_make_optimizer(lr=LR, wdecay=WD, num_steps=NUM_STEPS))
    steps = [jax_make_train_step(model, tx, donate=False)]
    if name in JAX_BF16:
        steps.append(jax_make_train_step(model, tx, donate=False, mixed_precision=True))
    fn = jax.jit(lambda state, batch: [s(state, batch) for s in steps])
    # LLVM's optimization level 0 would take 420 s for SKFlow's step (XLA's
    # 15x15 depthwise convs), so the default stays
    variables = _variables(name)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          opt_state=tx.init(variables["params"]), batch_stats=variables["batch_stats"])
    outs = fn(state, batch)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    run = {"variables": variables}
    for tag, (s, m) in zip(("f32", "bf16"), outs):
        run[tag] = {"loss": float(m["loss"]), "epe": float(m["epe"]), "grads": {"params": np_tree(s.opt_state[1])},
                    "batch_stats": {"batch_stats": np_tree(s.batch_stats)}}
    run["f64"] = _jax_float64_step(name, variables)
    return run


def _jax_float64_step(name, variables):
    """JAX's float32 step run in float64 (``jax.enable_x64``, the variables
    and the batch cast): the encoders' reference.  The coordinate grid is
    made float64 as well: ``coords_grid`` builds it in float32, and the scan
    refuses the carry that a float64 update promotes."""
    spec = MODELS[name]
    module = importlib.import_module(spec["jax"].__module__)
    grid64 = lambda *a: jax_coords_grid(*a).astype(jnp.float64)
    with jax.enable_x64(True), mock.patch.object(module, "coords_grid", grid64):
        tx = _carrying_grads(jax_make_optimizer(lr=LR, wdecay=WD, num_steps=NUM_STEPS))
        step = jax.jit(jax_make_train_step(spec["jax"](iters=3), tx, donate=False))
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        batch = {k: jnp.asarray(a.astype(np.float64)) for k, a in _batch().items()}
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                              opt_state=tx.init(v["params"]), batch_stats=v["batch_stats"])
        s, m = step(state, batch)
        return {"loss": float(m["loss"]), "grads": {"params": jax.tree_util.tree_map(np.asarray, s.opt_state[1])}}


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
    gradients before the clip, the model after the step)."""
    spec = MODELS[name]
    tx = make_optimizer(lr=LR, wdecay=WD, num_steps=NUM_STEPS)
    state = create_train_state(spec["port"](iters=3), 0, tx, params=spec["to_port"](variables))
    grads = {}
    opt_step = state.opt.step

    def step_recording_grads():
        grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})
        return opt_step()

    state.opt.step = step_recording_grads
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, metrics = make_train_step(mixed_precision=bf16)(state, batch)
    return float(metrics["loss"]), float(metrics["epe"]), grads, state.model


def _leaves(name, tree, suffixes):
    sd = MODELS[name]["to_port"](tree)
    return {k: v.numpy() for k, v in sd.items() if k.endswith(suffixes) and ".downsample.1." not in k}


PARAMS = ("weight", "bias", "gamma", "w_prelu")


def _flat(d, names):
    return np.concatenate([np.asarray(d[n]).ravel() for n in names])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_float32_step_matches_jax(jax_runs, name):
    ref = jax_runs(name)
    loss, epe, grads, model = _port_step(name, ref["variables"], bf16=False)
    np.testing.assert_allclose(loss, ref["f32"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(epe, ref["f32"]["epe"], rtol=LOSS_RTOL)
    g = _leaves(name, ref["f32"]["grads"], PARAMS)
    assert set(g) == set(grads)
    gates = [n for n in g if n.endswith(("gamma", "w_prelu"))]
    assert gates and all(np.abs(g[n]).max() > 0 for n in gates)  # the attention takes part
    top = max(np.abs(v).max() for v in g.values())
    g64 = _leaves(name, ref["f64"]["grads"], PARAMS)
    np.testing.assert_allclose(ref["f64"]["loss"], ref["f32"]["loss"], rtol=LOSS_RTOL)
    for n, got in grads.items():
        want, tol = (g64[n], ENCODER_TOL) if n.startswith(ENCODERS) else (g[n], GRAD_TOL)
        err = np.abs(got.numpy() - want).max()
        assert err <= tol * top, f"{n}: max|Δg| {err:.3e} of the model's max|g| {top:.3e}"
    ours = {n: v.numpy() for n, v in grads.items()}
    names = sorted(n for n in g if not n.startswith(ENCODERS))
    assert np.linalg.norm(_flat(ours, names) - _flat(g, names)) <= GRAD_TOL * np.linalg.norm(_flat(g, names))
    names = sorted(g)  # the whole gradient, the encoders' leaves included, against float64
    assert np.linalg.norm(_flat(ours, names) - _flat(g64, names)) <= F64_L2_TOL * np.linalg.norm(_flat(g64, names))
    stats = _leaves(name, ref["f32"]["batch_stats"], ("running_mean", "running_var"))
    own = model.state_dict()
    assert len(stats) == 30  # cnet's 15 BatchNorms
    for n, r in stats.items():
        err = np.abs(own[n].numpy() - r).max()
        assert err <= STATS_TOL * np.abs(r).max(), f"{n}: {err:.3e} of {np.abs(r).max():.3e}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_step_matches_jax_in_aggregate(jax_runs, name):
    ref = jax_runs(name)
    # KPAFlow: JAX's float32 step stands in for its bf16 one, GMA's bf16
    # noise for its own
    theirs16 = ref["bf16"] if name in JAX_BF16 else ref["f32"]
    noise_name = name if name in JAX_BF16 else "gma"
    noise_ref = jax_runs(noise_name)
    loss, _, grads, model = _port_step(name, ref["variables"], bf16=True)
    own_noise = abs(noise_ref["bf16"]["loss"] - noise_ref["f32"]["loss"]) / abs(noise_ref["f32"]["loss"])
    assert abs(loss - theirs16["loss"]) <= max(BF16_LOSS_RTOL, own_noise) * abs(theirs16["loss"]), (
        f"bf16 loss {loss:.6f}, JAX's {theirs16['loss']:.6f}")
    g16 = _leaves(name, theirs16["grads"], PARAMS)
    names = sorted(g16)
    for n in names:
        assert grads[n].dtype == torch.float32, n
        if NORMED_BIAS.match(n):
            continue
        a, b = grads[n].numpy().ravel(), g16[n].ravel()
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        assert cos >= BF16_GRAD_COS, f"{n}: cosine {cos:.4f} to JAX's gradient"
    ours, theirs = _flat({n: v.numpy() for n, v in grads.items()}, names), _flat(g16, names)
    rel = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
    n16, n32 = (_leaves(noise_name, noise_ref[tag]["grads"], PARAMS) for tag in ("bf16", "f32"))
    noise = np.linalg.norm(_flat(n16, sorted(n16)) - _flat(n32, sorted(n16))) / np.linalg.norm(_flat(n32, sorted(n16)))
    assert rel <= BF16_GRAD_L2_ZOO and rel <= BF16_GRAD_NOISE * noise, (
        f"the bf16 gradient is {rel:.3%} (relative L2) from JAX's, whose bf16 noise is {noise:.3%}")
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_jax_kpaflow_bf16_step_raises():
    """JAX's KPAFlow under mixed precision: the float32 focus kernel promotes
    the decoder's GRU state, and ``nn.scan`` refuses the carry."""
    model = JaxKPAFlow(iters=2)
    tx = jax_make_optimizer(lr=LR, num_steps=NUM_STEPS)
    step = jax_make_train_step(model, tx, donate=False, mixed_precision=True)
    variables = seeded_variables(JaxKPAFlow(iters=1), (32, 48, 5), 3)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          opt_state=tx.init(variables["params"]), batch_stats=variables["batch_stats"])
    batch = {k: jnp.asarray(v[:, :32, :48]) for k, v in _batch().items()}
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(step, state, batch)


H, W = 64, 80      # the shrunken sensor
CROP = (48, 64)    # the crop of the shrunken recipe
FRAMES = (3, 9)


@pytest.fixture(scope="module")
def mvsec_root(tmp_path_factory):
    return make_mvsec_fixture(str(tmp_path_factory.mktemp("mvsec_zoo")), ("outdoor_day2",), h=H, w=W,
                              n_events=800, seed=22, first=FRAMES[0], last=FRAMES[1] + 8)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_mvsec_cli_with_its_config(mvsec_root, tmp_path, monkeypatch, name):
    """``train_mvsec -model <name> --config configs/mvsec_<name>.json`` (its
    augmentation, bins and bf16, 2 iterations) on a 64×80 sensor: two steps
    with finite losses and a checkpoint; the model takes the config's fields."""
    for mod in (jax_mvsec, port_mvsec):
        monkeypatch.setattr(mod.MvsecEventFlow, "image_height", H)
        monkeypatch.setattr(mod.MvsecEventFlow, "image_width", W)
        monkeypatch.setitem(mod.VALID_TIME_INDEX, "outdoor_day2", [FRAMES])
    with open(os.path.join(REPO, "configs", f"mvsec_{name}.json")) as f:
        cfg = json.load(f)
    assert cfg["train"]["mixed_precision"] is True
    cfg["data_loader"]["train"]["args"]["aug_params"]["crop_size"] = list(CROP)
    cfg["iters"] = 2
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    state = train_cli(["-model", name, "--config", str(path), "--data_root", mvsec_root, "-bs", "2", "--lr", "1e-4",
                       "--train_iters", "2", "--val_iters", "2", "--save_dir", str(out), "--device", "cpu",
                       "--bucket_size", str(1 << 12)])
    assert state.step == 2 and state.model.iters == 2
    if name == "kpaflow":
        assert state.model.trans.sc == 13 and state.model.update_block.kpa.sc == 19
    run = out / os.listdir(out)[0]
    with open(run / "metrics.jsonl") as f:
        epoch = [json.loads(line) for line in f if '"epoch"' in line][-1]
    assert epoch["n_steps"] == 2 and np.isfinite(epoch["mean_loss"])
    assert os.listdir(run / "ckpt") == ["epoch_1.pt"]


@pytest.mark.parametrize("name", ["GMA", "skflow", "kpaflow"])
def test_train_hrem_asks_for_full_res_flow(tmp_path, name):
    """``train_hrem`` takes the three through the registry and, as for ERAFT,
    refuses them against the 16×16 meshflow label before any step, naming
    the flag."""
    from eemflow_tpu_torch.tools.train_hrem import main as train_hrem

    save = tmp_path / "runs"
    with pytest.raises(SystemExit) as e:
        train_hrem(["-model", name, "--data_root", str(tmp_path), "--device", "cpu", "--save_dir", str(save)])
    assert "--full_res_flow" in str(e.value.code) and not save.exists()
