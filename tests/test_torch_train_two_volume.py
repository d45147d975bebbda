"""Training the two-volume family beyond EEMFlow in the port, against the
JAX package on the CPU: one EEMFlow+ train step (64×128, B=2, 15 bins,
full-resolution labels, float32 and bf16) and ERAFT steps (64×96, B=2,
3 iterations, float32 and bf16) from the same parameters and batch against
``make_train_step``, with ERAFT's BatchNorm statistics against flax's
``batch_stats`` and its eval flow after the steps; the port's BatchNorm
against flax's ``nn.BatchNorm``; checkpoints that carry the statistics;
and ``train_hrem`` on the CPU (its ``--full_res_flow`` refusal, EEMFlow+
at the config's 15 bins, an ERAFT run resumed to the uninterrupted one).

Tolerances are ``tests/test_torch_train.py``'s (float32: loss 1e-5
relative, each gradient leaf 1e-4 of its largest, parameters in units of
the summed learning rates; bf16: the whole gradient within 3% relative L2
of JAX's bf16 one and within 3× JAX's own bf16 distance from its float32
one, each leaf's cosine at least 0.9), and, for the statistics, 1e-5 of a
buffer's largest value: flax and the port take the same float32 batch
statistics in another summation order.  Where this file departs from
them (ERAFT's gradient unit, three steps' parameters, EEMFlow+'s bf16
gradient), the constant's comment gives the measurement that made it.  The bf16 loss: EEMFlow+'s bf16
forward rounds differently on the two sides (JAX computes its warp
coordinates in bf16 and keeps float32 inside its fused elementwise
chains; the port computes coordinates in float32 and rounds after each
operation), so the loss is held within 1e-3 relative of JAX's or, where
JAX's own bf16 loss is farther than that from its float32 loss, no farther
from JAX's bf16 loss than that distance.  ERAFT steps at the CLI's
default learning rate, 1e-5: with 1e-3 its loss jumps between steps and the
third step's statistics follow the parameters' sign-like Adam drift
instead of the arithmetic.  EEMFlow+'s batch is seed 5's: with seed 4's,
one pre-activation of the second frame's last pyramid conv lies at
-2.7e-7 (float64), which the port's float32 sum rounds to +6e-8 and
JAX's does not, so LeakyReLU takes the other slope at that pixel and the
pyramid's gradients move by up to 2.7e-4 of their largest (JAX's float32
gradient is 6e-7 from float64 there, the port's 2.7e-4); seeds 5, 6 and
7 sit off such kinks (at most 2.5e-6).  The CLI runs use a 64×128 sensor
(the dataset's class attributes) so that a step takes a second.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from eemflow_tpu.models.eemflow_plus import EEMFlowPlus as JaxEEMFlowPlus
from eemflow_tpu.models.eraft import ERAFT as JaxERAFT
from eemflow_tpu.train.optim import make_optimizer as jax_make_optimizer
from eemflow_tpu.train.trainer import TrainState as JaxTrainState
from eemflow_tpu.train.trainer import make_train_step as jax_make_train_step

from eemflow_tpu_torch.compat.from_jax import eemflow_plus_state_dict_from_jax, eraft_state_dict_from_jax
from eemflow_tpu_torch.data.hrem import HREMEventFlow
from eemflow_tpu_torch.events.io import write_flo
from eemflow_tpu_torch.models.eemflow_plus import EEMFlowPlus
from eemflow_tpu_torch.models.eraft import ERAFT
from eemflow_tpu_torch.models.raft_core import BatchNorm
from eemflow_tpu_torch.tools.train_hrem import main as train_main
from eemflow_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from eemflow_tpu_torch.train.optim import make_optimizer, onecycle_lr
from eemflow_tpu_torch.train.trainer import create_train_state, make_train_step

B = 2
WD, NUM_STEPS = 1e-4, 100
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL, PARAM_TOL_ALL, BIG_GRAD = 1e-2, 2.0, 1e-3
# after 3 steps: steps 2 and 3 take their gradients at parameters that
# already differ by the first step's rounding, and Adam's normalisation
# carries that into elements whose gradient is small: EEMFlow+'s rconv2
# drifts to 1.08x PARAM_TOL, ERAFT's fnet.conv1 to 3.6x
PARAM_TOL_3 = 5e-2
# ERAFT's gradient is known to GRAD_TOL of the model's largest (see
# below), so an element's Adam step is known to 1% only where its gradient
# exceeds 1e-2 of that; below, ERAFT's elements drift by up to 12% of the
# summed learning rates in 3 steps (cnet.conv1)
BIG_GRAD_MODEL = 1e-2
# The gradient's unit.  EEMFlow+: each leaf's own largest |g|, as EEMFlow's.
# ERAFT: the model's largest |g|, and the whole gradient within GRAD_TOL
# relative L2.  ERAFT normalises before nearly every ReLU, so many units sit
# near a kink, where one float32 rounding flips the slope: at this batch a
# mask-head unit at 5.3e-6 (float64) takes the other branch in the port and
# moves update_block.mask.0's gradient by 0.9% of that leaf's largest while
# the whole gradient stays within 1.6e-5 (and, on other batches, leaves move
# by 2-3% of their own largest); a per-leaf unit measures the kinks, not
# the arithmetic.  A conv bias that a norm follows (NORMED_BIAS) has no
# gradient in exact arithmetic (the norm subtracts it out): float32 noise,
# 1e-10 to 1e-6 of the largest, held in the model's unit for either model.
NORMED_BIAS = re.compile(r"^(fnet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|downsample\.0))\.bias$")
STATS_TOL = 1e-5
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_L2 = 3e-2
# EEMFlow+: JAX's bf16 step also rounds its warp coordinates and the
# upsamplers' interpolation weights to bf16 (the port keeps them float32),
# and the two bf16 gradients lie on either side of the float32 one: 3.75%
# apart, JAX's 2.84% and the port's 3.13% from JAX's float32 gradient
BF16_GRAD_L2_PLUS = 5e-2
BF16_GRAD_NOISE = 3.0
BF16_GRAD_COS = 0.9
# ERAFT's eval flow after the steps, relative to max(1, largest |flow|):
# tests/test_torch_eraft.py's 1e-4 on flows of order 1 (float32 through 3
# iterations), scaled to these flows of ~12 px, from parameters that differ
# by the steps' drift
FLOW_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carrying_grads(tx):
    """``tx`` whose state also carries the last gradient it was given."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _plus_variables(shape):
    """He-scaled EEMFlow+ params (shapes from ``eval_shape``), filled from numpy."""
    ev = jnp.zeros((1, *shape))
    shapes = jax.eval_shape(JaxEEMFlowPlus().init, jax.random.PRNGKey(0), ev, ev)
    rng = np.random.default_rng(1)

    def fill(s):
        fan = {4: int(np.prod(s.shape[:3])), 2: s.shape[0]}.get(len(s.shape))
        scale = 0.1 if fan is None else np.sqrt(2.0 / fan)
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return {"params": jax.tree_util.tree_map(fill, shapes)["params"]}


def _eraft_variables(shape):
    """ERAFT variables drawn as the JAX init draws them (``tests/
    test_torch_eraft.py``): He-normal fan-out encoders, 1/fan-in GRU,
    2/fan-in elsewhere, zero biases, BatchNorm at its init statistics."""
    ev = jnp.zeros((1, *shape))
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


# per model: the JAX module, the port's, the input [H, W, bins], the
# learning rate, the variables and their conversion to a state_dict, and the
# batch's seed (see the module docstring for EEMFlow+'s)
MODELS = {
    "eemflow_plus": dict(jax=lambda: JaxEEMFlowPlus(), port=lambda: EEMFlowPlus(n_first_channels=15),
                         shape=(64, 128, 15), lr=1e-3, variables=_plus_variables,
                         to_port=lambda v: eemflow_plus_state_dict_from_jax(v["params"]), seed=5,
                         per_leaf=True),
    "eraft": dict(jax=lambda: JaxERAFT(iters=3), port=lambda: ERAFT(iters=3), shape=(64, 96, 5), lr=1e-5,
                  variables=_eraft_variables, to_port=eraft_state_dict_from_jax, seed=4, per_leaf=False),
}


def _batch(shape, seed):
    rng = np.random.default_rng(seed)
    h, w, c = shape
    return {
        "event_volume_old": rng.standard_normal((B, h, w, c)).astype(np.float32),
        "event_volume_new": rng.standard_normal((B, h, w, c)).astype(np.float32),
        "flow": (rng.standard_normal((B, h, w, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, h, w), np.float32),
    }


def _jax_run(name):
    """JAX's ``make_train_step`` (float32 and bf16, one compile): the
    variables after 1 and 3 float32 steps and after 1 bf16 step, the steps'
    losses, and the gradients at the start."""
    spec = MODELS[name]
    model = spec["jax"]()
    tx = _carrying_grads(jax_make_optimizer(lr=spec["lr"], wdecay=WD, num_steps=NUM_STEPS))
    step32 = jax_make_train_step(model, tx, donate=False)
    step16 = jax_make_train_step(model, tx, donate=False, mixed_precision=True)

    @jax.jit
    def both(state, batch):
        return step32(state, batch) + step16(state, batch)

    variables = spec["variables"](spec["shape"])
    params = variables["params"]
    batch = {k: jnp.asarray(v) for k, v in _batch(spec["shape"], spec["seed"]).items()}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                          batch_stats=variables.get("batch_stats", {}))
    # LLVM's optimization level 0 halves EEMFlow+'s compile; ERAFT's 3-step
    # scan runs 15x slower at it, so it keeps the default
    opts = {"xla_backend_optimization_level": 0} if name == "eemflow_plus" else {}
    both = both.lower(state, batch).compile(compiler_options=opts)
    s1, m1, s16, m16 = both(state, batch)
    s2 = both(s1, batch)[0]
    s3 = both(s2, batch)[0]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    var = lambda s: {"params": np_tree(s.params), "batch_stats": np_tree(s.batch_stats)}
    grads = lambda s: {"params": np_tree(s.opt_state[1])}
    return {
        "variables": variables, "loss": float(m1["loss"]), "epe": float(m1["epe"]), "grads": grads(s1),
        "after": {1: var(s1), 3: var(s3)},
        "bf16": {"loss": float(m16["loss"]), "grads": grads(s16), "after": var(s16)},
    }


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax(jax_runs, name):
    if name not in jax_runs:
        jax_runs[name] = _jax_run(name)
    return jax_runs[name]


def _port_run(name, variables, steps, bf16):
    """The port from the same variables and batch: (losses, grads of step 1
    before the clip, epe of step 1, state)."""
    spec = MODELS[name]
    tx = make_optimizer(lr=spec["lr"], wdecay=WD, num_steps=NUM_STEPS)
    state = create_train_state(spec["port"](), 0, tx, params=spec["to_port"](variables))
    grads = {}
    opt_step = state.opt.step

    def step_recording_grads():
        if not grads:
            grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})
        return opt_step()

    state.opt.step = step_recording_grads
    step = make_train_step(mixed_precision=bf16)
    batch = {k: torch.from_numpy(v) for k, v in _batch(spec["shape"], spec["seed"]).items()}
    losses, epe = [], None
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        epe = float(metrics["epe"]) if epe is None else epe
    return losses, grads, epe, state


def _leaves(name, tree, suffixes):
    """A JAX variables-shaped tree as the port's {name: array}, each leaf
    once (the converter also writes ``norm3`` as ``downsample.1``)."""
    sd = MODELS[name]["to_port"](tree)
    return {k: v.numpy() for k, v in sd.items() if k.endswith(suffixes) and ".downsample.1." not in k}


def _params(name, tree):
    return _leaves(name, tree, ("weight", "bias"))


def _stats(name, tree):
    return _leaves(name, tree, ("running_mean", "running_var"))


def _grad_scale(name, g, n):
    """The gradient unit of leaf ``n``: its own largest |g| (EEMFlow+), or
    the model's (ERAFT, and the conv biases a norm subtracts out); see
    ``GRAD_TOL``'s comment."""
    top = max(np.abs(v).max() for v in g.values())
    if MODELS[name]["per_leaf"] and not NORMED_BIAS.match(n):
        return np.abs(g[n]).max()
    return top


def _lr_sum(name, n):
    sched = onecycle_lr(MODELS[name]["lr"], NUM_STEPS + 100)
    return sum(sched(i) for i in range(n))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_float32_step_loss_and_grads_match_jax(jax_runs, name):
    ref = _jax(jax_runs, name)
    losses, grads, epe, _ = _port_run(name, ref["variables"], 1, bf16=False)
    np.testing.assert_allclose(losses[0], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(epe, ref["epe"], rtol=LOSS_RTOL)
    g = _params(name, ref["grads"])
    assert set(g) == set(grads)
    for n, got in grads.items():
        scale = _grad_scale(name, g, n)
        err = np.abs(got.numpy() - g[n]).max()
        assert err <= GRAD_TOL * scale, f"{n}: max|Δg| {err:.3e} of max|g| {scale:.3e}"
    if not MODELS[name]["per_leaf"]:
        ours, theirs = (np.concatenate([d[n].ravel() for n in sorted(g)])
                        for d in ({n: v.numpy() for n, v in grads.items()}, g))
        assert np.linalg.norm(ours - theirs) <= GRAD_TOL * np.linalg.norm(theirs)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_float32_params_and_batch_stats_after_steps_match_jax(jax_runs, name, steps):
    ref = _jax(jax_runs, name)
    _, _, _, state = _port_run(name, ref["variables"], steps, bf16=False)
    assert state.step == steps
    after = _params(name, ref["after"][steps])
    g = _params(name, ref["grads"])
    moved = _lr_sum(name, steps)
    for n, p in state.model.named_parameters():
        err = np.abs(p.detach().numpy() - after[n])
        unit = _grad_scale(name, g, n)
        big = np.abs(g[n]) > (BIG_GRAD if MODELS[name]["per_leaf"] else BIG_GRAD_MODEL) * unit
        # no closer than two float32 spacings of the parameter itself
        ulps = 2 * np.spacing(np.abs(after[n]))
        tol = np.maximum((PARAM_TOL if steps == 1 else PARAM_TOL_3) * moved, ulps)
        assert (err <= PARAM_TOL_ALL * moved + ulps).all(), n
        assert (err <= tol)[big].all(), f"{n}: {(err - tol)[big].max():.3e} over"
    stats = _stats(name, ref["after"][steps])
    own = state.model.state_dict()
    assert len(stats) == (30 if name == "eraft" else 0)  # cnet's 15 BatchNorms
    for n, r in stats.items():
        err = np.abs(own[n].numpy() - r).max()
        assert err <= STATS_TOL * np.abs(r).max(), f"{n}: {err:.3e} of {np.abs(r).max():.3e}"
        assert int(own[n.rsplit(".", 1)[0] + ".num_batches_tracked"]) == steps


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_step_matches_jax(jax_runs, name):
    ref = _jax(jax_runs, name)
    losses, grads, _, state = _port_run(name, ref["variables"], 1, bf16=True)
    own_noise = abs(ref["bf16"]["loss"] - ref["loss"])
    assert abs(losses[0] - ref["bf16"]["loss"]) <= max(BF16_LOSS_RTOL * abs(ref["bf16"]["loss"]), own_noise), (
        f"bf16 loss {losses[0]:.6f}, JAX's {ref['bf16']['loss']:.6f} (its float32 {ref['loss']:.6f})")
    g16, g32 = _params(name, ref["bf16"]["grads"]), _params(name, ref["grads"])
    names = sorted(grads)
    for n in names:
        assert grads[n].dtype == torch.float32, n  # the grads reach the float32 masters
        if NORMED_BIAS.match(n):
            continue  # no gradient in exact arithmetic: no direction to compare
        a, b = grads[n].numpy().ravel(), g16[n].ravel()
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        assert cos >= BF16_GRAD_COS, f"{n}: cosine {cos:.4f} to JAX's bf16 gradient"
    ours, theirs, theirs32 = (np.concatenate([d[n].ravel() for n in names])
                              for d in ({n: grads[n].numpy() for n in names}, g16, g32))
    rel = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
    noise = np.linalg.norm(theirs - theirs32) / np.linalg.norm(theirs32)
    limit = BF16_GRAD_L2_PLUS if name == "eemflow_plus" else BF16_GRAD_L2
    assert rel <= limit and rel <= BF16_GRAD_NOISE * noise, (
        f"the bf16 gradient is {rel:.3%} (relative L2) from JAX's, which is {noise:.3%} from its float32 one")
    after = _params(name, ref["bf16"]["after"])
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32
        # Adam's first step is sign-like: opposite signs move an element 2 lr apart
        err = np.abs(p.detach().numpy() - after[n])
        assert (err <= PARAM_TOL_ALL * _lr_sum(name, 1) + 2 * np.spacing(np.abs(after[n]))).all(), n
    # the statistics stay float32 and take the bf16 forward's batch statistics
    own = state.model.state_dict()
    for n, r in _stats(name, ref["bf16"]["after"]).items():
        assert own[n].dtype == torch.float32, n
        assert np.abs(own[n].numpy() - r).max() <= BF16_GRAD_L2 * np.abs(r).max(), n


@pytest.mark.parametrize("steps", [1, 3])
def test_eraft_eval_flow_after_steps_matches_jax(jax_runs, steps):
    """After the steps, both models in eval mode (the running statistics,
    the mask head once) on a fresh input."""
    ref = _jax(jax_runs, "eraft")
    _, _, _, state = _port_run("eraft", ref["variables"], steps, bf16=False)
    rng = np.random.default_rng(21)
    ev1, ev2 = (rng.standard_normal((1, 64, 96, 5)).astype(np.float32) for _ in range(2))
    m = JaxERAFT(iters=3, upsample_all=False)
    _, want = jax.jit(m.apply)(ref["after"][steps], jnp.asarray(ev1), jnp.asarray(ev2))
    model = state.model.eval()
    model.upsample_all = False
    with torch.no_grad():
        _, got = model(torch.from_numpy(ev1), torch.from_numpy(ev2))
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 1, 64, 96, 2) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOW_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batchnorm_matches_flax(dtype):
    """Two training-mode calls and one eval-mode call of the port's
    BatchNorm against flax's ``nn.BatchNorm(momentum=0.9)``: the output,
    and the running mean and biased variance (torch's BatchNorm2d would
    move the variance towards the unbiased one)."""
    rng = np.random.default_rng(3)
    xs = [(rng.standard_normal((2, 5, 4, 3)) * 2 + 1).astype(np.float32) for _ in range(3)]
    scale, bias = rng.standard_normal(3).astype(np.float32), rng.standard_normal(3).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    variables = {"params": {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)},
                 "batch_stats": {"mean": jnp.zeros(3), "var": jnp.ones(3)}}
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale).to(dtype).float())
        bn.bias.copy_(torch.from_numpy(bias).to(dtype).float())
    w, b = bn.weight.to(dtype), bn.bias.to(dtype)
    for i, x in enumerate(xs):
        train = i < 2
        flax_bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5)
        out = flax_bn.apply(variables, jnp.asarray(x, jdt), mutable=["batch_stats"] if train else False)
        want, variables = (out[0], {**variables, **out[1]}) if train else (out, variables)
        bn.train(train)
        got = torch.func.functional_call(bn, {"weight": w, "bias": b},
                                         (torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype),))
        assert got.dtype == dtype
        want = np.asarray(jnp.asarray(want, jnp.float32)).transpose(0, 3, 1, 2)
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7
        np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=tol, atol=tol)
        assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(variables["batch_stats"]["mean"]), rtol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(variables["batch_stats"]["var"]), rtol=1e-6)
    assert int(bn.num_batches_tracked) == 2


def test_eraft_seeded_init_draws_the_reference_encoders():
    """``create_train_state`` draws ERAFT anew from the seed: the layers'
    own initializers, then the encoders' He-normal (fan out) convs and
    unit-scale norms, as the reference builds them."""
    tx = make_optimizer(lr=1e-5)
    a = create_train_state(ERAFT(iters=1), 11, tx).model
    b = create_train_state(ERAFT(iters=1), 11, tx).model
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = a.cnet.layer2[0].conv1.weight  # [96, 64, 3, 3]: fan out 96·9
    assert abs(float(w.detach().std()) / np.sqrt(2.0 / (96 * 9)) - 1) < 0.05
    assert torch.equal(a.cnet.norm1.weight, torch.ones(64)) and torch.equal(a.cnet.norm1.running_var, torch.ones(64))


def test_eraft_checkpoint_resume_gives_the_uninterrupted_step(tmp_path):
    """Three ERAFT steps straight, against two steps, a checkpoint, a restore
    into a fresh state (other seed) and the third step: the same
    parameters, BatchNorm statistics, step and learning rate."""
    batch = {k: torch.from_numpy(v) for k, v in _batch((32, 64, 5), 6).items()}
    tx = make_optimizer(lr=1e-4, wdecay=WD, num_steps=NUM_STEPS)
    step = make_train_step()
    straight = create_train_state(ERAFT(iters=2), 7, tx)
    for _ in range(3):
        straight, _ = step(straight, batch)
    first = create_train_state(ERAFT(iters=2), 7, tx)
    for _ in range(2):
        first, _ = step(first, batch)
    save_checkpoint(str(tmp_path), first, epoch=1)
    resumed, epoch = restore_checkpoint(str(tmp_path), create_train_state(ERAFT(iters=2), 8, tx))
    assert epoch == 1 and resumed.step == 2
    resumed, _ = step(resumed, batch)
    assert resumed.step == straight.step == 3 and resumed.opt.lr == straight.opt.lr
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    assert any("running_var" in k for k in want)
    for k, v in want.items():
        assert torch.equal(v, got[k]), k


@pytest.mark.parametrize("name,kw", [("eemflow_plus", {"n_first_channels": 5}),
                                     ("eraft", {"iters": 2, "stacked_lookup": True})], ids=["eemflow_plus", "eraft"])
def test_training_after_an_inference_mode_forward(name, kw):
    """The constants the ops cache (EEMFlow+'s upsampling rates, the
    stacked lookup's level tables) are made outside inference mode: an
    eval forward under ``torch.inference_mode`` before training leaves
    nothing that a train step's backward cannot save."""
    from eemflow_tpu_torch.models.registry import get_model

    rng = np.random.default_rng(8)
    h, w = (40, 72) if name == "eemflow_plus" else (24, 40)  # shapes no other test caches
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((1, h, w, 5)).astype(np.float32)) for _ in range(2))
    model = get_model(name, **kw)
    with torch.inference_mode():
        model.eval()(ev1, ev2)
    batch = {"event_volume_old": ev1, "event_volume_new": ev2, "flow": torch.ones(1, h, w, 2),
             "valid": torch.ones(1, h, w)}
    state = create_train_state(model, 0, make_optimizer(lr=1e-4))
    _, metrics = make_train_step()(state, batch)
    assert np.isfinite(float(metrics["loss"]))


SENSOR = (64, 128)


@pytest.fixture
def small_sensor(monkeypatch):
    """The HREM dataset at a 64×128 sensor (its class attributes), so that
    the CLI's steps take a second on the CPU."""
    monkeypatch.setattr(HREMEventFlow, "image_height", SENSOR[0])
    monkeypatch.setattr(HREMEventFlow, "image_width", SENSOR[1])


def _train_split(base, n_samples, seed=7, n_events=3000):
    """A synthetic HREM training split at the small sensor."""
    rng = np.random.default_rng(seed)
    h, w = SENSOR
    root = os.path.join(base, "hrem")
    for i in range(n_samples):
        d = os.path.join(root, "train", "dt1", f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        for name in ("events1.npz", "events2.npz"):
            np.savez(os.path.join(d, name), x=rng.integers(0, w, n_events).astype(np.int32),
                     y=rng.integers(0, h, n_events).astype(np.int32),
                     t=np.sort(rng.integers(0, 10**9, n_events)).astype(np.int64),
                     p=rng.integers(0, 2, n_events).astype(np.int8))
        write_flo((rng.standard_normal((h, w, 2)) * 2).astype(np.float32), os.path.join(d, "flow.flo"))
    return root


@pytest.mark.parametrize("model", ["eemflow_plus", "eraft", "raft"])
def test_train_cli_needs_full_res_flow(tmp_path, model):
    """Full-resolution models against the 16×16 meshflow label: refused
    before any step (the JAX CLI fails at the loss's broadcast), naming the
    flag."""
    save = tmp_path / "runs"
    with pytest.raises(SystemExit) as e:
        train_main(["-model", model, "--data_root", str(tmp_path), "--device", "cpu", "--save_dir", str(save)])
    assert "--full_res_flow" in str(e.value.code) and not save.exists()


def test_train_cli_eemflow_plus_takes_the_configs_15_bins(tmp_path, small_sensor):
    """``-model eemflow_plus --config configs/hrem_eemflow_plus.json
    --full_res_flow --device_voxelize``: the model's first conv takes the
    config's 15 bins, the bf16 run (the config's mixed precision) logs
    finite losses and checkpoints."""
    root = _train_split(str(tmp_path), 1)
    state = train_main([
        "-model", "eemflow_plus", "--config", os.path.join(REPO, "configs", "hrem_eemflow_plus.json"),
        "--full_res_flow", "--device_voxelize", "--data_root", root, "-bs", "1", "--train_iters", "2",
        "--val_iters", "2", "--device", "cpu", "--save_dir", str(tmp_path / "runs")])
    assert state.step == 2 and state.model.pconv1_1[0].weight.shape[1] == 15
    run = tmp_path / "runs" / "eemflow_plus_dt1_lr1e-05_wd0.0"
    with open(run / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["kind"] for r in recs] == ["epoch"] and np.isfinite(recs[0]["mean_loss"])
    assert os.listdir(run / "ckpt") == ["epoch_1.pt"]


def test_train_cli_eraft_resumes_to_the_uninterrupted_run(tmp_path, small_sensor):
    """``-model eraft --full_res_flow`` (2 iterations, no flips, one sample,
    so that every step sees the same batch): two epochs of one step, then
    ``-se 1`` runs the second epoch again from the first checkpoint and ends
    with the uninterrupted run's parameters, BatchNorm statistics, step and
    learning rate."""
    root = _train_split(str(tmp_path), 1, seed=9)
    cfg = tmp_path / "eraft.json"
    cfg.write_text(json.dumps({"iters": 2, "data_loader": {"train": {"args": {
        "num_voxel_bins": 5, "aug_params": {"crop_size": list(SENSOR), "do_flip": False}}}}}))
    args = ["-model", "eraft", "--config", str(cfg), "--full_res_flow", "--data_root", root, "-bs", "1",
            "--train_iters", "2", "--val_iters", "1", "--device", "cpu", "--lr", "1e-4",
            "--save_dir", str(tmp_path / "runs")]
    state = train_main(args)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    resumed = train_main(args + ["-se", "1"])
    assert resumed.step == state.step == 2 and resumed.opt.lr == state.opt.lr
    got = resumed.model.state_dict()
    assert int(got["cnet.norm1.num_batches_tracked"]) == 2
    for k, v in want.items():
        assert torch.equal(v, got[k]), k
