"""The port's training engine against the JAX package's, on the CPU:
``sequence_loss`` and its metrics, ``onecycle_lr``, the clip + AdamW chain
against optax over 5 steps, one EEMFlow train step (float32 and bf16) from
the same parameters and batch against ``make_train_step`` and
``jax.value_and_grad`` of the same loss (64×128, B=2, meshflow output),
checkpoint save/restore/resume, and the trainer's ``metrics.jsonl``
records.  The JAX side compiles one function, the float32 and the bf16
step, shared through a module-scoped fixture; each step's optimizer
carries the gradient ``jax.value_and_grad`` gave it out in its state."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from eemflow_tpu.models.eemflow import EEMFlow as JaxEEMFlow
from eemflow_tpu.train.loss import sequence_loss as jax_sequence_loss
from eemflow_tpu.train.optim import make_optimizer as jax_make_optimizer
from eemflow_tpu.train.optim import onecycle_lr as jax_onecycle_lr
from eemflow_tpu.train.trainer import TrainState as JaxTrainState
from eemflow_tpu.train.trainer import Trainer as JaxTrainer
from eemflow_tpu.train.trainer import make_train_step as jax_make_train_step
from eemflow_tpu.utils.logger import Logger as JaxLogger

from eemflow_tpu_torch.compat.from_jax import eemflow_state_dict_from_jax
from eemflow_tpu_torch.models.eemflow import EEMFlow
from eemflow_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from eemflow_tpu_torch.train.loss import sequence_loss
from eemflow_tpu_torch.train.optim import clip_by_global_norm_, make_optimizer, onecycle_lr
from eemflow_tpu_torch.train.trainer import Trainer, create_train_state, make_train_step
from eemflow_tpu_torch.utils.logger import Logger

B, H, W = 2, 64, 128
LR, WD, NUM_STEPS = 1e-3, 1e-4, 100
# float32 step: loss relative, grads per leaf relative to the leaf's largest
# |g|; parameters after n steps in units of the learning rates summed over
# those steps (the most an Adam step moves a parameter), tighter where the
# gradient is not tiny (Adam's first step is sign-like for tiny grads)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL, PARAM_TOL_ALL, BIG_GRAD = 1e-2, 2.0, 1e-3
# bf16 step: XLA and the port round at different points (XLA rounds every
# product of the correlation, the port its sum; each rounds its own conv
# and pool results), and a bf16 gradient is noisy in itself, so it is held
# in aggregate: the loss within 1e-3 relative; the whole gradient within 3%
# (relative L2) of JAX's bf16 gradient and no farther from it than 3× the
# distance of JAX's bf16 gradient from its own float32 one; every leaf's
# gradient pointing JAX's way (cosine at least 0.9)
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_L2 = 3e-2
BF16_GRAD_NOISE = 3.0
BF16_GRAD_COS = 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed=3):
    """JAX EEMFlow params (shapes from ``eval_shape``) drawn with numpy:
    He-scaled kernels (LeakyReLU 0.1 down the pyramid), small biases."""
    x = jnp.zeros((1, H, W, 5))
    shapes = jax.eval_shape(JaxEEMFlow(out_mesh_size=True).init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            kh, kw, cin, _ = s.shape
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / (kh * kw * cin))).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    return {
        "event_volume_old": rng.standard_normal((B, H, W, 5)).astype(np.float32),
        "event_volume_new": rng.standard_normal((B, H, W, 5)).astype(np.float32),
        "flow": (rng.standard_normal((B, 16, 16, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, 16, 16), np.float32),
    }


def _carrying_grads(tx):
    """``tx`` whose state also carries the last gradient it was given."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's ``make_train_step``: params after 1 and 3 float32 steps and
    after 1 bf16 step, the steps' losses, and the gradients
    (``jax.value_and_grad`` of the step's loss) at the start."""
    model = JaxEEMFlow(out_mesh_size=True)
    tx = _carrying_grads(jax_make_optimizer(lr=LR, wdecay=WD, num_steps=NUM_STEPS))
    step32 = jax_make_train_step(model, tx, donate=False)
    step16 = jax_make_train_step(model, tx, donate=False, mixed_precision=True)

    @jax.jit
    def both(state, batch):
        return step32(state, batch) + step16(state, batch)

    params = _jax_params()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                          batch_stats={})
    # the compile is the fixture's cost (a run of both steps takes a tenth
    # of a second): LLVM's optimization level 0 takes a third off it and
    # leaves the XLA graph as it is (results move in float32's last digits)
    both = both.lower(state, batch).compile(compiler_options={"xla_backend_optimization_level": 0})
    s1, m1, s16, m16 = both(state, batch)
    s2 = both(s1, batch)[0]
    s3 = both(s2, batch)[0]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {
        "params": params, "grads": np_tree(s1.opt_state[1]), "loss": float(m1["loss"]),
        "after": {1: np_tree(s1.params), 3: np_tree(s3.params)},
        "bf16": {"grads": np_tree(s16.opt_state[1]), "loss": float(m16["loss"]), "after": np_tree(s16.params)},
        "epe": float(m1["epe"]), "step": int(s3.step),
    }


def _port_run(params, steps, bf16):
    """The port from the same params and batch: (losses, grads of step 1
    before the clip, epe of step 1, state)."""
    tx = make_optimizer(lr=LR, wdecay=WD, num_steps=NUM_STEPS)
    state = create_train_state(EEMFlow(out_mesh_size=True), 0, tx, params=eemflow_state_dict_from_jax(params))
    grads = {}
    opt_step = state.opt.step

    def step_recording_grads():
        if not grads:
            grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})
        return opt_step()

    state.opt.step = step_recording_grads
    step = make_train_step(mixed_precision=bf16)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    losses, epe = [], None
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        epe = float(metrics["epe"]) if epe is None else epe
    return losses, grads, epe, state


def _leaves(tree):
    """A JAX params-shaped tree as the port's {name: array}."""
    sd = eemflow_state_dict_from_jax(tree)
    sd.pop("index")
    return {k: v.numpy() for k, v in sd.items()}


def _lr_sum(n):
    sched = onecycle_lr(LR, NUM_STEPS + 100)
    return sum(sched(i) for i in range(n))


def test_sequence_loss_matches_jax():
    rng = np.random.default_rng(0)
    N = 3
    preds = rng.standard_normal((N, B, 8, 10, 2)).astype(np.float32)
    gt = (rng.standard_normal((B, 8, 10, 2)) * 3).astype(np.float32)
    gt[0, 0, 0] = 500.0  # past MAX_FLOW: masked
    valid = (rng.random((B, 8, 10)) > 0.3).astype(np.float32)
    loss, metrics = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt), torch.from_numpy(valid))
    jloss, jmetrics = jax.jit(jax_sequence_loss)(jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert set(metrics) == set(jmetrics) == {"epe", "1px", "3px", "5px"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-6, err_msg=k)
    # a list of predictions is the stacked tensor
    loss_l, _ = sequence_loss([torch.from_numpy(p) for p in preds], torch.from_numpy(gt), torch.from_numpy(valid))
    assert float(loss_l) == float(loss)


@pytest.mark.parametrize("total", [1000, 210, 7])
def test_onecycle_lr_matches_jax(total):
    ours = onecycle_lr(1e-4, total)
    steps = np.arange(total + 6)
    theirs = np.asarray(jax.jit(jax.vmap(jax_onecycle_lr(1e-4, total)))(steps))
    # the JAX schedule computes in float32: a few of its ulps at the peak
    np.testing.assert_allclose([ours(int(n)) for n in steps], theirs, rtol=1e-6, atol=1e-6 * 1e-4)


@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_clip_and_adamw_match_optax(clip):
    """Five updates of the port's chain against the optax chain on the same
    parameters and gradients (biases decayed too)."""
    rng = np.random.default_rng(1)
    shapes = {"w": (4, 3, 3, 3), "b": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]
    tx = jax_make_optimizer(lr=1e-2, wdecay=0.1, num_steps=20, clip=clip)

    @jax.jit
    def jax_step(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    jp, opt_state = dict(params), tx.init(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(lr=1e-2, wdecay=0.1, num_steps=20, clip=clip)(tp.values())
    for g in grads:
        jp, opt_state = jax_step(g, opt_state, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


def test_clip_by_global_norm_is_optax():
    rng = np.random.default_rng(2)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((5, 7), (3,))]
    for max_norm in (0.5, 1e3):
        clipped, _ = optax.clip_by_global_norm(max_norm).update(gs, None)
        ts = [torch.from_numpy(g.copy()) for g in gs]
        norm = clip_by_global_norm_(ts, max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(gs)), rtol=1e-6)
        for t, c in zip(ts, clipped):
            np.testing.assert_allclose(t.numpy(), np.asarray(c), rtol=1e-6)


def test_float32_step_loss_and_grads_match_jax(jax_run):
    losses, grads, epe, _ = _port_run(jax_run["params"], 1, bf16=False)
    np.testing.assert_allclose(losses[0], jax_run["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(epe, jax_run["epe"], rtol=LOSS_RTOL)
    ref = _leaves(jax_run["grads"])
    assert set(ref) == set(grads)
    for name, g in grads.items():
        scale = np.abs(ref[name]).max()
        assert scale > 0, name
        err = np.abs(g.numpy() - ref[name]).max()
        assert err <= GRAD_TOL * scale, f"{name}: max|Δg| {err:.3e} of max|g| {scale:.3e}"


@pytest.mark.parametrize("steps", [1, 3])
def test_float32_params_after_steps_match_jax(jax_run, steps):
    _, _, _, state = _port_run(jax_run["params"], steps, bf16=False)
    assert state.step == steps
    ref = _leaves(jax_run["after"][steps])
    g = _leaves(jax_run["grads"])
    moved = _lr_sum(steps)
    for name, p in state.model.named_parameters():
        err = np.abs(p.detach().numpy() - ref[name])
        big = np.abs(g[name]) > BIG_GRAD * np.abs(g[name]).max()
        assert err.max() <= PARAM_TOL_ALL * moved, name
        assert err[big].max() <= PARAM_TOL * moved, f"{name}: {err[big].max():.3e} vs {PARAM_TOL * moved:.3e}"


def test_bf16_step_matches_jax(jax_run):
    ref = jax_run["bf16"]
    losses, grads, _, state = _port_run(jax_run["params"], 1, bf16=True)
    np.testing.assert_allclose(losses[0], ref["loss"], rtol=BF16_LOSS_RTOL)
    g = _leaves(ref["grads"])
    names = sorted(grads)
    for name in names:
        assert grads[name].dtype == torch.float32, name  # the grads reach the float32 masters
        a, b = grads[name].numpy().ravel(), g[name].ravel()
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        assert cos >= BF16_GRAD_COS, f"{name}: cosine {cos:.4f} to JAX's bf16 gradient"
    g32 = _leaves(jax_run["grads"])
    ours, theirs, theirs32 = (np.concatenate([d[n].ravel() for n in names])
                              for d in ({n: grads[n].numpy() for n in names}, g, g32))
    rel = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
    noise = np.linalg.norm(theirs - theirs32) / np.linalg.norm(theirs32)
    assert rel <= BF16_GRAD_L2 and rel <= BF16_GRAD_NOISE * noise, (
        f"the bf16 gradient is {rel:.3%} (relative L2) from JAX's, which is {noise:.3%} from its float32 one")
    after = _leaves(ref["after"])
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32
        assert np.abs(p.detach().numpy() - after[name]).max() <= PARAM_TOL_ALL * _lr_sum(1), name


def test_checkpoint_resume_gives_the_uninterrupted_step(tmp_path):
    """Three steps straight, against two steps, a checkpoint, a restore into
    a fresh state (other seed) and the third step: the same parameters, step
    and learning rate."""
    rng = np.random.default_rng(6)
    batch = {
        "event_volume_old": torch.from_numpy(rng.standard_normal((1, 64, 64, 5)).astype(np.float32)),
        "event_volume_new": torch.from_numpy(rng.standard_normal((1, 64, 64, 5)).astype(np.float32)),
        "flow": torch.ones(1, 16, 16, 2), "valid": torch.ones(1, 16, 16),
    }
    tx = make_optimizer(lr=LR, wdecay=WD, num_steps=NUM_STEPS)
    step = make_train_step()
    straight = create_train_state(EEMFlow(out_mesh_size=True), 7, tx)
    for _ in range(3):
        straight, _ = step(straight, batch)

    first = create_train_state(EEMFlow(out_mesh_size=True), 7, tx)
    for _ in range(2):
        first, _ = step(first, batch)
    d = str(tmp_path / "ckpt")
    for epoch in (1, 2, 3, 4):  # the three newest are kept
        save_checkpoint(d, first, epoch=epoch)
    assert sorted(os.listdir(d)) == ["epoch_2.pt", "epoch_3.pt", "epoch_4.pt"]
    resumed, epoch = restore_checkpoint(d, create_train_state(EEMFlow(out_mesh_size=True), 8, tx))
    assert epoch == 4 and resumed.step == 2
    assert resumed.opt.lr == first.opt.lr
    resumed, _ = step(resumed, batch)
    assert resumed.step == straight.step == 3 and resumed.opt.lr == straight.opt.lr
    for (n, a), b in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n
    blank = create_train_state(EEMFlow(out_mesh_size=True), 8, tx)
    assert restore_checkpoint(str(tmp_path / "none"), blank) == (blank, 0)


def test_seeded_init_is_deterministic():
    tx = make_optimizer(lr=LR)
    a = create_train_state(EEMFlow(), 11, tx).model.state_dict()
    b = create_train_state(EEMFlow(), 11, tx).model.state_dict()
    c = create_train_state(EEMFlow(), 12, tx).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pconv1_1.0.weight"], c["pconv1_1.0.weight"])


def test_trainer_writes_jax_metrics_records(tmp_path):
    """Both trainers fed the same fixed per-step metrics (their steps
    replaced): the same log lines and the same ``metrics.jsonl`` records,
    but for the wall-clock fields."""
    losses = [0.5, 0.25, 0.125, 1.0, 2.0]
    runs = {}
    for name, logger_cls, trainer in (
        ("jax", JaxLogger, lambda lg: JaxTrainer(JaxEEMFlow(), optax.sgd(0.1), logger=lg, log_every=2)),
        ("port", Logger, lambda lg: Trainer(logger=lg, log_every=2)),
    ):
        out = tmp_path / name
        logger = logger_cls(str(out))
        tr = trainer(logger)
        it = iter(losses)
        as_array = jnp.asarray if name == "jax" else torch.tensor

        def fake_step(state, batch, it=it, as_array=as_array):
            loss = next(it)
            return state, {"loss": as_array(loss), "epe": as_array(2 * loss)}

        tr.train_step = fake_step
        tr.train_iters(None, iter(range(5)), start_epoch=1, val_iters=5)
        with open(logger.jsonl_path) as f:
            recs = [json.loads(line) for line in f]
        with open(logger.path) as f:
            lines = [line.split("  steps/s")[0] for line in f]
        for r in recs:
            r.pop("wall_s", None)
            r.pop("steps_per_sec", None)
        runs[name] = (recs, lines)
    assert runs["port"] == runs["jax"]
    recs = runs["port"][0]
    assert [r["kind"] for r in recs] == ["train", "train", "epoch"]
    assert recs[-1]["n_steps"] == 5 and recs[0]["step"] == 7
