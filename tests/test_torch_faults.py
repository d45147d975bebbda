"""Three faults of the port, each pinned on the CPU.

  * F1: K2's gradient.  ``local_corr`` goes through ``LocalCorr``, an
    ``autograd.Function`` whose backward is the twin's autograd; its grads
    equal plain autograd through the twin and ``jax.vjp`` of the JAX
    correlation.  (On the card the same Function wraps the kernel: the
    ``gpu``-marked test in ``test_torch_gpu.py``.)  The eval-only fused
    modes lose no gradient either: ERAFT's ``fused_update`` gives the
    module path's gradients on the CPU, and EEMFlow's ``fast_head``, whose
    weights are packed detached, refuses to run under grad.
  * F2: packed weights follow in-place parameter edits (``PackCache``).
  * F3: the HREM CLI drops a checkpoint's correlation ``index`` for the
    model's own, as the JAX CLI does, and says so in one line.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eemflow_tpu.ops.correlation import local_correlation as jax_local_correlation
from test_golden_acceptance import CKPT, GOLDEN, make_hrem_fixture

from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
from eemflow_tpu_torch.kernels.local_corr import LocalCorr, local_corr, plain
from eemflow_tpu_torch.models.eemflow import INDEX_49, INDEX_53
from eemflow_tpu_torch.models.eraft import ERAFT
from eemflow_tpu_torch.models.registry import get_eval_model
from eemflow_tpu_torch.ops.coarse_head import HeadWeights
from eemflow_tpu_torch.tools.test_hrem import main as hrem_cli


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAD_TOL = 1e-5


@pytest.mark.parametrize("indices", [INDEX_53, None], ids=["index53", "full81"])
def test_k2_function_grads_match_autograd_and_jax(indices):
    rng = np.random.default_rng(0)
    xa, ya = (rng.standard_normal((2, 6, 7, 16)).astype(np.float32) for _ in range(2))
    k = 81 if indices is None else len(indices)
    g = rng.standard_normal((2, 6, 7, k)).astype(np.float32)

    x, y = (torch.from_numpy(a).requires_grad_() for a in (xa, ya))
    out = local_corr(x, y, 4, indices)
    assert isinstance(out.grad_fn, LocalCorr._backward_cls)
    gx, gy = torch.autograd.grad(out, [x, y], torch.from_numpy(g))

    x2, y2 = (torch.from_numpy(a).requires_grad_() for a in (xa, ya))
    px, py = torch.autograd.grad(plain(x2, y2, 4, indices), [x2, y2], torch.from_numpy(g))

    _, vjp = jax.vjp(lambda a, b: jax_local_correlation(a, b, 4, indices), jnp.asarray(xa), jnp.asarray(ya))
    jx, jy = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    for got, ref, want in ((gx, px, jx), (gy, py, jy)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=GRAD_TOL)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAD_TOL)


def test_k2_function_grad_of_one_input_and_no_grad_path():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 8)).astype(np.float32)).requires_grad_()
    y = torch.from_numpy(rng.standard_normal((1, 4, 5, 8)).astype(np.float32))
    out = local_corr(x, y, 4, INDEX_53)
    (gx,) = torch.autograd.grad(out.sum(), [x])
    (px,) = torch.autograd.grad(plain(x, y, 4, INDEX_53).sum(), [x])
    np.testing.assert_allclose(gx.numpy(), px.numpy(), rtol=0, atol=GRAD_TOL)
    with torch.no_grad():
        assert local_corr(x, y, 4, INDEX_53).grad_fn is None


def test_fused_update_under_grad_gives_the_module_grads():
    """F1 for K5: a grad-enabled eval forward with ``fused_update`` gives
    every update-block parameter the module path's gradient (on the CPU
    K5's plain version reads the parameters themselves; on the card K5
    refuses instead, ``test_torch_gpu.py``)."""
    torch.manual_seed(0)
    std = ERAFT(iters=2).eval()
    fused = ERAFT(iters=2, fused_update=True).eval()
    fused.load_state_dict(std.state_dict())
    rng = np.random.default_rng(5)
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((1, 40, 56, 5)).astype(np.float32)) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((1, 40, 56, 2)).astype(np.float32))
    grads = []
    for m in (std, fused):
        names, params = zip(*((n, p) for n, p in m.named_parameters() if n.startswith("update_block.")))
        grads.append(torch.autograd.grad((m(ev1, ev2)[1][-1] * g).sum(), params))
    for name, want, got in zip(names, *grads):
        scale = float(want.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_fused_head_refuses_grad(impl):
    """F1 for K4: its weights are packed detached, so a ``fast_head``
    forward under grad refuses instead of giving the coarse stage no
    gradient; under ``no_grad`` it runs."""
    model = get_eval_model("eemflow", fast_head=True, fast_head_impl=impl)
    rng = np.random.default_rng(6)
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((1, 128, 192, 5)).astype(np.float32)) for _ in range(2))
    with pytest.raises(RuntimeError, match="eval-only"):
        model(ev1, ev2)
    with torch.no_grad():
        assert np.isfinite(model(ev1, ev2)[1][-1].numpy()).all()


@pytest.fixture(scope="module")
def golden_sd():
    return to_state_dict(load_torch_checkpoint(CKPT))


def _flow(model, seed=3):
    rng = np.random.default_rng(seed)
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((1, 128, 192, 5)).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        return model(ev1, ev2)[1][-1].numpy()


def test_fused_head_follows_an_in_place_edit(golden_sd):
    """F2: edit a decoder weight in place after a fused forward; the next
    fused forward uses the new value, as the standard path does."""
    fused = get_eval_model("eemflow", fast_head=True, fast_pyramid=True)
    std = get_eval_model("eemflow")
    for m in (fused, std):
        m.load_state_dict(golden_sd)
    before = _flow(fused)
    for m in (fused, std):
        with torch.no_grad():
            m.decoder_2.conv7.weight.mul_(-3.0)
            m.out_conv.bias.add_(0.5)
    after = _flow(fused)
    assert np.abs(after - before).max() > 0.1
    np.testing.assert_allclose(after, _flow(std), rtol=0, atol=1e-4)


def test_head_weights_repack_after_an_in_place_edit(golden_sd):
    params = {k: v.clone() for k, v in golden_sd.items() if k != "index"}
    hw = HeadWeights(params, groups=5)
    _, wout, _ = hw.plain(torch.device("cpu"))
    wout = wout.clone()
    params["out_conv.weight"].mul_(2.0)  # a plain tensor: every in-place op bumps its version
    _, wout2, _ = hw.plain(torch.device("cpu"))
    np.testing.assert_allclose(wout2.numpy(), 2.0 * wout.numpy(), rtol=0, atol=1e-6)


def test_cli_drops_a_differing_checkpoint_index(tmp_path, golden_sd, capsys):
    """F3: a checkpoint whose ``index`` holds the 49-entry mask evaluates
    as the same weights with the model's 53-entry ``corr_indices``: the
    golden AEE (the port on the CPU gives it within 3e-8)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    root = make_hrem_fixture(str(tmp_path / "data"), seed=golden["fixture_seed"])
    odd = {f"module.{k}": v for k, v in golden_sd.items()}
    odd["module.index"] = torch.tensor(INDEX_49, dtype=torch.long)
    odd_ckpt = str(tmp_path / "index49.pth.tar")
    torch.save({"state_dict": odd}, odd_ckpt)
    res = hrem_cli(["-model", "eemflow", "-int", "dt1", "--data_root", root, "--checkpoint", odd_ckpt,
                    "--save_dir", str(tmp_path / "out"), "--device", "cpu"])
    said = [line for line in capsys.readouterr().out.splitlines() if "correlation index" in line]
    assert len(said) == 1 and "49 entries" in said[0] and "(53)" in said[0]
    assert abs(res["mean"]["AEE"] - golden["aee"]) < 1e-6
