"""EEMFlow+ in the port against the JAX package on the CPU: the warp ops
and ``upsample2d_flow_as``; the whole model (sgu and cfp, with and without
``siamese_stack``) on the same params carried across by
``compat.from_jax`` at 64×128; the fused modes (``fast_pyramid``,
``fast_decoders``, ``fast_sgu``: kernel K3's plain version on CPU tensors)
against JAX's fused forward (its Pallas chains in interpret mode); the
golden checkpoint's strict load; and the port's ``test_hrem -model
eemflow_plus`` reproducing the committed golden AEE 0.8139283 within 0.01
on one 720×1280 sample, on the standard path and with the three fused
modes.

Tolerances: the warp ops 1e-5 absolute on O(1) features (the same gather
in the same order; only the coordinate arithmetic may round differently
where XLA fuses it); the model 1e-5 · max(1, largest |JAX flow|) on each
of the five predictions: float32 in other summation orders, carried
through five levels of warp feedback (each level's flow moves the next
level's samples) and rescaled by up to 32× (measured ~1.5e-6 of the
largest flow here); the bf16 fused modes against JAX's standard forward
by the JAX package's serving budget, mean drift under 3% of the mean
flow magnitude (``tests/test_pallas_kernels.py``)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eemflow_tpu.compat import torch_state_dict_to_flax
from eemflow_tpu.compat.torch_loader import eemflow_plus_alias, filter_state_dict
from eemflow_tpu.models.eemflow_plus import EEMFLOW_PLUS_DROP as JAX_DROP
from eemflow_tpu.models.eemflow_plus import EEMFlowPlus as JaxEEMFlowPlus
from eemflow_tpu.ops import upsample as jax_upsample
from eemflow_tpu.ops import warp as jax_warp

from eemflow_tpu_torch.compat.from_jax import eemflow_plus_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint, load_torch_checkpoint
from eemflow_tpu_torch.models.eemflow_plus import EEMFLOW_PLUS_DROP
from eemflow_tpu_torch.models.registry import FAST_EVAL_KWARGS, fast_eval_kwargs, get_eval_model
from eemflow_tpu_torch.ops import warp
from eemflow_tpu_torch.ops.upsample import upsample2d_flow_as

HERE = os.path.dirname(os.path.abspath(__file__))
PLUS_CKPT = os.path.join(HERE, "fixtures", "eemflow_plus_hrem_golden.pth.tar")
PLUS_GOLDEN = os.path.join(HERE, "fixtures", "hrem_golden_plus.json")
H, W, BINS = 64, 128, 5
OP_TOL = 1e-5
REL_TOL = 1e-5
FUSED = dict(fast_pyramid=True, fast_decoders=True, fast_sgu=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _low_opt(fn, *args):
    """``fn`` jitted and compiled at LLVM optimization level 0 (the compile
    is the fixture's cost; results move in float32's last digits)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((1, H, W, BINS)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_params(inputs):
    """He-scaled random params of the cfp variant (a superset of the sgu
    variant's), shaped by ``jax.eval_shape`` and filled from numpy."""
    ev = jnp.asarray(inputs[0])
    shapes = jax.eval_shape(JaxEEMFlowPlus(cdc_variant="cfp").init, jax.random.PRNGKey(0), ev, ev)
    rng = np.random.default_rng(1)

    def fill(s):
        fan = {4: int(np.prod(s.shape[:3])), 2: s.shape[0]}.get(len(s.shape))
        scale = 0.1 if fan is None else np.sqrt(2.0 / fan)
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _variant(params, variant):
    if variant == "cfp":
        return params
    p = dict(params["params"])
    p["cdc_model"] = {"dense_estimator_mask": p["cdc_model"]["dense_estimator_mask"]}
    return {"params": p}


def _jax_flows(params, inputs, **kw):
    m = JaxEEMFlowPlus(**kw)
    ev1, ev2 = (jnp.asarray(e) for e in inputs)
    fn = _low_opt(lambda v, a, b: m.apply(v, a, b)[1], params, ev1, ev2)
    return [np.asarray(f) for f in fn(params, ev1, ev2)]


@pytest.fixture(scope="module")
def jax_flows(jax_params, inputs):
    return {v: _jax_flows(_variant(jax_params, v), inputs, cdc_variant=v) for v in ("sgu", "cfp")}


@pytest.fixture(scope="module")
def jax_fused_flows(jax_params, inputs):
    """JAX's forward with the three fused modes: its Pallas chains run in
    interpret mode on the CPU backend."""
    return _jax_flows(_variant(jax_params, "sgu"), inputs, **FUSED)


def _port_flows(params, inputs, **kw):
    model = get_eval_model("eemflow_plus", **kw)
    model.load_state_dict(eemflow_plus_state_dict_from_jax(params))
    with torch.inference_mode():
        _, flows = model(*(torch.from_numpy(e) for e in inputs))
    return [f.numpy() for f in flows]


def _assert_flows_close(got, want):
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, H, W, 2)
        tol = REL_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"prediction {i}")


def _features_and_flow(seed, b=2, h=12, w=16, c=8, scale=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * scale).astype(np.float32)
    # integer and edge-exact samples, where the masks decide
    flow[0, 0, :4] = [[0.0, 0.0], [-1.0, 0.0], [1.0, 1.0], [w - 1.0, 0.0]]
    return x, flow


@pytest.mark.parametrize("op", ["backwarp", "backwarp_masked", "warp_align_corners"])
def test_warp_ops_match_jax(op):
    x, flow = _features_and_flow(5)
    want = np.asarray(getattr(jax_warp, op)(jnp.asarray(x), jnp.asarray(flow)))
    # the port's model hands NHWC views of NCHW tensors in
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).permute(0, 2, 3, 1)
    got = getattr(warp, op)(xt, torch.from_numpy(flow)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


def test_warp_of_bf16_features_keeps_float32_coordinates():
    """bf16 features are sampled at float32 coordinates (a bf16 coordinate
    cannot address a 1280-pixel row): the result is the float32 warp of the
    same bf16 values, rounded once per product and sum."""
    x, flow = _features_and_flow(7, w=640)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    got = warp.warp_align_corners(x16, torch.from_numpy(flow))
    want = warp.warp_align_corners(x16.float(), torch.from_numpy(flow))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0, atol=3e-2)


@pytest.mark.parametrize("if_rate", [False, True], ids=["plain", "rate"])
def test_upsample2d_flow_as_matches_jax(if_rate):
    flow = np.random.default_rng(6).standard_normal((2, 6, 10, 2)).astype(np.float32)
    want = np.asarray(jax_upsample.upsample2d_flow_as(jnp.asarray(flow), (12, 20), if_rate=if_rate))
    got = upsample2d_flow_as(torch.from_numpy(flow), (12, 20), if_rate=if_rate).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


@pytest.mark.parametrize("siamese", [False, True], ids=["two_pass", "siamese_stack"])
@pytest.mark.parametrize("variant", ["sgu", "cfp"])
def test_forward_matches_jax(jax_params, jax_flows, inputs, variant, siamese):
    got = _port_flows(_variant(jax_params, variant), inputs, cdc_variant=variant, siamese_stack=siamese)
    _assert_flows_close(got, jax_flows[variant])


@pytest.mark.parametrize(
    "mode", ["fast_pyramid", "fast_decoders", "fast_sgu", "all"],
)
def test_fused_modes_match_jax_fused(jax_params, jax_fused_flows, inputs, mode):
    """Each fused mode of the port (on CPU tensors, K3's plain version)
    against JAX's forward with all three fused, itself the standard
    function in another summation order."""
    kw = FUSED if mode == "all" else {mode: True}
    got = _port_flows(_variant(jax_params, "sgu"), inputs, **kw)
    _assert_flows_close(got, jax_fused_flows)


def test_train_mode_takes_the_standard_modules(jax_params, inputs):
    """The fused modes are eval-only: with ``train=True`` the model runs its
    standard modules, bit for bit the standard model's forward."""
    sd = eemflow_plus_state_dict_from_jax(_variant(jax_params, "sgu"))
    fused, std = get_eval_model("eemflow_plus", **FUSED), get_eval_model("eemflow_plus")
    fused.load_state_dict(sd)
    std.load_state_dict(sd)
    ev = [torch.from_numpy(e) for e in inputs]
    with torch.no_grad():
        for a, b in zip(fused(*ev, train=True)[1], std(*ev, train=True)[1]):
            assert torch.equal(a, b)


def test_fused_bf16_within_jax_serving_budget(jax_params, jax_flows, inputs):
    got = _port_flows(_variant(jax_params, "sgu"), inputs, fast_dtype="bf16", **FUSED)[-1]
    want = jax_flows["sgu"][-1]
    drift = np.abs(got - want).mean() / np.abs(want).mean()
    assert np.isfinite(got).all() and 0 < drift < 0.03, drift


def test_golden_checkpoint_loads_strictly():
    """The released checkpoint's keys less ``EEMFLOW_PLUS_DROP`` are the
    port's state dict, name for name; its forward equals the JAX forward
    on the JAX package's conversion of the same file."""
    assert EEMFLOW_PLUS_DROP == JAX_DROP
    arrays = load_torch_checkpoint(PLUS_CKPT)
    model = get_eval_model("eemflow_plus")
    kept = {k for k in arrays if not k.startswith(EEMFLOW_PLUS_DROP)}
    assert kept == set(model.state_dict()) and len(kept) < len(arrays)
    load_model_checkpoint(model, PLUS_CKPT, "eemflow_plus")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), arrays[k], err_msg=k)
    sd = filter_state_dict({k: v for k, v in arrays.items() if k != "index"}, JAX_DROP)
    params = torch_state_dict_to_flax(sd, alias=eemflow_plus_alias)
    rng = np.random.default_rng(4)
    ev = [rng.standard_normal((1, H, W, BINS)).astype(np.float32) for _ in range(2)]
    evj = [jnp.asarray(e) for e in ev]
    want = np.asarray(_low_opt(lambda v, a, b: JaxEEMFlowPlus().apply(v, a, b)[1][-1], params, *evj)(params, *evj))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(e) for e in ev))[1][-1].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def golden_root(tmp_path_factory):
    import json

    from test_golden_acceptance import make_hrem_fixture

    with open(PLUS_GOLDEN) as f:
        golden = json.load(f)
    return make_hrem_fixture(str(tmp_path_factory.mktemp("hrem_plus")), seed=golden["fixture_seed"]), golden


@pytest.mark.parametrize("extra", [(), ("--fast_pyramid", "--fast_decoders", "--fast_sgu")],
                         ids=["standard", "fused"])
def test_cli_reproduces_golden_aee(golden_root, tmp_path, extra):
    from eemflow_tpu_torch.tools.test_hrem import main

    root, golden = golden_root
    res = main(["-model", "eemflow_plus", "-int", "dt1", "--data_root", root, "--checkpoint", PLUS_CKPT,
                "--save_dir", str(tmp_path), "--max_samples", str(golden["max_samples"]), "--device", "cpu",
                *extra])
    assert res["indoor_fast"]["n_samples"] == 1
    assert abs(res["mean"]["AEE"] - golden["aee"]) < 0.01


def test_registry_and_training_refusal(tmp_path):
    """EEMFlow+ is registered with no ``--fast`` mapping (as in JAX), takes
    its fused flags, and its training against the 16x16 meshflow label is
    refused before a step: it predicts at full resolution, so it trains
    with ``--full_res_flow``."""
    from eemflow_tpu_torch.tools.train_hrem import main as train_main

    assert "eemflow_plus" not in FAST_EVAL_KWARGS and fast_eval_kwargs("eemflow_plus") == {}
    model = get_eval_model("eemflow_plus", **FUSED)
    assert not model.training and model.cdc_model.fast
    with pytest.raises(ValueError, match="does not support"):
        get_eval_model("eemflow_plus", fast_head=True)
    with pytest.raises(ValueError):
        get_eval_model("eemflow_plus", cdc_variant="cfp", fast_sgu=True)
    with pytest.raises(SystemExit, match="--full_res_flow"):
        train_main(["-model", "eemflow_plus", "--data_root", str(tmp_path), "--device", "cpu"])


def test_loader_takes_the_ports_training_checkpoint(tmp_path):
    """``load_model_checkpoint`` takes an ``epoch_N.pt`` of the port's
    trainer (parameters under ``params``) as it takes a release."""
    src = get_eval_model("eemflow_plus")
    path = os.path.join(str(tmp_path), "epoch_3.pt")
    torch.save({"step": 3, "params": src.state_dict(), "optimizer": {}}, path)
    dst = get_eval_model("eemflow_plus")
    with torch.no_grad():
        for p in dst.parameters():
            p.zero_()
    load_model_checkpoint(dst, path, "eemflow_plus")
    for k, v in src.state_dict().items():
        assert torch.equal(v, dst.state_dict()[k]), k
    with pytest.raises(ValueError, match="checkpoint must be"):
        load_model_checkpoint(dst, os.path.join(str(tmp_path), "ckpt.npz"), "eemflow_plus")


@pytest.mark.parametrize("tool", ["time_eval", "profile_model"])
def test_timing_tools_take_eemflow_plus(tmp_path, tool):
    import importlib

    main = importlib.import_module(f"eemflow_tpu_torch.tools.{tool}").main
    extra = ["--logdir", str(tmp_path)] if tool == "profile_model" else []
    res = main(["-model", "eemflow_plus", "--device", "cpu", "--size", "64", "128", "-bs", "1", "--reps", "1",
                "--fast_pyramid", "--fast_decoders", "--fast_sgu", *extra])
    assert res["modes"] == FUSED and res.get("ms_per_img", res.get("ms_per_call")) > 0


def test_fused_chains_take_the_kernel_eemflow_plus_needs():
    """On the card, the decoders' chain [87, 96, 96, 96, 96, 64, 32, 2]
    (convs 2-4 grouped by 3 and shuffled) and the SGU's concat chain [64,
    96, 128, 160, 176, 184, 3] go to K3's tensor-core kernel, cut into
    several launches (neither fits one), the pyramid's chains in one each;
    each launch's plan fits the shared memory."""
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.ops.fused_convs import chain_channels

    model = get_eval_model("eemflow_plus", **FUSED)
    ws, _ = model.cdc_model.dense_estimator_mask.chain()
    concat = (True,) * 5 + (False,)
    sgu = chain_channels(64, ws, concat)
    assert sgu == [64, 96, 128, 160, 176, 184, 3]
    g = (1, 3, 3, 3, 1, 1, 1)
    dec = model.decoder2
    dws = [dec.conv1[0].weight, dec.conv2[0].weight, dec.conv3[0].weight, dec.conv4[0].weight,
           dec.conv5[0].weight, dec.conv6[0].weight, dec.conv7.weight]
    assert chain_channels(87, dws, (False,) * 7, g) == [87, 96, 96, 96, 96, 64, 32, 2]
    specs = [(k3.chain_spec(64, [w.shape[0] for w in ws], concat), None, False),
             (k3.chain_spec(87, [w.shape[0] for w in dws], None, g, g), None, False),
             (k3.chain_spec(16, (16,)), None, True), (k3.chain_spec(32, (32, 32)), None, True),
             (k3.chain_spec(64, (64, 64)), 2, True)]
    for spec, pool, one in specs:
        for bf16 in (False, True):
            plans = k3.plan_chain(spec, pool, bf16)
            assert (len(plans) == 1) == one and all(p["smem_bytes"] <= k3.MAX_SMEM for *_, p in plans)