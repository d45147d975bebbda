"""The port's FlowFormer (``models/flowformer.py``) against the JAX package's
on the CPU: the parts alone (the cost-map patch embedding on maps that are
not a multiple of 8, the encoder's and the decoder's cross-attention, the
latent self-attention, both twins attentions and the vertical layer on a
9×13 grid, which is a multiple of neither the 7×7 window nor the 4×
subsampling), the whole model at 64×96 with ``encoder_depth`` 1–3 and
``decoder_depth`` 3 (every iteration's flow, the GMA gate ``gamma`` drawn
nonzero), the golden checkpoint loading strictly after ``FLOWFORMER_DROP``;
``test_hrem`` with the golden at a reduced sensor and decoder depth (its
720×1280 AEE is checked on the card by ``chip_smoke.py``), ``test_mvsec``,
``time_eval`` and ``profile_model``.

Limits.  A part alone: 1e-5 of max(1, largest |output|).  The model:
1e-4·max(1, largest |flow|) over every iteration, with the weights of
``test_torch_gmflow.seeded_transformer_variables`` except the
``channel_convertor``, drawn at a tenth of its standard deviation.  The
cost volume has no 1/√C: at the full deviation its values reach ±200, the
9×9 patch is sampled bilinearly at ``coords1`` from that steep surface,
and each iteration carries the float32 rounding of the coordinates on
~15-fold, on either side (at flax's own init JAX's float32 lies 1.4e-4,
1.4e-3 and 1.9e-2 px from its float64 run after iterations 1–3 on flows of
~37 px).  At a tenth the port lies at most 1.3e-5 of max(1, |flow|) from
JAX after 3 iterations (flows of 33–36 px); at the full deviation
the model is held in float64 against JAX in float64 (``jax.enable_x64``)
within 1e-4·max(1, |flow|), the port's coordinates staying float32."""

import csv
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eemflow_tpu.models.flowformer as jff
from eemflow_tpu.models.eraft import coords_grid as jax_coords_grid
from test_torch_gma import events
from test_torch_gmflow import close, run_hrem_small, seeded_transformer_variables

from eemflow_tpu_torch.compat.from_jax import flowformer_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import drop_prefixes, flowformer_alias, load_model_checkpoint
from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint
from eemflow_tpu_torch.models import flowformer as pff
from eemflow_tpu_torch.models.registry import fast_eval_kwargs, get_eval_model

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
GOLDEN_CKPT = os.path.join(FIXTURES, "flowformer_hrem_golden.pth.tar")
FLOW_TOL = 1e-4
MODULE_TOL = 1e-5
CONVERTOR_SCALE = 0.1
LOW_OPT = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def filled(jax_module, rng, *args, arrange=lambda *a: a):
    """A JAX module's params from ``eval_shape``, filled from ``rng``:
    kernels with variance 1/fan_in, biases and LayerNorm offsets N(0, 0.1²),
    scales uniform in [0.8, 1.2].  ``arrange`` makes the module's arguments
    from the arrays (inserting the static ones)."""
    shapes = jax.eval_shape(lambda k, *a: jax_module.init(k, *arrange(*a)), jax.random.PRNGKey(0), *args)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def check_part(jax_module, port_module, args, port_args, arrange=lambda *a: a):
    variables = filled(jax_module, np.random.default_rng(81), *args, arrange=arrange)
    want = jax_module.apply(variables, *arrange(*args))
    if isinstance(want, tuple):
        want = want[0]
    port_module.load_state_dict(flowformer_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port_module(*port_args)
    if isinstance(got, tuple):
        got = got[0]
    close(got, want, MODULE_TOL)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ parts


def test_patch_embed_matches_jax():
    """13×19 cost maps, zero-padded to 16×24 before the three 6×6/2 convs;
    the patch centres' embedding fused by the 1×1 FFN."""
    maps = np.random.default_rng(82).standard_normal((6, 13, 19, 1)).astype(np.float32) * 3
    check_part(jff.PatchEmbed(64), pff.PatchEmbed(64), (jnp.asarray(maps),), (_t(maps),))


@pytest.mark.parametrize("layer", ["encoder_cross", "decoder_cross", "self"])
def test_attention_layers_match_jax(layer):
    """The latent tokens' cross-attention to 30 cost tokens, the decoder's
    (the flow position's embedding on q, ``proj`` over [attention,
    shortcut]) and the self-attention across the 8 latent tokens; 8 heads,
    ``(dim/heads)^-0.5``."""
    rng = np.random.default_rng(83)
    if layer == "encoder_cross":
        q, tgt = rng.standard_normal((5, 8, 128)).astype(np.float32), rng.standard_normal((5, 30, 128)).astype(np.float32)
        check_part(jff.EncoderCrossAttention(128), pff.EncoderCrossAttention(128, 128),
                   (jnp.asarray(q), jnp.asarray(tgt)), (_t(q), _t(tgt)))
    elif layer == "decoder_cross":
        q, key, val, pos = (rng.standard_normal(s).astype(np.float32) for s in
                            ((7, 1, 64), (7, 8, 64), (7, 8, 64), (7, 1, 64)))
        jm = jff.DecoderCrossAttention(64)
        variables = filled(jm, rng, *(jnp.asarray(a) for a in (q, key, val, pos)))
        want = jm.apply(variables, *(jnp.asarray(a) for a in (q, key, val, pos)))
        port = pff.DecoderCrossAttention(64, 128)
        sd = flowformer_state_dict_from_jax(variables)
        sd.update({f"{kv}.{p}": getattr(port, kv).state_dict()[p] for kv in "kv" for p in ("weight", "bias")})
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = port(_t(q), _t(key), _t(val), _t(pos))
        close(got, want, MODULE_TOL)
    else:
        x = rng.standard_normal((6, 8, 128)).astype(np.float32)
        check_part(jff.SelfAttentionLayer(128), pff.SelfAttentionLayer(128), (jnp.asarray(x),), (_t(x),))


@pytest.mark.parametrize("part", ["local", "global", "vertical"])
def test_twins_attention_on_a_9x13_grid_matches_jax(part):
    """The 7×7-window attention (padded to 14×14, the padded tokens
    attended unmasked), the 4×-subsampled one (padded to 12×16, one
    LayerNorm for keys and values), and the vertical layer (both blocks
    with their pre-norms and MLPs): B=2, K=3 latent tokens, a 256-channel
    context."""
    rng = np.random.default_rng(84)
    H, W, B, K = 9, 13, 2, 3
    x = rng.standard_normal((B * K, H * W, 128)).astype(np.float32)
    ctx = rng.standard_normal((B, H, W, 256)).astype(np.float32)
    jax_cls, port = {
        "local": (jff.LocallyGroupedAttnRPEContext, pff.LocallyGroupedAttnRPEContext(128)),
        "global": (jff.GlobalSubSampleAttnRPEContext, pff.GlobalSubSampleAttnRPEContext(128)),
        "vertical": (jff.VerticalSelfAttentionLayer, pff.VerticalSelfAttentionLayer(128)),
    }[part]
    check_part(jax_cls(128), port, (jnp.asarray(x), jnp.asarray(ctx)), (_t(x), (H, W), _t(ctx).reshape(B, H * W, 256)),
               arrange=lambda x, ctx: (x, (H, W), ctx))


# ------------------------------------------------------------ whole model


@pytest.fixture(scope="module")
def depth3_variables():
    """The seeded variables of ``encoder_depth`` 3, the channel convertor
    at full deviation; a shallower model takes its first rounds."""
    return seeded_transformer_variables(jff.FlowFormer(encoder_depth=3, decoder_depth=3), (64, 96, 5), 73)


def model_variables(variables, encoder_depth, convertor_scale=CONVERTOR_SCALE):
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    enc = params["memory_encoder"]["cost_perceiver_encoder"]
    for i in range(encoder_depth, 3):
        del enc[f"encoder_layers_{i}"], enc[f"vertical_encoder_layers_{i}"]
    conv = params["memory_encoder"]["channel_convertor"]
    conv["kernel"] = conv["kernel"] * np.float32(convertor_scale)
    return {"params": params}


def jax_flows(jm, variables, ev1, ev2):
    f = jax.jit(jm.apply).lower(variables, ev1, ev2).compile(compiler_options=LOW_OPT)
    return np.asarray(f(variables, ev1, ev2)[1])


def port_flows(variables, ev1, ev2, dtype=torch.float32, **cfg):
    model = pff.FlowFormer(**cfg).eval()
    model.load_state_dict(flowformer_state_dict_from_jax(variables), strict=True)
    assert float(model.memory_decoder.update_block.aggregator.gamma.detach()) != 0
    model.to(dtype)
    with torch.no_grad():
        return model(torch.from_numpy(ev1).to(dtype), torch.from_numpy(ev2).to(dtype))[1].numpy()


@pytest.mark.parametrize("encoder_depth", [1, 2, 3])
def test_model_matches_jax(depth3_variables, encoder_depth):
    jm = jff.FlowFormer(encoder_depth=encoder_depth, decoder_depth=3)
    variables = model_variables(depth3_variables, encoder_depth)
    ev1, ev2 = events(80 + encoder_depth, 64, 96)
    want = jax_flows(jm, variables, ev1, ev2)
    got = port_flows(variables, ev1, ev2, encoder_depth=encoder_depth, decoder_depth=3)
    assert want.shape == (3, 1, 64, 96, 2) and 1.0 < np.abs(want).max()
    for i in range(3):
        close(got[i], want[i], FLOW_TOL)


def test_model_at_full_variance_matches_jax_in_float64(depth3_variables):
    """The ``channel_convertor`` at its full deviation (``encoder_depth``
    1, 32×64), both sides in float64, JAX's coordinate grid made float64
    too."""
    jm = jff.FlowFormer(encoder_depth=1, decoder_depth=3)
    variables = model_variables(depth3_variables, 1, convertor_scale=1.0)
    ev1, ev2 = events(83, 32, 64)
    grid64 = lambda *a: jax_coords_grid(*a).astype(jnp.float64)
    with jax.enable_x64(True), mock.patch.object(jff, "coords_grid", grid64):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        want = jax_flows(jm, v64, ev1.astype(np.float64), ev2.astype(np.float64))
    got = port_flows(variables, ev1.astype(np.float64), ev2.astype(np.float64), torch.float64, encoder_depth=1,
                     decoder_depth=3)
    assert 10.0 < np.abs(want).max()
    for i in range(3):
        close(got[i], want[i], FLOW_TOL)


# ------------------------------------------------- checkpoints and CLIs


def test_golden_loads_strictly_and_the_alias_inverts_the_converter():
    """The golden carries the decoder attention's two 319×128 relative
    position tables, which ``FLOWFORMER_DROP`` drops; the rest loads
    strictly, and each key, through the JAX spelling
    (``flowformer_alias``) and back through the converter, is itself."""
    assert drop_prefixes("flowformer") == ("memory_decoder.att.pos_emb.",)
    keys = load_torch_checkpoint(GOLDEN_CKPT)
    assert sum(k.startswith(drop_prefixes("flowformer")) for k in keys) == 2
    model = get_eval_model("flowformer")
    load_model_checkpoint(model, GOLDEN_CKPT, "flowformer")
    assert float(model.memory_decoder.update_block.aggregator.gamma.detach()) == 0.0
    keys = {k: v for k, v in keys.items() if not k.startswith(drop_prefixes("flowformer"))}
    tree = {}
    for k, v in keys.items():
        mod, _, leaf = k.rpartition(".")
        node = tree
        for p in flowformer_alias(mod) if mod else ():
            node = node.setdefault(p, {})
        if leaf == "weight":
            leaf, v = ("scale", v) if v.ndim == 1 else ("kernel", v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T)
        node[leaf] = v
    back = flowformer_state_dict_from_jax({"params": tree})
    assert set(back) == set(keys)
    for k, v in keys.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_hrem_cli_with_the_golden_at_a_reduced_sensor_and_depth(tmp_path, monkeypatch):
    """``test_hrem -model flowformer --config {"decoder_depth": 2}`` with
    the golden weights at a 96×160 sensor: host and device voxelize agree
    within 1e-5."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"decoder_depth": 2}))
    host, dev = run_hrem_small(tmp_path, monkeypatch, "flowformer", GOLDEN_CKPT, (96, 160),
                               extra=("--config", str(cfg)))
    assert abs(host - dev) < 1e-5


def test_mvsec_cli_takes_flowformer(tmp_path):
    """``test_mvsec -model flowformer`` (decoder depth 2) with the golden
    weights on a synthetic 260×346 sequence, cropped to 256: finite."""
    from test_torch_mvsec import make_mvsec_fixture

    from eemflow_tpu_torch.tools.test_mvsec import main as mvsec_cli

    root = make_mvsec_fixture(str(tmp_path / "data"), ("indoor_flying1",), h=260, w=346, n_events=3000, seed=66,
                              first=3, last=14)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"decoder_depth": 2}))
    res = mvsec_cli(["-model", "flowformer", "-int", "dt1", "--sequence", "indoor_flying1", "--data_root", root,
                     "--checkpoint", GOLDEN_CKPT, "--save_dir", str(tmp_path / "out"), "--frames", "3", "5",
                     "--stride", "1", "--max_samples", "1", "--device", "cpu", "--config", str(cfg), "--save_csv"])
    assert res["n_samples"] == 1 and np.isfinite(res["AEE"])
    with open(os.path.join(str(tmp_path / "out"), "flowformer_dt1_indoor_flying1", "test_epe_per_sample.csv")) as f:
        assert len(list(csv.DictReader(f))) == 1


def test_registry_and_tools(tmp_path):
    from eemflow_tpu_torch.tools.profile_model import main as profile_main
    from eemflow_tpu_torch.tools.time_eval import main as time_main

    model = get_eval_model("flowformer")
    assert isinstance(model, pff.FlowFormer) and not model.training and fast_eval_kwargs("flowformer") == {}
    enc = model.memory_encoder.cost_perceiver_encoder
    assert enc.latent_tokens.shape == (1, 8, 128) and len(enc.encoder_layers) == 3
    assert model.memory_decoder.decoder_depth == 12
    assert model.memory_decoder.update_block.encoder.convc1.in_channels == 145
    res = time_main(["-model", "flowformer", "--device", "cpu", "--size", "32", "32", "-bs", "1", "--reps", "1"])
    assert res["model"] == "flowformer" and res["ms_per_img"] > 0
    prof = profile_main(["-model", "flowformer", "--device", "cpu", "--size", "32", "32", "--reps", "1",
                         "--logdir", str(tmp_path)])
    assert prof["model"] == "flowformer" and prof["device_busy_share"] is None
