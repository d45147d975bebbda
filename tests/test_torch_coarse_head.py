"""The port's coarse head (K4's public function; on CPU tensors its plain
twin) and its pack helpers against the JAX package's ``coarse_head``.

Groups 5 reads the golden checkpoint, carried to JAX by the JAX package's
own converter; groups 1, which no checkpoint has, makes the coarse-stage
arrays from a seeded numpy RNG in the JAX layout and carries them to the
port with ``compat.from_jax``.  The JAX head is jitted (``impl="xla"``;
one case runs its Pallas kernel in interpret mode).  Tolerance 1e-5
absolute on a flow of ~0.1–1 (summation order only); the pack helpers
must agree exactly."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eemflow_tpu.compat import torch_state_dict_to_flax
from eemflow_tpu.compat.torch_loader import eemflow_alias
from eemflow_tpu.ops.pallas import coarse_head as jch

from eemflow_tpu_torch.compat.from_jax import eemflow_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
from eemflow_tpu_torch.kernels.coarse_head import pack_kernel_weights
from eemflow_tpu_torch.models.eemflow import INDEX_53
from eemflow_tpu_torch.ops import coarse_head as tch

GOLDEN_CKPT = os.path.join(os.path.dirname(__file__), "fixtures", "eemflow_hrem_golden.pth.tar")
TOL = 1e-5
CHANNELS = (16, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_jax_params(seed=7, groups=1):
    """The coarse-stage params of an EEMFlow in the JAX layout (HWIO)."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout, relu_wrap=True):
        k = (rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        leaf = {"kernel": k, "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}
        return {"0": leaf} if relu_wrap else leaf

    p = {}
    for lvl, c in zip((1, 2, 3), CHANNELS):
        p[f"rconv_{lvl}"] = conv(c, 16)
        dec = {"conv1": conv(69, 100)}
        for i in (2, 3, 4):
            dec[f"conv{i}"] = conv(100 // groups, 100)
        dec.update(conv5=conv(100, 64), conv6=conv(64, 32), conv7=conv(32, 2, relu_wrap=False))
        p[f"decoder_{lvl}"] = dec
    p["out_conv"] = {
        "kernel": rng.standard_normal((1, 1, 6, 2)).astype(np.float32),
        "bias": rng.standard_normal(2).astype(np.float32),
    }
    return p


@pytest.fixture(scope="module")
def golden_params():
    arrays = load_torch_checkpoint(GOLDEN_CKPT)
    jax_params = torch_state_dict_to_flax(
        {k: v for k, v in arrays.items() if k != "index"}, alias=eemflow_alias
    )["params"]
    return jax_params, to_state_dict(arrays)


@pytest.fixture(scope="module")
def params_by_groups(golden_params):
    jp1 = _random_jax_params()
    return {5: golden_params, 1: (jp1, eemflow_state_dict_from_jax(jp1))}


def _features(hw, seed):
    rng = np.random.default_rng(seed)
    return [
        [rng.standard_normal((2,) + hw + (c,)).astype(np.float32) for c in CHANNELS]
        for _ in range(2)
    ]


def _jax_head(f1, f2, params, groups, impl):
    run = lambda a, b, p: jch.coarse_head(a, b, p, groups=groups, indices=INDEX_53, impl=impl)
    if impl == "xla":
        run = jax.jit(run)
    return np.asarray(run([jnp.asarray(a) for a in f1], [jnp.asarray(a) for a in f2], params))


@pytest.mark.parametrize("groups", [5, 1])
@pytest.mark.parametrize("hw", [(2, 3), (3, 5)], ids=["2x3", "3x5"])
def test_coarse_head_plain_matches_jax(params_by_groups, hw, groups):
    jax_params, sd = params_by_groups[groups]
    f1, f2 = _features(hw, seed=hw[1] + groups)
    want = _jax_head(f1, f2, jax_params, groups, "xla")
    got = tch.coarse_head(
        [torch.from_numpy(a) for a in f1], [torch.from_numpy(a) for a in f2], sd,
        groups=groups, indices=INDEX_53,
    )
    assert tuple(got.shape) == (2,) + hw + (2,)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_coarse_head_matches_jax_pallas_interpret(golden_params):
    jax_params, sd = golden_params
    f1, f2 = _features((2, 3), seed=11)
    want = _jax_head(f1, f2, jax_params, 5, "pallas")
    weights = tch.HeadWeights(sd, 5)
    for impl in ("kernel", "plain"):  # CPU tensors: the twin either way
        got = tch.coarse_head(
            [torch.from_numpy(a) for a in f1], [torch.from_numpy(a) for a in f2], weights,
            groups=5, indices=INDEX_53, impl=impl,
        )
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("groups", [5, 1])
def test_pack_helpers_match_jax(params_by_groups, groups):
    jax_params, sd = params_by_groups[groups]
    want_levels, want_wout, want_bout = jch.pack_coarse_head_weights(jax_params, groups)
    levels, wout, bout = tch.pack_coarse_head_weights(sd, groups)
    for want, got in zip(want_levels, levels):
        assert set(got) == set(tch.LEVEL_KEYS) == set(want)
        for k in tch.LEVEL_KEYS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(wout.numpy(), np.asarray(want_wout))
    np.testing.assert_array_equal(bout.numpy(), np.asarray(want_bout))

    ks, bs, relus = tch.decoder_dense_kernels(sd, "decoder_2", groups)
    wks, wbs, wrelus = jch.decoder_dense_kernels(jax_params["decoder_2"], groups)
    assert relus == wrelus
    for a, b in zip(ks + bs, list(wks) + list(wbs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_grouped_and_shuffle_helpers_match_jax(golden_params):
    jax_params, sd = golden_params
    k = tch._hwio(sd, "decoder_1.conv3.0")[0]
    np.testing.assert_array_equal(k.numpy(), np.asarray(jax_params["decoder_1"]["conv3"]["0"]["kernel"]))
    dense = tch._dense_from_grouped(k, 5, 100)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jch._dense_from_grouped(jnp.asarray(k.numpy()), 5, 100)))
    np.testing.assert_array_equal(
        tch._fold_shuffle(dense, 5).numpy(), np.asarray(jch._fold_shuffle(jnp.asarray(dense.numpy()), 5))
    )


def test_kernel_weight_layout(golden_params):
    """K4's own packing: per conv [Cout/COT][Cin/groups][9][COT], element
    (u, ci, ky*3+kx, c) = OIHW w[u*COT + c, ci, ky, kx]; grouped convs stay
    grouped; COT = 4 where the group width allows, 2 for conv7's two
    channels, nothing padded."""
    _, sd = golden_params
    packed = pack_kernel_weights(sd, 5, "cpu")
    assert packed["meta"] == [
        (16, 1, 4), (100, 1, 4), (100, 5, 4), (100, 5, 4), (100, 5, 4),
        (64, 1, 4), (32, 1, 4), (2, 1, 2),
    ]
    w3, _ = packed["levels"][1][3]
    ref = sd["decoder_2.conv3.0.weight"]
    assert tuple(w3.shape) == (25, 20, 9, 4)
    assert w3[10, 7, 5, 2] == ref[42, 7, 1, 2]
    w7, b7 = packed["levels"][2][7]
    assert tuple(w7.shape) == (1, 32, 9, 2) and tuple(b7.shape) == (2,)
    assert torch.equal(w7[0, :, :, 1], sd["decoder_3.conv7.weight"][1].reshape(32, 9))
    np.testing.assert_array_equal(packed["wout"].numpy(), sd["out_conv.weight"].reshape(2, 6).numpy())


def test_head_weights_pack_once_and_check():
    jp = _random_jax_params(seed=3)
    sd = eemflow_state_dict_from_jax(jp)
    hw = tch.HeadWeights(sd, 1)
    assert hw.plain("cpu") is hw.plain("cpu")
    assert not any(k.startswith("pconv") for k in hw.params)
    f1, f2 = ([torch.zeros(1, 2, 3, c) for c in CHANNELS] for _ in range(2))
    with pytest.raises(ValueError, match="groups"):
        tch.coarse_head(f1, f2, hw, groups=5, indices=INDEX_53)
    with pytest.raises(ValueError, match="impl"):
        tch.coarse_head(f1, f2, hw, groups=1, indices=INDEX_53, impl="pallas")
