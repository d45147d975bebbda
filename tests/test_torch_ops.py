"""Port ops against the JAX package: padding, pooling, upsampling, channel
shuffle, and the K2 twin (local correlation) against both the XLA
correlation and the Pallas kernel in interpret mode.  Inputs are made
with numpy from a seed and handed to both packages as numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eemflow_tpu.models import layers as jlayers
from eemflow_tpu.models.eemflow import INDEX_53 as J_INDEX_53
from eemflow_tpu.ops import correlation as jcorr
from eemflow_tpu.ops import pad as jpad
from eemflow_tpu.ops import pooling as jpool
from eemflow_tpu.ops import upsample as jup

from eemflow_tpu_torch.kernels.local_corr import local_corr
from eemflow_tpu_torch.models.eemflow import INDEX_53
from eemflow_tpu_torch.models.layers import channel_shuffle
from eemflow_tpu_torch.ops.correlation import local_correlation, local_correlation_plain
from eemflow_tpu_torch.ops.pad import InputPadder
from eemflow_tpu_torch.ops.pooling import avg_pool2d
from eemflow_tpu_torch.ops.upsample import resize_bilinear, upsample_flow_to


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["chairs", "sintel"])
@pytest.mark.parametrize("hw,rate", [((45, 80), 64), ((72, 100), 32), ((64, 128), 64)])
def test_input_padder_matches_jax(mode, hw, rate):
    x = _rand((2,) + hw + (3,))
    ours = InputPadder(hw, mode=mode, eval_pad_rate=rate)
    ref = jpad.InputPadder(hw, mode=mode, eval_pad_rate=rate)
    assert ours.padded_shape == ref.padded_shape
    got = ours.pad(torch.from_numpy(x))[0]
    want = np.asarray(ref.pad(jnp.asarray(x))[0])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ours.unpad(got).numpy(), x)


def test_input_padder_720p_pads_bottom_rows_only():
    p = InputPadder((720, 1280), mode="chairs", eval_pad_rate=64)
    assert p.padded_shape == (768, 1280)
    assert p._pad == [0, 0, 0, 48]


@pytest.mark.parametrize("shape,k", [((2, 64, 96, 16), 32), ((1, 50, 70, 8), 8)])
def test_avg_pool2d_matches_jax(shape, k):
    x = _rand(shape, 1)
    got = avg_pool2d(torch.from_numpy(x), k).numpy()
    want = np.asarray(jpool.avg_pool2d(jnp.asarray(x), k))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("src,dst", [((3, 5), (45, 80)), ((12, 20), (72, 128)), ((9, 9), (4, 6))])
def test_resize_bilinear_matches_jax(align, src, dst):
    x = _rand((2,) + src + (2,), 2)
    got = resize_bilinear(torch.from_numpy(x), dst, align_corners=align).numpy()
    want = np.asarray(jup.resize_bilinear(jnp.asarray(x), dst, align_corners=align))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_upsample_flow_to_keeps_values_unscaled():
    x = _rand((1, 12, 20, 2), 3)
    got = upsample_flow_to(torch.from_numpy(x), (720, 1280)).numpy()
    want = np.asarray(jup.upsample_flow_to(jnp.asarray(x), (720, 1280)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got).max() <= np.abs(x).max() + 1e-6


@pytest.mark.parametrize("groups", [1, 5, 4])
def test_channel_shuffle_nchw_gives_jax_nhwc_permutation(groups):
    x = _rand((2, 3, 4, 20), 4)  # NHWC
    want = np.asarray(jlayers.channel_shuffle(jnp.asarray(x), groups))
    got = channel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), groups)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_index_tables_match_jax():
    assert tuple(INDEX_53) == tuple(J_INDEX_53)


@pytest.mark.parametrize("indices", [INDEX_53, None], ids=["index53", "full81"])
@pytest.mark.parametrize("shape", [(1, 12, 20, 16), (2, 9, 11, 32)])
def test_local_correlation_twin_matches_jax(indices, shape):
    x, y = _rand(shape, 5), _rand(shape, 6)
    want = np.asarray(jcorr.local_correlation(jnp.asarray(x), jnp.asarray(y), 4, indices))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = local_correlation_plain(tx, ty, 4, indices).numpy()
    assert got.shape == shape[:3] + (81 if indices is None else 53,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # a CPU tensor goes to the twin through the public op and the K2 wrapper
    np.testing.assert_array_equal(local_correlation(tx, ty, 4, indices).numpy(), got)
    np.testing.assert_array_equal(local_corr(tx, ty, 4, indices).numpy(), got)


@pytest.mark.parametrize("indices", [INDEX_53, None], ids=["index53", "full81"])
def test_local_correlation_twin_matches_pallas_interpret(monkeypatch, indices):
    from jax.experimental import pallas as pl

    import eemflow_tpu.ops.pallas.local_corr as lc

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(lc.pl, "pallas_call", interp_call)
    shape = (1, 12, 20, 16)
    x, y = _rand(shape, 7), _rand(shape, 8)
    want = np.asarray(lc.local_correlation_pallas(jnp.asarray(x), jnp.asarray(y), 4, indices))
    got = local_correlation_plain(torch.from_numpy(x), torch.from_numpy(y), 4, indices).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_local_correlation_rejects_out_of_window_indices():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        local_correlation(x, x, 4, (0, 81))
