"""The K1 twin (event → voxel scatter) and the voxel helpers of the port
against the JAX package: the XLA scatter, the Pallas kernel in interpret
mode, normalization and the float64 host voxelizer.  Covers out-of-frame
events, padding, ΔT == 0 and p ∈ {0, 1}."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eemflow_tpu.events import voxel as jvox
from eemflow_tpu.ops.pallas.voxel_scatter import voxel_scatter_pallas

from eemflow_tpu_torch.events import voxel as tvox
from eemflow_tpu_torch.kernels.voxel_scatter import voxel_scatter

H, W, BINS = 24, 32, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=3, n_valid=(400, 700, 300), N=1024, dt_zero=(2,)):
    """Padded [B, N, 4] events: x and y one pixel past every edge, p in
    {0, 1}; samples in ``dt_zero`` have one shared timestamp."""
    rng = np.random.default_rng(seed)
    evs, ns = [], []
    for b, n in enumerate(n_valid):
        ev = np.empty((n, 4), np.float32)
        ev[:, 0] = 0.02 if b in dt_zero else np.sort(rng.uniform(0, 0.04, n))
        ev[:, 1] = rng.integers(-1, W + 1, n)
        ev[:, 2] = rng.integers(-1, H + 1, n)
        ev[:, 3] = rng.choice([0.0, 1.0], n)
        padded, k, _ = jvox.pad_events(ev, N)
        evs.append(padded)
        ns.append(k)
    return np.stack(evs), np.asarray(ns, np.int32)


def _jax_unnormalized(evs, ns):
    return np.asarray(jax.vmap(
        lambda e, n: jvox.events_to_voxel_grid(e, n, BINS, H, W, normalize=False)
    )(jnp.asarray(evs), jnp.asarray(ns)))


def test_twin_matches_jax_scatter_and_pallas_interpret():
    evs, ns = _batch()
    got = tvox.voxel_scatter_plain(torch.from_numpy(evs), torch.from_numpy(ns), BINS, H, W).numpy()
    want = _jax_unnormalized(evs, ns)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pallas = np.asarray(voxel_scatter_pallas(jnp.asarray(evs), jnp.asarray(ns), BINS, H, W, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    # the ΔT == 0 sample puts every in-frame event in bin 0
    assert np.abs(got[2, 1:]).max() == 0 and np.abs(got[2, 0]).max() > 0


def test_k1_wrapper_sends_cpu_tensors_to_the_twin():
    evs, ns = _batch(seed=4)
    e, n = torch.from_numpy(evs), torch.from_numpy(ns)
    np.testing.assert_array_equal(
        voxel_scatter(e, n, BINS, H, W).numpy(), tvox.voxel_scatter_plain(e, n, BINS, H, W).numpy()
    )


def test_votes_skip_padding_and_out_of_frame_events():
    evs, ns = _batch(seed=5, n_valid=(300,), dt_zero=())
    idx, val = tvox.voxel_votes(torch.from_numpy(evs), torch.from_numpy(ns), BINS, H, W)
    assert idx.min() >= 0 and idx.max() < BINS * H * W
    x, y = evs[0, :300, 1], evs[0, :300, 2]
    inb = int(((x >= 0) & (x < W) & (y >= 0) & (y < H)).sum())
    # each in-frame event casts a left vote, and a right vote unless it is
    # in the last bin
    assert inb <= idx.numel() <= 2 * inb


def test_normalize_matches_jax():
    evs, ns = _batch(seed=6)
    grids = np.array(_jax_unnormalized(evs, ns))
    grids[1] = 0.0  # an empty grid stays zero
    got = tvox.normalize_voxel_grid(torch.from_numpy(grids)).numpy()
    want = np.stack([np.asarray(jvox.normalize_voxel_grid(jnp.asarray(g))) for g in grids])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_events_to_voxel_grid_matches_jax(normalize):
    evs, ns = _batch(seed=7)
    for e, n in zip(evs, ns):
        got = tvox.events_to_voxel_grid(torch.from_numpy(e), int(n), BINS, H, W, normalize).numpy()
        want = np.asarray(jvox.events_to_voxel_grid(jnp.asarray(e), n, BINS, H, W, normalize))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_voxelize_batch_nhwc_matches_jax():
    evs, ns = _batch(seed=8)
    got = tvox.voxelize_batch_nhwc(torch.from_numpy(evs), torch.from_numpy(ns), BINS, H, W)
    want = np.asarray(jvox.voxelize_batch_nhwc(jnp.asarray(evs), jnp.asarray(ns), BINS, H, W))
    assert tuple(got.shape) == (3, H, W, BINS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_host_numpy_voxelizer_matches_jax(normalize):
    rng = np.random.default_rng(9)
    n = 500
    ev = np.stack([
        np.sort(rng.uniform(0, 5e4, n)), rng.integers(-1, W + 1, n),
        rng.integers(-1, H + 1, n), rng.choice([-1.0, 0.0, 1.0], n),
    ], axis=1)
    got = tvox.events_to_voxel_grid_np(ev, BINS, H, W, normalize)
    want = jvox.events_to_voxel_grid_np(ev, BINS, H, W, normalize)
    np.testing.assert_array_equal(got, want)


def test_padding_and_bucket_helpers_match_jax():
    rng = np.random.default_rng(10)
    ev = rng.standard_normal((300, 4))
    for bucket in (256, 512):
        got = tvox.pad_events(ev, bucket)
        want = jvox.pad_events(ev, bucket)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    buf = np.full((512, 4), 7.0, np.float32)
    out, n, dropped = tvox.pad_events(ev, 512, out=buf)
    assert out is buf and (n, dropped) == (300, 0) and not buf[300:].any()
    ladder = tvox.make_ladder(1 << 18, 4)
    assert ladder == jvox.make_ladder(1 << 18, 4)
    for n in (1, 1 << 15, (1 << 15) + 1, 1 << 18, (1 << 18) + 5):
        assert tvox.choose_bucket(n, ladder) == jvox.choose_bucket(n, ladder)


def test_buffer_pool_rotates_per_bucket():
    pool = tvox.BufferPool(ring=2)
    a, b, c = pool.get(128), pool.get(128), pool.get(128)
    assert a is not b and a is c and a.shape == (128, 4) and a.dtype == np.float32
    assert pool.get(256).shape == (256, 4)
