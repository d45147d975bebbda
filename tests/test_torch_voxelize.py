"""K1's ``voxelize`` (events → normalized voxel grid) and K2's
``local_corr_levels`` (three correlation levels, one launch) on the CPU,
where each goes to its plain twin, against the JAX package: the normalized
``events_to_voxel_grid`` and ``voxelize_batch_nhwc``, and
``local_correlation`` per level.  Also the K1 edge cases (n_valid 0 and 1,
ΔT == 0, every event out of frame, every event on one pixel, a frame that is
not a whole number of 32×32 tiles, 15 bins), K2 on permuted NCHW views and
under grad, and the plans both wrappers hand their kernels.  Small shapes
only: no JAX model is built."""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eemflow_tpu.events import voxel as jvox
from eemflow_tpu.ops import correlation as jcorr

from eemflow_tpu_torch.events import voxel as tvox
from eemflow_tpu_torch.kernels import local_corr as k2
from eemflow_tpu_torch.kernels import voxel_scatter as k1
from eemflow_tpu_torch.models.eemflow import INDEX_53

H, W, BINS, N = 24, 32, 5, 512
# relative to max(1, |JAX|): float32 sums taken in another order
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(rng, n, h=H, w=W, t=None, pix=None, margin=2):
    """[n, 4] time-sorted events (t, x, y, p): x and y ``margin`` pixels past
    every edge unless ``pix`` fixes them, p in {0, 1}; ``t`` fixes every
    timestamp (ΔT == 0)."""
    ev = np.empty((n, 4), np.float32)
    ev[:, 0] = t if t is not None else np.sort(rng.uniform(0, 5e4, n))
    ev[:, 1] = rng.integers(-margin, w + margin, n) if pix is None else pix[0]
    ev[:, 2] = rng.integers(-margin, h + margin, n) if pix is None else pix[1]
    ev[:, 3] = rng.integers(0, 2, n)
    return ev


def _padded(evs, n_pad=N):
    out = np.zeros((len(evs), n_pad, 4), np.float32)
    ns = np.zeros(len(evs), np.int32)
    for b, ev in enumerate(evs):
        out[b, : len(ev)] = ev
        ns[b] = len(ev)
    return out, ns


def _jax_grid(ev, n, bins, h, w, normalize):
    return np.asarray(jvox.events_to_voxel_grid(jnp.asarray(ev), int(n), bins, h, w, normalize))


def _jax_grids(ev, ns, bins, h, w, normalize):
    """[B, bins, h, w] from one batched (jitted) JAX call: cases of one
    frame and bin count share its compilation."""
    return np.asarray(jvox.events_to_voxel_grid_batch(jnp.asarray(ev), jnp.asarray(ns), bins, h, w, normalize))


def _close(got, want):
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= TOL * max(1.0, float(np.abs(want).max()) if want.size else 1.0), err


# (name, per-sample event arrays from a seeded rng, bins, H, W)
EDGE_CASES = {
    "n_valid_0_and_1": lambda rng: ([_events(rng, 0), _events(rng, 1)], BINS, H, W),
    "dt_zero": lambda rng: ([_events(rng, 300, t=7.0), _events(rng, 200)], BINS, H, W),
    "out_of_frame": lambda rng: ([_events(rng, 100, pix=(W + 3, 4)), _events(rng, 100, pix=(5, -1))], BINS, H, W),
    "one_pixel": lambda rng: ([_events(rng, 400, pix=(7, 9)), _events(rng, 250, pix=(0, 0))], BINS, H, W),
    "ragged_frame": lambda rng: ([_events(rng, 450, 45, 77), _events(rng, 300, 45, 77)], BINS, 45, 77),
    "bins_15": lambda rng: ([_events(rng, 400), _events(rng, 350)], 15, H, W),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_voxelize_matches_jax_in_edge_cases(case):
    evs, bins, h, w = EDGE_CASES[case](np.random.default_rng(sorted(EDGE_CASES).index(case)))
    ev, ns = _padded(evs)
    got = k1.voxelize(torch.from_numpy(ev), torch.from_numpy(ns), bins, h, w).numpy()
    want = _jax_grids(ev, ns, bins, h, w, True)
    for b in range(len(ns)):
        _close(got[b], want[b])


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_voxel_scatter_matches_jax_in_edge_cases(case):
    evs, bins, h, w = EDGE_CASES[case](np.random.default_rng(10 + sorted(EDGE_CASES).index(case)))
    ev, ns = _padded(evs)
    got = k1.voxel_scatter(torch.from_numpy(ev), torch.from_numpy(ns), bins, h, w).numpy()
    want = _jax_grids(ev, ns, bins, h, w, False)
    for b in range(len(ns)):
        _close(got[b], want[b])


def test_edge_cases_do_what_they_name():
    rng = np.random.default_rng(0)
    ev, ns = _padded(EDGE_CASES["out_of_frame"](rng)[0])
    assert not k1.voxelize(torch.from_numpy(ev), torch.from_numpy(ns), BINS, H, W).any()
    ev, ns = _padded(EDGE_CASES["one_pixel"](rng)[0])
    grid = k1.voxel_scatter(torch.from_numpy(ev), torch.from_numpy(ns), BINS, H, W)
    assert {tuple(p) for p in torch.nonzero(grid)[:, 2:].tolist()} == {(9, 7), (0, 0)}  # (y, x)
    ev, ns = _padded(EDGE_CASES["dt_zero"](rng)[0])
    grid = k1.voxel_scatter(torch.from_numpy(ev), torch.from_numpy(ns), BINS, H, W)
    assert not grid[0, 1:].any() and grid[0, 0].any()  # ΔT == 0: every vote in bin 0


@pytest.mark.parametrize("seed", [0, 1])
def test_voxelize_matches_jax_events_to_voxel_grid(seed):
    rng = np.random.default_rng(100 + seed)
    ev, ns = _padded([_events(rng, 500), _events(rng, 333)])
    got = k1.voxelize(torch.from_numpy(ev), torch.from_numpy(ns), BINS, H, W).numpy()
    want = _jax_grids(ev, ns, BINS, H, W, True)
    for b in range(2):
        _close(got[b], want[b])


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
def test_events_to_voxel_grid_matches_jax(normalize):
    rng = np.random.default_rng(7)
    ev, ns = _padded([_events(rng, 480)])
    got = tvox.events_to_voxel_grid(torch.from_numpy(ev[0]), int(ns[0]), BINS, H, W, normalize).numpy()
    _close(got, _jax_grid(ev[0], ns[0], BINS, H, W, normalize))


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
def test_voxelize_batch_nhwc_matches_jax(normalize):
    rng = np.random.default_rng(8)
    ev, ns = _padded([_events(rng, 420), _events(rng, 1), _events(rng, 260, t=3.0)])
    got = tvox.voxelize_batch_nhwc(torch.from_numpy(ev), torch.from_numpy(ns), BINS, H, W, normalize)
    want = np.asarray(jvox.voxelize_batch_nhwc(jnp.asarray(ev), jnp.asarray(ns), BINS, H, W, normalize))
    assert tuple(got.shape) == (3, H, W, BINS)
    _close(got.numpy(), want)


def test_voxelize_plain_is_normalize_of_the_scatter():
    rng = np.random.default_rng(9)
    ev, ns = _padded([_events(rng, 300), _events(rng, 40)])
    e, n = torch.from_numpy(ev), torch.from_numpy(ns)
    np.testing.assert_array_equal(
        tvox.voxelize_plain(e, n, BINS, H, W).numpy(),
        tvox.normalize_voxel_grid(tvox.voxel_scatter_plain(e, n, BINS, H, W)).numpy(),
    )


def test_voxel_wrappers_refuse_other_devices():
    ev = torch.empty(1, 128, 4, device="meta")
    n = torch.empty(1, dtype=torch.int32, device="meta")
    for fn in (k1.voxelize, k1.voxel_scatter):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(ev, n, BINS, H, W)


def test_voxel_modes_and_limits():
    assert k1.MODES == {"scatter": 0, "voxelize": 1}
    # the largest grid a tile CTA holds, beside the binning CTAs' runs
    assert k1.MAX_BINS * k1.TILE * k1.TILE * 4 < k1.MAX_SMEM
    # 720x1280 is 23 x 40 tiles
    assert -(-720 // k1.TILE) * -(-1280 // k1.TILE) == 920 <= k1.MAX_TILES


def _levels(rng, B, shapes, nchw=True):
    """(x, y) per level as NHWC [B, h, w, c] views; with ``nchw`` permuted
    views of NCHW tensors, as EEMFlow's pooled features are."""
    pairs = []
    for c, h, w in shapes:
        if nchw:
            x, y = (torch.from_numpy(rng.standard_normal((B, c, h, w)).astype(np.float32)).permute(0, 2, 3, 1)
                    for _ in range(2))
        else:
            x, y = (torch.from_numpy(rng.standard_normal((B, h, w, c)).astype(np.float32)) for _ in range(2))
        pairs.append((x, y))
    return pairs


LEVELS = ((16, 6, 7), (32, 5, 9), (64, 4, 5))
_CORR_PAIRS = _levels(np.random.default_rng(1), 2, LEVELS)
_corr_want = {}  # the JAX correlation of _CORR_PAIRS per level, by displacement set


@pytest.mark.parametrize("batch", [1, 2], ids=["B1", "B2"])
@pytest.mark.parametrize("indices", [INDEX_53, None], ids=["index53", "full81"])
def test_local_corr_levels_matches_jax_per_level(batch, indices):
    # B=1 takes the first sample of the B=2 inputs (still permuted views) and
    # of their JAX reference, which is computed per sample: each JAX level
    # shape compiles once
    pairs = [(x[:batch], y[:batch]) for x, y in _CORR_PAIRS]
    assert not pairs[0][0].is_contiguous()
    if indices not in _corr_want:
        _corr_want[indices] = [
            np.asarray(jcorr.local_correlation(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), 4, indices))
            for x, y in _CORR_PAIRS
        ]
    got = k2.local_corr_levels(pairs, 4, indices)
    assert len(got) == 3
    for g, want in zip(got, _corr_want[indices]):
        assert tuple(g.shape) == want[:batch].shape
        _close(g.numpy(), want[:batch])


def test_local_corr_levels_one_and_two_levels_match_local_corr():
    pairs = _levels(np.random.default_rng(3), 2, LEVELS, nchw=False)
    for k in (1, 2):
        for (x, y), g in zip(pairs[:k], k2.local_corr_levels(pairs[:k], 4, INDEX_53)):
            np.testing.assert_array_equal(g.numpy(), k2.local_corr(x, y, 4, INDEX_53).numpy())


@pytest.mark.parametrize("indices", [INDEX_53, None], ids=["index53", "full81"])
def test_local_corr_levels_grads_match_autograd(indices):
    rng = np.random.default_rng(4)
    base = _levels(rng, 2, LEVELS)
    pairs = [tuple(t.detach().clone().requires_grad_() for t in p) for p in base]
    outs = k2.local_corr_levels(pairs, 4, indices)
    assert all(isinstance(o.grad_fn, k2.LocalCorrLevels._backward_cls) for o in outs)
    gs = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32)) for o in outs]
    got = torch.autograd.grad(outs, [t for p in pairs for t in p], gs)
    ref_in = [tuple(t.detach().clone().requires_grad_() for t in p) for p in base]
    refs = [k2.plain(x, y, 4, indices) for x, y in ref_in]
    want = torch.autograd.grad(refs, [t for p in ref_in for t in p], gs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["f32", "bf16", "windowed_f32"])
def test_local_corr_levels_grads_match_plain_autograd(case):
    """``LocalCorrLevels`` (one call, the twin on the CPU) gives plain
    autograd's gradients for every level, in float32 and bf16; and the
    windowed formulation its backward differentiates, called directly,
    gives them in float32 for the 53 displacements and for all 81."""
    from eemflow_tpu_torch.ops.correlation import local_correlation_windowed

    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    rng = np.random.default_rng(5)
    xs, ys = ([torch.from_numpy(rng.standard_normal((2, 6, 9, c)).astype(np.float32)).to(dtype).requires_grad_()
               for c in (16, 32, 64)] for _ in range(2))
    if case == "windowed_f32":
        # the full window on the last level
        index_sets = (INDEX_53, INDEX_53, None)
        outs = [local_correlation_windowed(x, y, 4, i) for x, y, i in zip(xs, ys, index_sets)]
    else:
        index_sets = (INDEX_53,) * 3
        outs = k2.local_corr_levels(list(zip(xs, ys)), 4, INDEX_53)
        assert all(isinstance(o.grad_fn, k2.LocalCorrLevels._backward_cls) for o in outs)
    gs = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32)).to(dtype) for o in outs]
    got = torch.autograd.grad(outs, xs + ys, gs)
    x2, y2 = ([t.detach().requires_grad_() for t in ts] for ts in (xs, ys))
    ref = torch.autograd.grad([k2.plain(a, b, 4, i) for a, b, i in zip(x2, y2, index_sets)], x2 + y2, gs)
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 5e-3 * max(1.0, float(r.abs().max()))
        assert float((g.float() - r.float()).abs().max()) <= tol


def test_local_corr_levels_validates_its_levels():
    x = torch.zeros(1, 4, 5, 8)
    with pytest.raises(ValueError, match="levels"):
        k2.local_corr_levels([], 4)
    with pytest.raises(ValueError, match="levels"):
        k2.local_corr_levels([(x, x)] * 4, 4)
    m = torch.empty(1, 4, 5, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.local_corr_levels([(m, m)], 4)


@pytest.mark.parametrize("shape", [(12, 20, 16), (12, 20, 32), (12, 20, 64), (96, 160, 64), (37, 45, 16),
                                   (3, 4, 8), (45, 80, 512)])
@pytest.mark.parametrize("K", [53, 81])
def test_local_corr_plan_fits_a_cta(shape, K):
    rows, cols, cc = k2.plan_level(*shape, K, 4)
    assert rows * cols * K <= k2.THREADS * k2.OUT_PER_THREAD
    assert 1 <= cc <= shape[2] and k2.staging_bytes(rows, cols, cc, 4) <= k2.SMEM_BUDGET
    cs = k2.channel_stride(cc)
    assert cs % 2 == 1 and cc <= cs <= cc + 1
    if shape[:2] == (12, 20):  # EEMFlow's 720x1280 levels: a row, half the width, all channels a CTA
        assert (rows, cols, cc) == (1, 10, shape[2])


def test_local_corr_level_table_for_the_forward():
    """The struct of one launch over EEMFlow's three 12x20 levels at B=2
    (permuted NCHW views in, channels-first out): each level's CTAs follow
    the last's, strides are copied as given."""
    B, K = 2, len(INDEX_53)
    pairs = [tuple(torch.empty(B, c, 12, 20, device="meta").permute(0, 2, 3, 1) for _ in range(2))
             for c in (16, 32, 64)]
    nchw = lambda c: (c * 240, 20, 1, 240)
    plan = k2._Plan(pairs, [(K * 240, 20, 1, 240)] * 3, 4, tuple(INDEX_53))
    args = plan.args
    assert ctypes.sizeof(args) == ctypes.sizeof(k2._Args)
    assert (args.nlevels, args.K, args.md) == (3, K, 4)
    assert list(args.idx[:K]) == list(INDEX_53)
    firsts = [args.lv[i].first_block for i in range(3)]
    assert firsts == [0, 48, 96] and args.blocks == 144  # B x 12 row bands x 2 column tiles a level
    for i, c in enumerate((16, 32, 64)):
        lv = args.lv[i]
        assert (lv.B, lv.H, lv.W, lv.C, lv.rows, lv.cols, lv.cc, lv.cs) == (B, 12, 20, c, 1, 10, c, c + 1)
        assert (lv.bands, lv.ctiles) == (12, 2)
        assert tuple(lv.xs) == nchw(c) and tuple(lv.os) == (K * 240, 20, 1, 240)
        assert lv.inv_c == pytest.approx(1.0 / c)
    assert args.smem_bytes == k2.staging_bytes(1, 10, 64, 4)
    # the outputs lie one after another in one buffer
    assert [o[2] for o in plan.outs] == [0, B * 240 * K, 2 * B * 240 * K] and plan.numel == 3 * B * 240 * K


def test_eemflow_corrs_match_per_level_correlation():
    from eemflow_tpu_torch.models.eemflow import EEMFlow

    model = EEMFlow()
    rng = np.random.default_rng(5)
    p1, p2 = ([torch.from_numpy(rng.standard_normal((2, c, 4, 6)).astype(np.float32)) for c in (16, 32, 64)]
              for _ in range(2))
    with torch.no_grad():
        cvs = model._corrs(p1, p2)
    for a, b, cv in zip(p1, p2, cvs):
        want = k2.plain(a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1), 4, model.corr_indices).permute(0, 3, 1, 2)
        assert tuple(cv.shape) == (2, len(model.corr_indices), 4, 6)
        np.testing.assert_array_equal(cv.numpy(), want.numpy())
