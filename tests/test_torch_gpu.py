"""Kernels of the port against their plain twins on the card (EEMFlow+'s
K3 chains among them), K2's backward, the eval-only kernels' refusal under
grad, ERAFT and EEMFlow+ on the card against the CPU, their train steps and
ERAFT's stacked lookup on the card against the CPU, and the serving CLI on
the card against the CPU.  Marked ``gpu``: they skip where no CUDA device is
present.  On a machine with a
card and without JAX (``tests/conftest.py`` imports it) run them with
``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_voxel_scatter_kernel_matches_twin(cuda):
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import voxel_scatter as k1

    rng = np.random.default_rng(0)
    B, N, H, W, bins = 3, 4096, 45, 80, 5
    ev = np.zeros((B, N, 4), np.float32)
    nv = np.array([3000, 4096, 1000], np.int32)
    for b, n in enumerate(nv):
        ev[b, :n, 0] = 7.0 if b == 2 else np.sort(rng.uniform(0, 5e4, n))  # b=2: ΔT == 0
        ev[b, :n, 1] = rng.integers(-2, W + 2, n)
        ev[b, :n, 2] = rng.integers(-2, H + 2, n)
        ev[b, :n, 3] = rng.integers(0, 2, n)
    e, n = torch.from_numpy(ev).to(cuda), torch.from_numpy(nv).to(cuda)
    before = launch_counts["voxel_scatter"]
    got = k1.voxel_scatter(e, n, bins, H, W)
    assert launch_counts["voxel_scatter"] == before + 1
    ref = k1.plain(e, n, bins, H, W)
    torch.cuda.synchronize()
    # atomics sum in no fixed order: rounding-level agreement
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    cpu = k1.plain(e.cpu(), n.cpu(), bins, H, W)
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5 * float(cpu.abs().max())


@pytest.mark.parametrize("shape", [(1, 12, 20, 16), (2, 12, 20, 64), (1, 96, 160, 64)])
@pytest.mark.parametrize("full", [False, True], ids=["index53", "full81"])
def test_local_corr_kernel_matches_twin(cuda, shape, full):
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.models.eemflow import INDEX_53

    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda) for _ in range(2))
    idx = None if full else INDEX_53
    got = k2.local_corr(x, y, 4, idx)
    ref = k2.plain(x, y, 4, idx)
    torch.cuda.synchronize()
    assert tuple(got.shape) == shape[:3] + (81 if full else 53,)
    assert float((got - ref).abs().max()) <= 1e-5


def test_kernel_wrappers_validate_inputs(cuda):
    from eemflow_tpu_torch.kernels.local_corr import local_corr
    from eemflow_tpu_torch.kernels.voxel_scatter import voxel_scatter

    x = torch.zeros(1, 4, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        local_corr(x, x.double())
    with pytest.raises(ValueError):
        voxel_scatter(torch.zeros(1, 128, 3, device=cuda),
                      torch.zeros(1, dtype=torch.int32, device=cuda), 5, 4, 4)


def test_forward_on_card_matches_cpu(cuda):
    import os

    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.models.registry import get_eval_model

    ckpt = os.path.join(os.path.dirname(__file__), "fixtures", "eemflow_hrem_golden.pth.tar")
    model = get_eval_model("eemflow")
    model.load_state_dict(to_state_dict(load_torch_checkpoint(ckpt)))
    rng = np.random.default_rng(2)
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((2, 96, 128, 5)).astype(np.float32)) for _ in range(2))
    with torch.inference_mode():
        ref = model(ev1, ev2)[1][-1]
        got = model.to(cuda)(ev1.to(cuda), ev2.to(cuda))[1][-1].cpu()
    assert float((got - ref).abs().max()) <= 1e-4


def _conv_params(rng, cins, couts, device):
    """OIHW weights at a He-like scale (activations stay O(1) down a chain)
    and biases, float32 on ``device``."""
    ws, bs = [], []
    for cin, cout in zip(cins, couts):
        w = rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))
        ws.append(torch.from_numpy(w.astype(np.float32)).to(device))
        bs.append(torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32)).to(device))
    return ws, bs


# EEMFlow's three pyramid levels at 720x1280 (padded 768x1280), per
# sample: (input [C, H, W], conv widths, pool, emit_full)
K3_LEVELS = {
    "level1": ((16, 384, 640), (16,), 32, True),
    "level2": ((32, 192, 320), (32, 32), 16, True),
    "level3": ((64, 96, 160), (64, 64), 8, False),
}
# float32: only the summation order differs; bf16: both sides round the
# same operands, but an intermediate that differs in its last float32 bit
# can round to the neighbouring bf16 value
K3_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-3}


def _max_rel_err(got, ref):
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("batch", [1, 2], ids=["B1", "B2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("level", sorted(K3_LEVELS))
def test_fused_convs_kernel_matches_twin(cuda, level, dtype, batch):
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import launch_counts

    chw, widths, pool, emit_full = K3_LEVELS[level]
    shape = (batch,) + chw
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    ws, bs = _conv_params(rng, (shape[1],) + widths[:-1], widths, cuda)
    before = launch_counts["fused_convs_pool"]
    full, pooled = k3.fused_convs(x, ws, bs, pool, dtype, emit_full)
    assert launch_counts["fused_convs_pool"] == before + 1
    ref_full, ref_pooled = k3.plain(x, ws, bs, pool, dtype, emit_full)
    torch.cuda.synchronize()
    assert (full is None) == (not emit_full)
    if emit_full:
        assert _max_rel_err(full, ref_full) <= K3_TOL[dtype]
    assert tuple(pooled.shape) == (shape[0], widths[-1], shape[2] // pool, shape[3] // pool)
    assert _max_rel_err(pooled, ref_pooled) <= K3_TOL[dtype]


def test_fused_convs_kernel_concat_chain_and_layouts(cuda):
    """A FlowEstimatorDense-style concat chain with a linear last conv and
    no pool at a ragged size, from an NHWC view; and a pooled chain that
    does not fit one launch's shared memory, split by its plan."""
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import launch_counts

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 37, 45, 16)).astype(np.float32)).to(cuda)
    cins, couts = (16, 24, 32), (8, 8, 3)
    ws, bs = _conv_params(rng, cins, couts, cuda)
    flags = dict(relus=(True, True, False), concat=(True, True, False))
    before = dict(launch_counts)
    got, none = k3.fused_convs(x.permute(0, 3, 1, 2), ws, bs, None, **flags)
    ref, _ = k3.plain(x.permute(0, 3, 1, 2), ws, bs, None, **flags)
    torch.cuda.synchronize()
    assert none is None and tuple(got.shape) == (2, 3, 37, 45)
    assert _max_rel_err(got, ref) <= K3_TOL[torch.float32]
    # a concat chain runs on the tensor cores too, in one launch
    assert launch_counts["fused_convs_pool"] == before["fused_convs_pool"] + 1

    x = torch.from_numpy(rng.standard_normal((1, 32, 64, 64)).astype(np.float32)).to(cuda)
    ws, bs = _conv_params(rng, (32, 32), (32, 32), cuda)
    before = launch_counts["fused_convs_pool"]
    full, pooled = k3.fused_convs(x, ws, bs, 32)
    assert launch_counts["fused_convs_pool"] == before + 2
    ref_full, ref_pooled = k3.plain(x, ws, bs, 32)
    torch.cuda.synchronize()
    assert _max_rel_err(full, ref_full) <= K3_TOL[torch.float32]
    assert _max_rel_err(pooled, ref_pooled) <= K3_TOL[torch.float32]


# (input [B, C, H, W] or an NHWC view's [B, H, W, C], conv widths, pool)
K3_LAYOUTS = {
    "ragged_no_pool": ((2, 32, 37, 45), False, (32, 16), None),
    "nhwc_view_pool8": ((2, 40, 48, 64), True, (64, 64), 8),
    "nhwc_ragged_one_conv": ((1, 21, 27, 16), True, (16,), None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(K3_LAYOUTS))
def test_fused_convs_tc_ragged_and_strided(cuda, case, dtype):
    """The tensor-core kernel on a grid its tiles do not divide, with no
    pool, and reading NHWC views through their strides, at B=1 and 2."""
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import launch_counts

    shape, nhwc, widths, pool = K3_LAYOUTS[case]
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    ws, bs = _conv_params(rng, (x.shape[1],) + widths[:-1], widths, cuda)
    before = launch_counts["fused_convs_pool"]
    full, pooled = k3.fused_convs(x, ws, bs, pool, dtype)
    assert launch_counts["fused_convs_pool"] == before + 1
    ref_full, ref_pooled = k3.plain(x, ws, bs, pool, dtype)
    torch.cuda.synchronize()
    assert _max_rel_err(full, ref_full) <= K3_TOL[dtype]
    if pool is not None:
        assert _max_rel_err(pooled, ref_pooled) <= K3_TOL[dtype]


def _head_params(rng, groups, device, channels=(16, 32, 64), k=53):
    """Random coarse-stage parameters by the port's state-dict names."""
    from eemflow_tpu_torch.ops.coarse_head import conv_names

    widths = ((16, None), (100, k + 16), (100, 100), (100, 100), (100, 100), (64, 100), (32, 64), (2, 32))
    params = {}
    for lvl, c in zip((1, 2, 3), channels):
        for i, (name, (cout, cin)) in enumerate(zip(conv_names(lvl), widths)):
            cin = c if cin is None else cin
            g = groups if i in (2, 3, 4) else 1
            w = rng.standard_normal((cout, cin // g, 3, 3)) * np.sqrt(2.0 / (9 * cin // g))
            params[f"{name}.weight"] = torch.from_numpy(w.astype(np.float32)).to(device)
            params[f"{name}.bias"] = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32)).to(device)
    params["out_conv.weight"] = torch.from_numpy(rng.standard_normal((2, 6, 1, 1)).astype(np.float32)).to(device)
    params["out_conv.bias"] = torch.from_numpy(rng.standard_normal(2).astype(np.float32)).to(device)
    return params


@pytest.mark.parametrize("groups", [5, 1])
@pytest.mark.parametrize("batch", [1, 2])
def test_coarse_head_kernel_matches_twin(cuda, batch, groups):
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.models.eemflow import INDEX_53
    from eemflow_tpu_torch.ops.coarse_head import HeadWeights, coarse_head

    rng = np.random.default_rng(5)
    hw = HeadWeights(_head_params(rng, groups, cuda), groups)
    f1, f2 = (
        [torch.from_numpy(rng.standard_normal((batch, 12, 20, c)).astype(np.float32)).to(cuda) for c in (16, 32, 64)]
        for _ in range(2)
    )
    before = launch_counts["coarse_head"]
    got = coarse_head(f1, f2, hw, groups, INDEX_53, 4)
    assert launch_counts["coarse_head"] == before + 1
    ref = coarse_head(f1, f2, hw, groups, INDEX_53, 4, impl="plain")
    torch.cuda.synchronize()
    assert tuple(got.shape) == (batch, 12, 20, 2)
    assert _max_rel_err(got, ref) <= 1e-5
    # a grid whose rows do not fill float4 stores, and one too large for
    # shared memory, which runs from a device-memory scratch
    for h, w in ((8, 15), (17, 30)):
        f1, f2 = (
            [torch.from_numpy(rng.standard_normal((batch, h, w, c)).astype(np.float32)).to(cuda)
             for c in (16, 32, 64)]
            for _ in range(2)
        )
        got = coarse_head(f1, f2, hw, groups, INDEX_53, 4)
        ref = coarse_head(f1, f2, hw, groups, INDEX_53, 4, impl="plain")
        torch.cuda.synchronize()
        assert _max_rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("cluster", [8, 16])
def test_coarse_head_kernel_cluster_sizes(cuda, cluster):
    """Both cluster sizes give the twin's flow at EEMFlow's 12x20 grids
    (16 where the card can place such a cluster; the query says so)."""
    from eemflow_tpu_torch.kernels import coarse_head as k4
    from eemflow_tpu_torch.models.eemflow import INDEX_53
    from eemflow_tpu_torch.ops.coarse_head import HeadWeights, coarse_head

    info = k4.kernel_info(cuda)
    assert info["max_clusters_8"] >= 1 and info["local_bytes"] == 0
    if info[f"max_clusters_{cluster}"] < 1:
        pytest.skip(f"this card holds no cluster of {cluster} CTAs at {info[f'smem_{cluster}']} B")
    rng = np.random.default_rng(12)
    hw = HeadWeights(_head_params(rng, 5, cuda), 5)
    f1, f2 = ([torch.from_numpy(rng.standard_normal((2, 12, 20, c)).astype(np.float32)).to(cuda)
               for c in (16, 32, 64)] for _ in range(2))
    got = k4._launch(f1, f2, hw, INDEX_53, 4, cluster)
    ref = coarse_head(f1, f2, hw, 5, INDEX_53, 4, impl="plain")
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref) <= 1e-5


def test_fused_modes_on_card_match_standard(cuda):
    import os

    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model

    ckpt = os.path.join(os.path.dirname(__file__), "fixtures", "eemflow_hrem_golden.pth.tar")
    sd = to_state_dict(load_torch_checkpoint(ckpt))
    rng = np.random.default_rng(6)
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((2, 192, 256, 5)).astype(np.float32)).to(cuda) for _ in range(2))
    std = get_eval_model("eemflow")
    fused = get_eval_model("eemflow", fast_pyramid=True, fast_head=True)
    for m in (std, fused):
        m.load_state_dict(sd)
        m.to(cuda)
    before = dict(launch_counts)
    with torch.inference_mode():
        ref = std(ev1, ev2)[1][-1]
        got = fused(ev1, ev2)[1][-1]
    assert launch_counts["fused_convs_pool"] - before["fused_convs_pool"] == 6
    assert launch_counts["coarse_head"] - before["coarse_head"] == 1
    assert float((got - ref).abs().max()) <= 1e-4


def _update_block(rng, device):
    """A BasicUpdateBlock with He-scaled random conv weights, eval mode."""
    from eemflow_tpu_torch.models.raft_core import BasicUpdateBlock

    block = BasicUpdateBlock()
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(torch.from_numpy(
                    (rng.standard_normal(tuple(m.weight.shape)) * np.sqrt(2.0 / fan_in)).astype(np.float32)))
                m.bias.copy_(torch.from_numpy((rng.standard_normal(m.bias.shape[0]) * 0.1).astype(np.float32)))
    return block.to(device).eval()


def _update_inputs(rng, h, w, device, batch=1):
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    b = batch
    return (t(np.tanh(rng.standard_normal((b, h, w, 128)))), t(np.maximum(rng.standard_normal((b, h, w, 128)), 0)),
            t(rng.standard_normal((b, h, w, 324))), t(2 * rng.standard_normal((b, h, w, 2))))


# float32: summation order only; bf16: as K3
K5_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grid", [(92, 160), (64, 120), (28, 12)], ids=["720p", "512x960", "28x12"])
def test_update_block_kernel_matches_plain(cuda, grid, dtype):
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import update_block as k5
    from eemflow_tpu_torch.ops.update_block import gru_flowhead_plain, make_fused_update, motion_encoder_plain

    rng = np.random.default_rng(7)
    fused = make_fused_update(_update_block(rng, cuda), dtype)
    net, inp, corr, flow = _update_inputs(rng, *grid, cuda)
    before = launch_counts["update_block"]
    with torch.inference_mode():
        motion = k5.update_motion(corr, flow, fused)
        ref_motion = motion_encoder_plain(corr, flow, fused.motion, dtype)
        net2, delta = k5.update_gru(net, inp, ref_motion, fused)
        ref_net, ref_delta = gru_flowhead_plain(net, inp, ref_motion, fused.gru, dtype)
    torch.cuda.synchronize()
    assert launch_counts["update_block"] == before + 2
    for got, ref in ((motion, ref_motion), (net2, ref_net), (delta, ref_delta)):
        assert got.shape == ref.shape
        assert _max_rel_err(got, ref) <= K5_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_update_block_kernel_matches_plain_at_batch_2(cuda, dtype):
    """B=2 on the 28x12 grid: M = 672 pixels, so the last CTA tile is
    ragged and tiles cross the batch boundary; no input needs a copy."""
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import update_block as k5
    from eemflow_tpu_torch.ops.update_block import gru_flowhead_plain, make_fused_update, motion_encoder_plain

    rng = np.random.default_rng(12)
    fused = make_fused_update(_update_block(rng, cuda), dtype)
    net, inp, corr, flow = _update_inputs(rng, 28, 12, cuda, batch=2)
    before = dict(launch_counts)
    with torch.inference_mode():
        motion = k5.update_motion(corr, flow, fused)
        ref_motion = motion_encoder_plain(corr, flow, fused.motion, dtype)
        net2, delta = k5.update_gru(net, inp, ref_motion, fused)
        ref_net, ref_delta = gru_flowhead_plain(net, inp, ref_motion, fused.gru, dtype)
    torch.cuda.synchronize()
    assert launch_counts["update_block"] == before["update_block"] + 2
    assert launch_counts["update_block_relayout"] == before["update_block_relayout"]
    for got, ref in ((motion, ref_motion), (net2, ref_net), (delta, ref_delta)):
        assert got.shape == ref.shape and ref.shape[0] == 2
        assert _max_rel_err(got, ref) <= K5_TOL[dtype]


def test_eraft_fused_update_reads_its_inputs_in_place(cuda):
    """ERAFT's forward through fused_update on the card launches K5 twice an
    iteration and copies none of its inputs: net, inp, the correlation
    features and the flow are already in the layout the kernel reads."""
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model

    torch.manual_seed(13)
    model = get_eval_model("eraft", iters=3, fused_update=True).to(cuda)
    ev1, ev2 = (torch.randn(1, 96, 128, 5, device=cuda) for _ in range(2))
    before = dict(launch_counts)
    with torch.inference_mode():
        flow = model(ev1, ev2)[1][-1]
    torch.cuda.synchronize()
    assert launch_counts["update_block"] - before["update_block"] == 6
    assert launch_counts["update_block_relayout"] == before["update_block_relayout"]
    assert flow.shape == (1, 96, 128, 2) and bool(torch.isfinite(flow).all())


def test_update_block_kernel_reads_strided_views(cuda):
    """net and inp as NHWC views of NCHW tensors, corr as a slice: the
    kernel reads them through their strides."""
    from eemflow_tpu_torch.kernels import update_block as k5
    from eemflow_tpu_torch.ops.update_block import make_fused_update

    rng = np.random.default_rng(8)
    fused = make_fused_update(_update_block(rng, cuda))
    net, inp, corr, flow = _update_inputs(rng, 20, 28, cuda)
    wide = torch.cat([corr, corr[..., :4]], dim=-1)
    views = (net.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
             inp.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), wide[..., :324])
    with torch.inference_mode():
        want = k5.update_gru(net, inp, k5.update_motion(corr, flow, fused), fused)
        got = k5.update_gru(views[0], views[1], k5.update_motion(views[2], flow, fused), fused)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) == 0.0


def test_local_corr_backward_on_card(cuda):
    """F1: K2's forward on the card under grad goes through LocalCorr; its
    grads equal autograd through the twin."""
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.models.eemflow import INDEX_53

    rng = np.random.default_rng(9)
    xa, ya = (torch.from_numpy(rng.standard_normal((2, 12, 20, 32)).astype(np.float32)).to(cuda) for _ in range(2))
    x, y = xa.clone().requires_grad_(), ya.clone().requires_grad_()
    out = k2.local_corr(x, y, 4, INDEX_53)
    assert isinstance(out.grad_fn, k2.LocalCorr._backward_cls)
    g = torch.randn_like(out)
    gx, gy = torch.autograd.grad(out, [x, y], g)
    x2, y2 = xa.clone().requires_grad_(), ya.clone().requires_grad_()
    ref = k2.plain(x2, y2, 4, INDEX_53)
    px, py = torch.autograd.grad(ref, [x2, y2], g)
    torch.cuda.synchronize()
    assert float((out - ref).detach().abs().max()) <= 1e-5
    assert float((gx - px).abs().max()) <= 1e-5 and float((gy - py).abs().max()) <= 1e-5


def test_eval_only_kernels_refuse_grad(cuda):
    """F1: K1, K3, K4 and K5 have no backward; under grad, an input or a
    weight that requires grad is refused instead of silently losing its
    gradient."""
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import update_block as k5
    from eemflow_tpu_torch.kernels import voxel_scatter as k1
    from eemflow_tpu_torch.models.eemflow import INDEX_53
    from eemflow_tpu_torch.ops.coarse_head import HeadWeights, coarse_head
    from eemflow_tpu_torch.ops.update_block import make_fused_update

    rng = np.random.default_rng(10)
    ev = torch.zeros(1, 128, 4, device=cuda, requires_grad=True)
    n = torch.zeros(1, dtype=torch.int32, device=cuda)
    x = torch.randn(1, 8, 16, 16, device=cuda, requires_grad=True)
    ws, bs = _conv_params(rng, (8,), (8,), cuda)
    hw = HeadWeights(_head_params(rng, 5, cuda), 5)
    f = [torch.randn(1, 12, 20, c, device=cuda, requires_grad=True) for c in (16, 32, 64)]
    hw_live = HeadWeights({k: v.requires_grad_() for k, v in _head_params(rng, 5, cuda).items()}, 5)
    f_const = [t.detach() for t in f]
    fused = make_fused_update(_update_block(rng, cuda))  # the block's parameters require grad
    net, inp, corr, flow = _update_inputs(rng, 8, 8, cuda)
    motion = torch.zeros(1, 8, 8, 128, device=cuda)
    calls = (
        lambda: k1.voxel_scatter(ev, n, 5, 4, 4),
        lambda: k3.fused_convs(x, ws, bs, 8),
        lambda: coarse_head(f, f, hw, 5, INDEX_53, 4),
        lambda: coarse_head(f_const, f_const, hw_live, 5, INDEX_53, 4),
        lambda: k5.update_motion(corr.requires_grad_(), flow, fused),
        lambda: k5.update_gru(net, inp, motion, fused),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="eval-only"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def test_fused_pyramid_follows_an_in_place_edit(cuda):
    """F2 on the card: the fused pyramid's packed chains (cached on the
    model) follow an in-place edit of a pyramid weight."""
    import os

    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.models.registry import get_eval_model

    ckpt = os.path.join(os.path.dirname(__file__), "fixtures", "eemflow_hrem_golden.pth.tar")
    sd = to_state_dict(load_torch_checkpoint(ckpt))
    ev1, ev2 = (torch.randn(1, 128, 192, 5, device=cuda) for _ in range(2))
    std = get_eval_model("eemflow")
    fused = get_eval_model("eemflow", fast_pyramid=True, fast_head=True)
    for m in (std, fused):
        m.load_state_dict(sd)
        m.to(cuda)
    with torch.inference_mode():
        fused(ev1, ev2)
    for m in (std, fused):
        with torch.no_grad():
            m.pconv2_3[0].weight.mul_(-2.0)
            m.decoder_1.conv7.weight.mul_(3.0)
    with torch.inference_mode():
        got = fused(ev1, ev2)[1][-1]
        ref = std(ev1, ev2)[1][-1]
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("fused_update", [False, True], ids=["module", "fused_update"])
def test_eraft_on_card_matches_cpu(cuda, fused_update):
    import os

    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model

    ckpt = os.path.join(os.path.dirname(__file__), "fixtures", "eraft_hrem_golden.pth.tar")
    model = get_eval_model("eraft", iters=4, fused_update=fused_update)
    model.load_state_dict(to_state_dict(load_torch_checkpoint(ckpt)))
    rng = np.random.default_rng(11)
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((1, 72, 104, 5)).astype(np.float32)) for _ in range(2))
    with torch.inference_mode():
        ref = model(ev1, ev2)[1]
        before = launch_counts["update_block"]
        got = model.to(cuda)(ev1.to(cuda), ev2.to(cuda))[1].cpu()
    assert launch_counts["update_block"] - before == (8 if fused_update else 0)
    assert got.shape == ref.shape == (1, 1, 72, 104, 2)
    assert float((got - ref).abs().max()) <= 1e-4


def _k1_events(rng, n_valid, N, h, w, pixel=None, dt_zero=()):
    ev = np.zeros((len(n_valid), N, 4), np.float32)
    for b, n in enumerate(n_valid):
        ev[b, :n, 0] = 7.0 if b in dt_zero else np.sort(rng.uniform(0, 5e4, n))
        ev[b, :n, 1] = rng.integers(-2, w + 2, n) if pixel is None else pixel[0]
        ev[b, :n, 2] = rng.integers(-2, h + 2, n) if pixel is None else pixel[1]
        ev[b, :n, 3] = rng.integers(0, 2, n)
    return ev, np.asarray(n_valid, np.int32)


# (n_valid, N, bins, H, W, fixed pixel, samples with ΔT == 0)
K1_CASES = {
    "main": ((60_000, 40_000), 1 << 16, 5, 180, 320, None, (1,)),
    "n_valid_0_and_1": ((0, 1), 512, 5, 64, 96, None, ()),
    "out_of_frame": ((5_000, 300), 8192, 5, 64, 96, (96 + 3, 4), ()),
    "one_pixel": ((20_000, 9_000), 1 << 15, 5, 64, 96, (7, 9), ()),
    "ragged_bins15": ((3_000, 5_000), 8192, 15, 45, 77, None, ()),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_voxelize_and_voxel_scatter_kernels_match_plain(cuda, case):
    """K1's two entry points against their plain versions: voxel_scatter
    within 1e-5 of the largest cell, voxelize within 1e-5 of max(1,
    largest) (shared-memory atomics and the statistics sum in another
    order); one count a call."""
    from eemflow_tpu_torch.events.voxel import voxelize_plain
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import voxel_scatter as k1

    n_valid, N, bins, h, w, pixel, dt_zero = K1_CASES[case]
    ev, nv = _k1_events(np.random.default_rng(sorted(K1_CASES).index(case)), n_valid, N, h, w, pixel, dt_zero)
    e, n = torch.from_numpy(ev).to(cuda), torch.from_numpy(nv).to(cuda)
    before = launch_counts["voxel_scatter"]
    raw = k1.voxel_scatter(e, n, bins, h, w)
    norm = k1.voxelize(e, n, bins, h, w)
    assert launch_counts["voxel_scatter"] == before + 2
    ref_raw = k1.plain(e, n, bins, h, w)
    ref_norm = voxelize_plain(e, n, bins, h, w)
    torch.cuda.synchronize()
    assert float((raw - ref_raw).abs().max()) <= 1e-5 * float(ref_raw.abs().max())
    assert _max_rel_err(norm, ref_norm) <= 1e-5


def test_voxel_kernels_write_every_cell(cuda):
    """The grid comes from torch.empty: every cell, zeros included, is the
    kernel's (memory the allocator hands back full of NaN shows none)."""
    from eemflow_tpu_torch.kernels import voxel_scatter as k1

    ev, nv = _k1_events(np.random.default_rng(5), (300, 0), 1024, 70, 90)
    e, n = torch.from_numpy(ev).to(cuda), torch.from_numpy(nv).to(cuda)
    for fn in (k1.voxel_scatter, k1.voxelize):
        junk = torch.full((2, 5, 70, 90), float("nan"), device=cuda)
        del junk
        grid = fn(e, n, 5, 70, 90)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(grid).all()) and not grid[1].any()


@pytest.mark.parametrize("batch", [1, 2], ids=["B1", "B2"])
def test_local_corr_levels_matches_plain_on_strided_views(cuda, batch):
    """One launch over three levels read through the strides of permuted
    NCHW views (as EEMFlow's pooled features), each output channels-first,
    against the plain version level by level; and on NHWC inputs."""
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.models.eemflow import INDEX_53

    rng = np.random.default_rng(20 + batch)
    for nchw in (True, False):
        pairs = []
        for c, h, w in ((16, 12, 20), (32, 12, 20), (64, 12, 20)):
            shape = (batch, c, h, w) if nchw else (batch, h, w, c)
            t = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda) for _ in range(2)]
            pairs.append(tuple(x.permute(0, 2, 3, 1) for x in t) if nchw else tuple(t))
        before = launch_counts["local_corr"]
        got = k2.local_corr_levels(pairs, 4, INDEX_53)
        assert launch_counts["local_corr"] == before + 1
        for (x, y), g in zip(pairs, got):
            ref = k2.plain(x, y, 4, INDEX_53)
            torch.cuda.synchronize()
            assert g.shape == ref.shape and g.permute(0, 3, 1, 2).is_contiguous()
            assert float((g - ref).abs().max()) <= 1e-5


def test_eemflow_forward_takes_one_k2_launch_and_no_copy(cuda):
    """The standard forward computes its three correlations in one K2
    launch, on the pooled features' permuted views: the correlation step
    runs that one kernel and nothing else (no copies)."""
    import os

    from eemflow_tpu_torch.compat.torch_loader import load_torch_checkpoint, to_state_dict
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.models.registry import get_eval_model

    ckpt = os.path.join(os.path.dirname(__file__), "fixtures", "eemflow_hrem_golden.pth.tar")
    model = get_eval_model("eemflow")
    model.load_state_dict(to_state_dict(load_torch_checkpoint(ckpt)))
    model.to(cuda)
    rng = np.random.default_rng(12)
    ev1, ev2 = (torch.from_numpy(rng.standard_normal((2, 192, 256, 5)).astype(np.float32)).to(cuda) for _ in range(2))
    with torch.inference_mode():
        before = launch_counts["local_corr"]
        model(ev1, ev2)
        assert launch_counts["local_corr"] == before + 1
        p1 = model.pyramid(ev1.permute(0, 3, 1, 2).contiguous())
        p2 = model.pyramid(ev2.permute(0, 3, 1, 2).contiguous())
        model._corrs(p1, p2)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            cvs = model._corrs(p1, p2)
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "local_corr" in kernels[0], kernels
    for a, b, cv in zip(p1, p2, cvs):
        assert cv.is_contiguous()  # NCHW, as the decoder's concatenation reads it
        ref = k2.plain(a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1), 4, model.corr_indices).permute(0, 3, 1, 2)
        assert float((cv - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("batch", [1, 6], ids=["B1", "B6"])
def test_local_corr_levels_bf16_matches_plain(cuda, batch):
    """K2 on bf16 operands (the training forward's mixed precision): one
    launch over the three levels' permuted NCHW views, bf16 out, against
    the plain version (the float32 correlation of the bf16 operands,
    rounded once): the two differ by the rounding of a float32 sum taken
    in another order, within 5e-3 of max(1, |plain|)."""
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.models.eemflow import INDEX_53

    rng = np.random.default_rng(30 + batch)
    pairs = []
    for c in (16, 32, 64):
        t = [torch.from_numpy(rng.standard_normal((batch, c, 12, 20)).astype(np.float32)).to(cuda).to(torch.bfloat16)
             for _ in range(2)]
        pairs.append(tuple(x.permute(0, 2, 3, 1) for x in t))
    before = launch_counts["local_corr"]
    got = k2.local_corr_levels(pairs, 4, INDEX_53)
    assert launch_counts["local_corr"] == before + 1
    for (x, y), g in zip(pairs, got):
        ref = k2.plain(x, y, 4, INDEX_53)
        torch.cuda.synchronize()
        assert g.dtype == torch.bfloat16 and g.shape == ref.shape and g.permute(0, 3, 1, 2).is_contiguous()
        assert float((g.float() - ref.float()).abs().max()) <= 5e-3 * max(1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_local_corr_levels_backward_on_card(cuda, dtype):
    """Under grad the three levels still take one launch (LocalCorrLevels);
    the grads equal autograd through the twin's function."""
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.kernels import local_corr as k2
    from eemflow_tpu_torch.models.eemflow import INDEX_53

    rng = np.random.default_rng(40)
    xs, ys = ([torch.from_numpy(rng.standard_normal((2, 12, 20, c)).astype(np.float32)).to(cuda).to(dtype)
               .requires_grad_() for c in (16, 32, 64)] for _ in range(2))
    before = launch_counts["local_corr"]
    outs = k2.local_corr_levels(list(zip(xs, ys)), 4, INDEX_53)
    assert launch_counts["local_corr"] == before + 1
    assert all(isinstance(o.grad_fn, k2.LocalCorrLevels._backward_cls) for o in outs)
    gs = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(outs, xs + ys, gs)
    x2, y2 = ([t.detach().requires_grad_() for t in ts] for ts in (xs, ys))
    ref = torch.autograd.grad([k2.plain(a, b, 4, INDEX_53) for a, b in zip(x2, y2)], x2 + y2, gs)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        tol = 1e-5 if dtype == torch.float32 else 5e-3 * max(1.0, float(r.float().abs().max()))
        assert g.dtype == dtype and float((g.float() - r.float()).abs().max()) <= tol


def test_train_step_on_card_matches_cpu(cuda):
    """One float32 train step (device voxelize with flips, forward, loss,
    backward, clip, AdamW) from the same seeded parameters and batch at
    128x256, B=2: on the card (K1 voxelize twice, K2 once) and on the CPU
    (the plain versions).  Loss within 1e-4 relative; each parameter's
    gradient within 1e-3 of its largest |g| (float32 in other summation
    orders through two pyramids and their backward)."""
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.models.eemflow import EEMFlow
    from eemflow_tpu_torch.train.optim import make_optimizer
    from eemflow_tpu_torch.train.trainer import create_train_state, make_train_step

    rng = np.random.default_rng(13)
    h, w, B, N = 128, 256, 2, 8192
    ev = np.zeros((2, B, N, 4), np.float32)
    for f in range(2):
        for b in range(B):
            ev[f, b, :, 0] = np.sort(rng.uniform(0, 5e4, N))
            ev[f, b, :, 1] = rng.integers(0, w, N)
            ev[f, b, :, 2] = rng.integers(0, h, N)
            ev[f, b, :, 3] = rng.integers(0, 2, N)
    batch = {
        "events_old": ev[0], "events_new": ev[1], "n_old": np.array([N, N - 100], np.int32),
        "n_new": np.array([N - 7, N], np.int32), "flip_h": np.array([True, False]),
        "flip_v": np.array([False, True]), "flow": (rng.standard_normal((B, 16, 16, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, 16, 16), np.float32),
    }
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        state = create_train_state(EEMFlow(out_mesh_size=True), 5, make_optimizer(1e-3, num_steps=100), device=dev)
        grads = {}
        opt_step = state.opt.step

        def step_recording_grads(state=state, grads=grads, opt_step=opt_step):
            grads.update({n: p.grad.detach().cpu().clone() for n, p in state.model.named_parameters()})
            return opt_step()

        state.opt.step = step_recording_grads
        before = dict(launch_counts)
        _, metrics = make_train_step(preprocess=make_device_preprocess(5, h, w))(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        runs[dev.type] = (float(metrics["loss"]), grads, {k: launch_counts[k] - before[k] for k in launch_counts})
    (loss_cpu, g_cpu, n_cpu), (loss_gpu, g_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    assert n_cpu["voxel_scatter"] == n_cpu["local_corr"] == 0
    assert n_gpu["voxel_scatter"] == 2 and n_gpu["local_corr"] == 1
    assert np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    for name, g in g_cpu.items():
        assert float((g_gpu[name] - g).abs().max()) <= 1e-3 * float(g.abs().max()), name


# the two-volume models beyond EEMFlow: (model kwargs, K2 launches a step,
# the gradient's unit: each leaf's own largest |g|, or the model's for
# ERAFT, which normalises before nearly every ReLU, so that a float32
# rounding that flips one unit moves a leaf by ~1% of its own largest)
TWO_VOLUME_STEPS = {
    "eemflow_plus": ({"n_first_channels": 15}, 5, True),
    "eraft": ({"iters": 3}, 0, False),
}


@pytest.mark.parametrize("name", sorted(TWO_VOLUME_STEPS))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_two_volume_train_step_on_card_matches_cpu(cuda, name, bf16):
    """One train step of EEMFlow+ (15 bins, K2 five launches) or ERAFT
    (BatchNorm statistics updated) against the full-resolution flow, 128x256,
    B=2, device voxelize with flips, from the same seeded parameters and
    batch on the card and on the CPU.  float32: the loss within 1e-4
    relative, each gradient within 1e-3 of its unit, the BatchNorm
    statistics within 1e-4 of their largest; bf16 (both sides round the
    same operands, in other orders): the loss within 1e-2 relative and the
    whole gradient within 5% relative L2."""
    from eemflow_tpu_torch.data.device_input import make_device_preprocess
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.models.registry import get_model
    from eemflow_tpu_torch.train.optim import make_optimizer
    from eemflow_tpu_torch.train.trainer import create_train_state, make_train_step

    kw, k2, per_leaf = TWO_VOLUME_STEPS[name]
    bins = kw.get("n_first_channels", 5)
    rng = np.random.default_rng(17)
    h, w, B, N = 128, 256, 2, 8192
    ev = np.zeros((2, B, N, 4), np.float32)
    for f in range(2):
        for b in range(B):
            ev[f, b, :, 0] = np.sort(rng.uniform(0, 5e4, N))
            ev[f, b, :, 1] = rng.integers(0, w, N)
            ev[f, b, :, 2] = rng.integers(0, h, N)
            ev[f, b, :, 3] = rng.integers(0, 2, N)
    batch = {
        "events_old": ev[0], "events_new": ev[1], "n_old": np.array([N, N - 100], np.int32),
        "n_new": np.array([N - 7, N], np.int32), "flip_h": np.array([True, False]),
        "flip_v": np.array([False, True]), "flow": (rng.standard_normal((B, h, w, 2)) * 2).astype(np.float32),
        "valid": np.ones((B, h, w), np.float32),
    }
    runs = {}
    for key, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
        state = create_train_state(get_model(name, **kw), 5, make_optimizer(1e-4, num_steps=100), device=dev)
        grads = {}
        opt_step = state.opt.step

        def step_recording_grads(state=state, grads=grads, opt_step=opt_step):
            grads.update({n: p.grad.detach().cpu().clone() for n, p in state.model.named_parameters()})
            return opt_step()

        state.opt.step = step_recording_grads
        before = dict(launch_counts)
        _, metrics = make_train_step(preprocess=make_device_preprocess(bins, h, w), mixed_precision=bf16)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        stats = {k: v.detach().cpu() for k, v in state.model.state_dict().items() if "running" in k}
        runs[key] = (float(metrics["loss"]), grads, {k: launch_counts[k] - before[k] for k in launch_counts}, stats)
    (loss_cpu, g_cpu, n_cpu, s_cpu), (loss_gpu, g_gpu, n_gpu, s_gpu) = runs["cpu"], runs["card"]
    assert n_cpu["voxel_scatter"] == n_cpu["local_corr"] == 0
    assert n_gpu["voxel_scatter"] == 2 and n_gpu["local_corr"] == k2
    assert n_gpu["fused_convs_pool"] == n_gpu["coarse_head"] == n_gpu["update_block"] == 0
    assert bool(s_cpu) == (name == "eraft")
    ours = torch.cat([g_gpu[n].flatten() for n in g_cpu])
    ref = torch.cat([g.flatten() for g in g_cpu.values()])
    rel = float((ours - ref).norm() / ref.norm())
    if bf16:
        assert np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= 1e-2 * abs(loss_cpu)
        assert rel <= 5e-2, rel
        return
    assert np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    top = float(ref.abs().max())
    for n, g in g_cpu.items():
        unit = float(g.abs().max()) if per_leaf else top
        assert float((g_gpu[n] - g).abs().max()) <= 1e-3 * unit, n
    assert rel <= 1e-3, rel
    for k, v in s_cpu.items():
        assert float((s_gpu[k] - v).abs().max()) <= 1e-4 * float(v.abs().max()), k


@pytest.mark.parametrize("levels", [4, 5])
def test_stacked_lookup_on_card_matches_cpu(cuda, levels):
    """ERAFT's stacked lookup on the card at its 720x1280 grid's shapes
    (92x160, B=1): against the per-level lookup on the card and against the
    CPU, with its gradient."""
    from eemflow_tpu_torch.ops import corr_block

    rng = np.random.default_rng(levels)
    f1, f2 = (torch.from_numpy(rng.standard_normal((1, 92, 160, 64)).astype(np.float32)) for _ in range(2))
    coords = torch.from_numpy((rng.random((1, 92, 160, 2)) * np.array([160, 92]) * 1.2 - 8).astype(np.float32))
    out = {}
    for key, dev, stacked in (("cpu", torch.device("cpu"), True), ("card", cuda, True), ("card_per_level", cuda, False)):
        a, b = (t.to(dev, copy=True).requires_grad_() for t in (f1, f2))
        pyr = corr_block.build_corr_pyramid(a, b, levels)
        lookup = corr_block.lookup_corr_pyramid_stacked if stacked else corr_block.lookup_corr_pyramid
        win = lookup(pyr, coords.to(dev))
        (win * win.detach()).sum().backward()
        out[key] = (win.detach().cpu(), a.grad.cpu(), b.grad.cpu())
    for key in ("card_per_level", "cpu"):
        for got, want in zip(out["card"], out[key]):
            assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max())), key


def _he_chain(rng, cin, widths, concat, groups, device):
    ws, bs = [], []
    for f, cat, g in zip(widths, concat, groups):
        w = rng.standard_normal((f, cin // g, 3, 3)) * np.sqrt(2.0 / (9 * cin / g))
        ws.append(torch.from_numpy(w.astype(np.float32)).to(device))
        bs.append(torch.from_numpy((rng.standard_normal(f) * 0.1).astype(np.float32)).to(device))
        cin = f + (cin if cat else 0)
    return ws, bs


_DEC_G = (1, 3, 3, 3, 1, 1, 1)
# (input [B, C, H, W], widths, concat, groups and shuffle)
PLUS_K3_CHAINS = {
    "sgu": ((1, 64, 96, 160), (32, 32, 32, 16, 8, 3), (True,) * 5 + (False,), (1,) * 6),
    "decoder": ((1, 87, 96, 160), (96, 96, 96, 96, 64, 32, 2), (False,) * 7, _DEC_G),
    "decoder_level6": ((2, 87, 12, 20), (96, 96, 96, 96, 64, 32, 2), (False,) * 7, _DEC_G),
    "ragged_concat": ((2, 13, 37, 45), (6, 5, 3), (True, True, False), (1,) * 3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("chain", sorted(PLUS_K3_CHAINS))
def test_eemflow_plus_k3_chains_match_plain(cuda, chain, dtype):
    """K3's tensor-core route on EEMFlow+'s chains, at a 720x1280 level
    (96x160) and at level 6 (12x20, B=2): the SGU's concat chain and a
    decoder with its convs 2-4 grouped and shuffled; and a ragged concat
    chain whose widths are no multiple of 8; against the plain version at
    He-scaled random weights, K3_TOL of chip_smoke.py, in the launches
    the plan gives."""
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import launch_counts

    rng = np.random.default_rng(21)
    shape, widths, concat, groups = PLUS_K3_CHAINS[chain]
    relus = (True,) * (len(widths) - 1) + (False,)
    spec = k3.chain_spec(shape[1], widths, concat, groups, groups)
    launches = len(k3.plan_chain(spec, None, dtype == torch.bfloat16))
    assert (launches == 1) == (chain == "ragged_concat")  # EEMFlow+'s chains do not fit one launch
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    ws, bs = _he_chain(rng, shape[1], widths, concat, groups, cuda)
    before = launch_counts["fused_convs_pool"]
    got, _ = k3.fused_convs(x, ws, bs, None, dtype, True, relus, concat, groups=groups, shuffle=groups)
    assert launch_counts["fused_convs_pool"] == before + launches
    ref, _ = k3.plain(x, ws, bs, None, dtype, True, relus, concat, groups, groups)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _max_rel_err(got, ref) <= K3_TOL[dtype]


def test_eemflow_plus_on_card_matches_cpu(cuda):
    """EEMFlow+ (golden weights) at 128x192, B=2: the card's standard and
    fused forwards against the CPU's standard forward, 1e-5 of the largest
    flow (float32 in other summation orders through five levels of warp
    feedback); K2 five launches a forward; under the fused modes K3's
    launches: the pyramid 6, and the SGU and the decoders as their plans
    cut them at the three levels tall enough for their halo (32x48, 16x24
    and 8x12), none standard."""
    import os

    from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.models.registry import get_eval_model

    from eemflow_tpu_torch.kernels import fused_convs as k3

    chain_launches = len(k3.plan_chain(k3.chain_spec(64, (32, 32, 32, 16, 8, 3), (True,) * 5 + (False,)), None, False))
    chain_launches += len(k3.plan_chain(k3.chain_spec(87, (96, 96, 96, 96, 64, 32, 2), None, _DEC_G, _DEC_G), None, False))
    ckpt = os.path.join(os.path.dirname(__file__), "fixtures", "eemflow_plus_hrem_golden.pth.tar")
    rng = np.random.default_rng(8)
    ev = [torch.from_numpy(rng.standard_normal((2, 128, 192, 5)).astype(np.float32)) for _ in range(2)]
    cpu = get_eval_model("eemflow_plus")
    load_model_checkpoint(cpu, ckpt, "eemflow_plus")
    with torch.inference_mode():
        ref = cpu(*ev)[1][-1]
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    for kw in ({}, dict(fast_pyramid=True, fast_decoders=True, fast_sgu=True)):
        model = get_eval_model("eemflow_plus", **kw)
        load_model_checkpoint(model, ckpt, "eemflow_plus")
        model.to(cuda)
        before = dict(launch_counts)
        with torch.inference_mode():
            got = model(*(e.to(cuda) for e in ev))[1][-1]
        delta = {k: launch_counts[k] - before[k] for k in launch_counts}
        assert delta["local_corr"] == 5
        assert delta["fused_convs_pool"] == (6 + 3 * chain_launches if kw else 0)
        assert float((got.cpu() - ref).abs().max()) <= tol, kw


@pytest.mark.parametrize(
    "extra,k1_calls",
    [((), 6), (("--stream",), 4), (("--stream", "--chunk", "3"), 4), (("--host_voxelize", "--stream", "--chunk", "3"), 0)],
    ids=["pair", "stream", "stream_chunk3", "host_voxelize_stream_chunk3"],
)
def test_serve_on_card_matches_cpu(cuda, tmp_path, extra, k1_calls):
    """The serving CLI on the card (packer, pinned staging, K1, K2) against
    the same run on the CPU, 1e-4 on every .flo; K1 once a frame in stream
    steady state (after one prime), once a frame in pair mode, never with
    host voxelize; a chunk of three frames, whose pinned buffers are all
    filled before the first upload, waits for none."""
    import os

    from eemflow_tpu_torch.events.io import read_flo
    from eemflow_tpu_torch.kernels import launch_counts
    from eemflow_tpu_torch.tools.serve import main as serve

    rng = np.random.default_rng(23)
    h, w = 128, 192
    wins = [dict(x=rng.integers(0, w, 5000).astype(np.int32), y=rng.integers(0, h, 5000).astype(np.int32),
                 t=np.sort(rng.integers(0, 10**9, 5000)).astype(np.int64), p=rng.integers(0, 2, 5000).astype(np.int8))
            for _ in range(4)]
    root = os.path.join(str(tmp_path), "data")
    for i in range(3):
        d = os.path.join(root, f"{i:05d}")
        os.makedirs(d)
        np.savez(os.path.join(d, "events1.npz"), **wins[i])
        np.savez(os.path.join(d, "events2.npz"), **wins[i + 1])
    ckpt = os.path.join(os.path.dirname(__file__), "fixtures", "eemflow_hrem_golden.pth.tar")
    flows = {}
    for dev in ("cpu", "cuda"):
        out = os.path.join(str(tmp_path), dev)
        before = launch_counts["voxel_scatter"]
        res = serve(["--checkpoint", ckpt, "--data_root", root, "--size", str(h), str(w), "--bucket_size", "8192",
                     "--warmup", "0", "--out_dir", out, "--device", dev, *extra])
        calls = launch_counts["voxel_scatter"] - before
        assert res["frames"] == 3 and res["packer"].startswith("native")
        flows[dev] = {f: read_flo(os.path.join(out, f)) for f in sorted(os.listdir(out))}
    assert calls == k1_calls
    for name, f in flows["cpu"].items():
        assert float(np.abs(flows["cuda"][name] - f).max()) <= 1e-4, name
