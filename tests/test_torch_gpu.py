"""Kernels of the port against their plain twins on the card, K2's
backward, the eval-only kernels' refusal under grad, and ERAFT on the card
against the CPU.  Marked ``gpu``: they skip where no CUDA device is
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


# EEMFlow's three pyramid levels at 720x1280 (padded 768x1280), B=2:
# (input [B, C, H, W], conv widths, pool, emit_full)
K3_LEVELS = {
    "level1": ((2, 16, 384, 640), (16,), 32, True),
    "level2": ((2, 32, 192, 320), (32, 32), 16, True),
    "level3": ((2, 64, 96, 160), (64, 64), 8, False),
}
# float32: only the summation order differs; bf16: both sides round the
# same operands, but an intermediate that differs in its last float32 bit
# can round to the neighbouring bf16 value
K3_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-3}


def _max_rel_err(got, ref):
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("level", sorted(K3_LEVELS))
def test_fused_convs_kernel_matches_twin(cuda, level, dtype):
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import launch_counts

    shape, widths, pool, emit_full = K3_LEVELS[level]
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
    does not fit one launch's shared memory, split at its midpoint."""
    from eemflow_tpu_torch.kernels import fused_convs as k3
    from eemflow_tpu_torch.kernels import launch_counts

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 37, 45, 16)).astype(np.float32)).to(cuda)
    cins, couts = (16, 24, 32), (8, 8, 3)
    ws, bs = _conv_params(rng, cins, couts, cuda)
    flags = dict(relus=(True, True, False), concat=(True, True, False))
    got, none = k3.fused_convs(x.permute(0, 3, 1, 2), ws, bs, None, **flags)
    ref, _ = k3.plain(x.permute(0, 3, 1, 2), ws, bs, None, **flags)
    torch.cuda.synchronize()
    assert none is None and tuple(got.shape) == (2, 3, 37, 45)
    assert _max_rel_err(got, ref) <= K3_TOL[torch.float32]

    x = torch.from_numpy(rng.standard_normal((1, 32, 64, 64)).astype(np.float32)).to(cuda)
    ws, bs = _conv_params(rng, (32, 32), (32, 32), cuda)
    before = launch_counts["fused_convs_pool"]
    full, pooled = k3.fused_convs(x, ws, bs, 32)
    assert launch_counts["fused_convs_pool"] == before + 2
    ref_full, ref_pooled = k3.plain(x, ws, bs, 32)
    torch.cuda.synchronize()
    assert _max_rel_err(full, ref_full) <= K3_TOL[torch.float32]
    assert _max_rel_err(pooled, ref_pooled) <= K3_TOL[torch.float32]


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
    # a grid too large for shared memory runs from a device-memory scratch
    f1, f2 = (
        [torch.from_numpy(rng.standard_normal((batch, 17, 30, c)).astype(np.float32)).to(cuda) for c in (16, 32, 64)]
        for _ in range(2)
    )
    got = coarse_head(f1, f2, hw, groups, INDEX_53, 4)
    ref = coarse_head(f1, f2, hw, groups, INDEX_53, 4, impl="plain")
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


def _update_inputs(rng, h, w, device):
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return (t(np.tanh(rng.standard_normal((1, h, w, 128)))), t(np.maximum(rng.standard_normal((1, h, w, 128)), 0)),
            t(rng.standard_normal((1, h, w, 324))), t(2 * rng.standard_normal((1, h, w, 2))))


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
