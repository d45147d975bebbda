"""The research evaluation surface of the port against the JAX package on
the CPU: ``eval.runner.ResearchTester``'s seven modes against JAX's — with a
stub model whose flow is exact in float32 every return value, file name,
``.flo`` and picture is equal; with a seeded EEMFlow at 64×96 (weights
through ``compat.from_jax``) the AEE-derived numbers agree within 1e-5
relative and the ``.flo`` within 1e-4·max(1, |flow|) — then the CLIs'
``--mode`` (``test_hrem``'s six, ``test_mvsec``'s eight), EEMFlow's
``s2d_stem`` and ``stacked_coarse`` against JAX's (2×128×192, groups 5 and
1, 1e-4·max(1, |flow|)) and against the port's standard forward (1e-5·max(1,
|flow|)), and ``time_eval --bf16`` (the flow within the serving bf16 limit,
2% relative L2, of float32).  JAX writes its pictures as JPEGs through cv2;
the tests capture the arrays it hands to ``cv2.imwrite`` and compare them
with the port's PNGs."""

import csv
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn

from eemflow_tpu.eval.runner import ResearchTester as JaxResearchTester
from eemflow_tpu.models.eemflow import EEMFlow as JaxEEMFlow
from test_golden_acceptance import CKPT, GOLDEN, make_hrem_fixture
from test_torch_mvsec import make_mvsec_fixture

from eemflow_tpu_torch.compat.from_jax import eemflow_state_dict_from_jax
from eemflow_tpu_torch.compat.torch_loader import load_model_checkpoint
from eemflow_tpu_torch.data.hrem import HREMEventFlow
from eemflow_tpu_torch.eval.metrics import flow_error
from eemflow_tpu_torch.eval.runner import ResearchTester
from eemflow_tpu_torch.events.io import read_flo, write_flo
from eemflow_tpu_torch.models.registry import get_eval_model
from eemflow_tpu_torch.tools.test_hrem import main as hrem_cli
from eemflow_tpu_torch.tools.test_mvsec import main as mvsec_cli
from eemflow_tpu_torch.viz.png import read_png

H, W, BINS = 32, 48, 5
LOW_OPT = {"xla_backend_optimization_level": 0}
FLOW_TOL = 1e-4  # the port's EEMFlow parity tolerance, of max(1, |flow|)
OPTION_TOL = 1e-5  # an option against the port's own standard forward


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class DS:
    """Four samples of seeded volumes, zero at a share of pixels that grows
    from sample to sample (so the density buckets differ), a ground truth and
    the sparse mask."""

    evaluation_type = "dense"

    def __init__(self, h=H, w=W, seed=0):
        rng = np.random.default_rng(seed)
        self.samples = []
        for i, keep in enumerate((0.02, 0.1, 0.2, 0.6)):
            mask = (rng.random((h, w, 1)) < keep).astype(np.float32)
            old = rng.standard_normal((h, w, BINS)).astype(np.float32) * mask
            self.samples.append({
                "event_volume_old": old,
                "event_volume_new": rng.standard_normal((h, w, BINS)).astype(np.float32) * mask,
                "flow": (rng.standard_normal((h, w, 2)) * 2).astype(np.float32),
                "event_valid": np.abs(old).sum(-1, keepdims=True),
                "names": f"seq_{i:03d}",
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return dict(self.samples[i])


class JaxStub(nn.Module):
    """A flow exact in float32 on both sides: the first volume's first two
    channels halved."""

    @nn.compact
    def __call__(self, e1, e2, train=False):
        s = self.param("s", nn.initializers.zeros, (1,))
        return (e1, e2), [e1[..., :2] * 0.5 + s]


class PortStub(torch.nn.Module):
    def forward(self, e1, e2, train=False):
        return (e1, e2), [e1[..., :2] * 0.5]


@pytest.fixture
def captured(monkeypatch):
    """The arrays the JAX package hands to ``cv2.imwrite``, by file name."""
    out = {}
    monkeypatch.setattr(cv2, "imwrite", lambda path, img: out.__setitem__(os.path.basename(path), img) or True)
    return out


def _jax_mode(tester, mode, ds, out_dir):
    return {
        "save_flow": lambda: tester.test_multi_save_flow(ds, out_dir),
        "low_epe": lambda: tester.test_vis_low_epe(ds, out_dir, epe_threshold=2.2),
        "warp": lambda: tester.inference_warp(ds, out_dir),
        "density": lambda: tester.test_multi_density(ds),
        "dsec_submission": lambda: tester.save_dsec_submission(ds, out_dir),
        "warp_loss": lambda: tester.inference_warp_loss(ds, stride=1),
        "multi_key": lambda: tester.test_multi_key(ds),
    }[mode]()


def _port_mode(tester, mode, ds, out_dir):
    if mode == "low_epe":
        return tester.test_vis_low_epe(ds, out_dir, epe_threshold=2.2)
    if mode == "warp_loss":
        return tester.inference_warp_loss(ds, stride=1)
    return tester.run_mode(mode, ds, out_dir)


def _same(a, b):
    """Equal values, NaN equal to NaN, through nested tuples, lists, dicts."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return a == b


@pytest.mark.parametrize("mode", ResearchTester.MODES)
def test_stub_modes_equal_jaxs(tmp_path, captured, mode):
    ds = DS()
    model = JaxStub()
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, BINS)), jnp.zeros((1, H, W, BINS)))
    theirs = _jax_mode(JaxResearchTester(model, variables, save_path=str(tmp_path / "jax")), mode, ds,
                       str(tmp_path / "jax" / mode))
    ours = _port_mode(ResearchTester(PortStub(), torch.device("cpu"), save_path=str(tmp_path / "port")), mode, ds,
                      str(tmp_path / "port" / mode))
    assert _same(ours, theirs), (ours, theirs)
    port_dir, jax_dir = tmp_path / "port" / mode, tmp_path / "jax" / mode
    files = sorted(os.listdir(port_dir)) if port_dir.exists() else []
    pictures = [f for f in files if f.endswith(".png")]
    jax_files = sorted(os.listdir(jax_dir)) if jax_dir.exists() else []
    assert sorted(f for f in files if f.endswith(".flo")) == sorted(f for f in jax_files if f.endswith(".flo"))
    assert sorted(p[: -len(".png")] for p in pictures) == sorted(n.rsplit(".", 1)[0] for n in captured)
    for f in files:
        if f.endswith(".flo"):
            np.testing.assert_array_equal(read_flo(str(port_dir / f)), read_flo(str(jax_dir / f)))
    for p in pictures:
        jax_name = p if mode == "dsec_submission" else p[: -len(".png")] + ".jpg"
        np.testing.assert_array_equal(read_png(str(port_dir / p)), captured[jax_name], err_msg=p)
    if mode == "multi_key":
        with open(tmp_path / "port" / "key_density.csv") as a, open(tmp_path / "jax" / "key_density.csv") as b:
            assert a.read() == b.read()
    if mode in ("save_flow", "warp", "dsec_submission"):
        assert ours == 4 and len(pictures) == (8 if mode == "warp" else 4)


def _seeded_jax_eemflow(shape, groups=5, seed=0, **kw):
    """JAX EEMFlow variables from ``jax.eval_shape`` and a seeded He fill."""
    model = JaxEEMFlow(groups=groups, **kw)
    x = jnp.zeros(shape, jnp.float32)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(seed)

    def fill(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        return (rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return model, jax.tree_util.tree_map(fill, abstract)


@pytest.fixture(scope="module")
def seeded_pair():
    """JAX and port ResearchTesters on one seeded EEMFlow at 64×96."""
    model, variables = _seeded_jax_eemflow((1, 64, 96, BINS), seed=3)
    port = get_eval_model("eemflow")
    port.load_state_dict(eemflow_state_dict_from_jax(variables))
    return model, variables, port


def test_seeded_eemflow_modes_agree_with_jax(seeded_pair, tmp_path, captured):
    model, variables, port = seeded_pair
    ds = DS(64, 96, seed=5)
    jt = JaxResearchTester(model, variables, save_path=str(tmp_path / "jax"))
    pt = ResearchTester(port, torch.device("cpu"), save_path=str(tmp_path / "port"))
    # .flo against JAX's
    assert pt.test_multi_save_flow(ds, str(tmp_path / "p")) == jt.test_multi_save_flow(ds, str(tmp_path / "j")) == 4
    for f in sorted(f for f in os.listdir(tmp_path / "p") if f.endswith(".flo")):
        want = read_flo(str(tmp_path / "j" / f))
        np.testing.assert_allclose(read_flo(str(tmp_path / "p" / f)), want, rtol=0,
                                   atol=FLOW_TOL * max(1.0, float(np.abs(want).max())))
    # the AEE-derived numbers
    aees = [flow_error(s["flow"], pt.run_sample(s), event_img=np.squeeze(s["event_valid"]))[0] for s in ds.samples]
    ours, theirs = pt.test_multi_density(ds), jt.test_multi_density(ds)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k][1] == theirs[k][1] and (ours[k][1] == 0 or abs(ours[k][0] - theirs[k][0]) <= 1e-5 * theirs[k][0])
    np.testing.assert_allclose(pt.inference_warp_loss(ds, stride=1), jt.inference_warp_loss(ds, stride=1), rtol=1e-5)
    (m1, rows1), (m2, rows2) = pt.test_multi_key(ds), jt.test_multi_key(ds)
    np.testing.assert_allclose(m1, m2, rtol=1e-5)
    assert [r[:3] for r in rows1] == [r[:3] for r in rows2]
    # low_epe at the median AEE, no AEE within 1e-4 of it
    threshold = float(np.median(aees))
    assert min(abs(a - threshold) for a in aees) > 1e-4
    kept1 = pt.test_vis_low_epe(ds, str(tmp_path / "lp"), epe_threshold=threshold)
    kept2 = jt.test_vis_low_epe(ds, str(tmp_path / "lj"), epe_threshold=threshold)
    assert [i for i, _ in kept1] == [i for i, _ in kept2] and len(kept1) == 2
    np.testing.assert_allclose([a for _, a in kept1], [a for _, a in kept2], rtol=1e-5)


def test_multi_key_refuses_a_model_without_maps(tmp_path):
    class NoMaps(torch.nn.Module):
        def forward(self, e1, e2, train=False):
            return None, [e1[..., :2]]

    with pytest.raises(ValueError, match="NoMaps returns no event map"):
        ResearchTester(NoMaps(), torch.device("cpu"), save_path=str(tmp_path)).test_multi_key(DS())


@pytest.fixture(scope="module")
def golden_root(tmp_path_factory):
    with open(GOLDEN) as f:
        seed = json.load(f)["fixture_seed"]
    return make_hrem_fixture(str(tmp_path_factory.mktemp("hrem")), seed=seed)


def test_hrem_save_flow_gives_the_golden_aee(golden_root, tmp_path):
    """``test_hrem --mode save_flow`` on the golden 720p split: its ``.flo``
    files give the golden AEE within 0.01 and equal the standard path's flow
    within 1e-6."""
    assert hrem_cli(["-model", "eemflow", "--data_root", golden_root, "--checkpoint", CKPT, "--save_dir",
                     str(tmp_path), "--device", "cpu", "--mode", "save_flow"]) == 2
    out = tmp_path / "eemflow_dt1" / "save_flow"
    assert sorted(os.listdir(out)) == ["000000.flo", "000000_flow.png", "000001.flo", "000001_flow.png"]
    ds = HREMEventFlow(golden_root, dt="dt1")
    ds.change_test_sequence("indoor_fast")
    tester = ResearchTester(get_eval_model("eemflow"), torch.device("cpu"))
    load_model_checkpoint(tester.model, CKPT, "eemflow")
    aees = []
    for i in range(2):
        flo = read_flo(str(out / f"{i:06d}.flo"))
        sample = ds[i]
        np.testing.assert_allclose(flo, tester.run_sample(sample), rtol=0, atol=1e-6)
        aees.append(flow_error(sample["flow"], flo, event_img=np.squeeze(sample["event_valid"]))[0])
    with open(GOLDEN) as f:
        assert abs(np.mean(aees) - json.load(f)["aee"]) < 0.01
    assert read_png(str(out / "000000_flow.png")).shape == (720, 1280, 3)


def _small_hrem(base, h=64, w=128, n_events=3000):
    rng = np.random.default_rng(21)
    root = os.path.join(base, "hrem")
    for i in range(2):
        d = os.path.join(root, "test", "dt1", "outdoor_slow", f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        for name in ("events1.npz", "events2.npz"):
            np.savez(os.path.join(d, name), x=rng.integers(0, w, n_events).astype(np.int32),
                     y=rng.integers(0, h, n_events).astype(np.int32),
                     t=np.sort(rng.integers(0, 10**9, n_events)).astype(np.int64),
                     p=rng.integers(0, 2, n_events).astype(np.int8))
        write_flo((rng.standard_normal((h, w, 2)) * 2).astype(np.float32), os.path.join(d, "flow.flo"))
    return root


@pytest.mark.parametrize("voxelize", [(), ("--device_voxelize",)], ids=["host", "device_voxelize"])
def test_hrem_every_mode_runs(tmp_path, monkeypatch, voxelize):
    monkeypatch.setattr(HREMEventFlow, "image_height", 64)
    monkeypatch.setattr(HREMEventFlow, "image_width", 128)
    root = _small_hrem(str(tmp_path))
    base = ["-model", "eemflow", "--data_root", root, "--checkpoint", CKPT, "--save_dir", str(tmp_path / "out"),
            "--device", "cpu", "--max_samples", "1", *voxelize]
    std = hrem_cli(base)
    assert std["outdoor_slow"]["n_samples"] == 1
    res = {m: hrem_cli(base + ["--mode", m]) for m in ResearchTester.MODES[:5]}
    assert res["save_flow"] == res["warp"] == res["dsec_submission"] == 1
    density = [v for v in res["density"].values() if v[1]]
    assert len(density) == 1 and abs(density[0][0] - std["outdoor_slow"]["AEE"]) < 1e-6
    out = tmp_path / "out" / "eemflow_dt1"
    assert os.listdir(out / "dsec_submission") == ["00000.png"]  # the sample's name
    assert sorted(os.listdir(out / "warp")) == ["000000_ev1.png", "000000_ev2_warped.png"]


def test_mvsec_every_mode_runs(tmp_path):
    root = make_mvsec_fixture(str(tmp_path), ("indoor_flying1",), h=260, w=346, n_events=3000, seed=55, first=3,
                              last=8)
    base = ["-model", "eemflow", "--sequence", "indoor_flying1", "--data_root", root, "--checkpoint", CKPT,
            "--frames", "3", "5", "--stride", "1", "--save_dir", str(tmp_path / "out"), "--device", "cpu",
            "--max_samples", "1"]
    std = mvsec_cli(base)
    res = {m: mvsec_cli(base + ["--mode", m]) for m in ResearchTester.MODES}
    assert std["n_samples"] == 1 and res["save_flow"] == res["warp"] == res["dsec_submission"] == 1
    assert abs(res["multi_key"][0] - std["AEE"]) < 1e-6 and np.isfinite(res["warp_loss"])
    with open(tmp_path / "out" / "eemflow_dt1_indoor_flying1" / "key_density.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["name", "input", "unet_out", "AEE"] and len(rows) == 2
    assert float(rows[1][1]) == float(rows[1][2])  # EEMFlow's maps are its inputs


def test_unknown_mode_exits_non_zero():
    for cli in (hrem_cli, mvsec_cli):
        with pytest.raises(SystemExit) as e:
            cli(["--checkpoint", CKPT, "--device", "cpu", "--mode", "no_such_mode"])
        assert e.value.code != 0
    with pytest.raises(SystemExit) as e:
        hrem_cli(["--checkpoint", CKPT, "--device", "cpu", "--mode", "warp_loss"])  # an MVSEC mode
    assert e.value.code != 0


@pytest.fixture(scope="module")
def option_inputs():
    rng = np.random.default_rng(31)
    return [rng.standard_normal((2, 128, 192, BINS)).astype(np.float32) for _ in range(2)]


OPTIONS = ("s2d_stem", "stacked_coarse")


@pytest.fixture(scope="module")
def jax_option_flows(option_inputs):
    """Per groups: the seeded variables and JAX's flow under each option,
    both options in one compile."""
    cache = {}

    def get(groups):
        if groups not in cache:
            _, variables = _seeded_jax_eemflow((1, 64, 64, BINS), groups=groups, seed=groups)
            models = [JaxEEMFlow(groups=groups, **{o: True}) for o in OPTIONS]
            ev1, ev2 = (jnp.asarray(a) for a in option_inputs)
            both = lambda v, a, b: [m.apply(v, a, b)[1][-1] for m in models]
            flows = jax.jit(both).lower(variables, ev1, ev2).compile(LOW_OPT)(variables, ev1, ev2)
            cache[groups] = variables, dict(zip(OPTIONS, (np.asarray(f) for f in flows)))
        return cache[groups]

    return get


@pytest.mark.parametrize("groups", [5, 1])
@pytest.mark.parametrize("option", OPTIONS)
def test_option_matches_jax_and_the_standard_forward(option_inputs, jax_option_flows, option, groups):
    variables, wants = jax_option_flows(groups)
    want = wants[option]
    sd = eemflow_state_dict_from_jax(variables)
    std, opt = get_eval_model("eemflow", groups=groups), get_eval_model("eemflow", groups=groups, **{option: True})
    std.load_state_dict(sd)
    opt.load_state_dict(sd)  # the standard state_dict: no new or missing key
    with torch.inference_mode():
        x1, x2 = (torch.from_numpy(a) for a in option_inputs)
        got = opt(x1, x2)[1][-1].numpy()
        ref = std(x1, x2)[1][-1].numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=OPTION_TOL * max(1.0, float(np.abs(ref).max())))


def test_options_keep_the_state_dict_and_their_scope(option_inputs):
    """Both options read the standard ``state_dict``; ``stacked_coarse`` is
    eval-only (``train=True`` takes the standard path, grad mode refuses it)
    and ``fast_head`` wins over it; ``s2d_stem`` applies in training too."""
    std = get_eval_model("eemflow")
    keys = set(std.state_dict())
    x1, x2 = (torch.from_numpy(a[:1, :64, :64]) for a in option_inputs)
    for kw in ({"s2d_stem": True}, {"stacked_coarse": True}, {"s2d_stem": True, "stacked_coarse": True}):
        m = get_eval_model("eemflow", **kw)
        assert set(m.state_dict()) == keys
        m.load_state_dict(std.state_dict())
        with torch.no_grad():
            np.testing.assert_allclose(m(x1, x2, train=True)[1][-1].numpy(), std(x1, x2, train=True)[1][-1].numpy(),
                                       rtol=0, atol=1e-6)
    stacked = get_eval_model("eemflow", stacked_coarse=True)
    stacked.load_state_dict(std.state_dict())
    with pytest.raises(RuntimeError, match="stacked_coarse"):
        stacked(x1, x2)
    s2d = get_eval_model("eemflow", s2d_stem=True)
    s2d.load_state_dict(std.state_dict())
    s2d(x1, x2, train=True)[1][-1].sum().backward()
    assert s2d.pconv1_1[0].weight.grad is not None and float(s2d.pconv1_1[0].weight.grad.abs().sum()) > 0
    both = get_eval_model("eemflow", stacked_coarse=True, fast_head=True)
    fast = get_eval_model("eemflow", fast_head=True)
    both.load_state_dict(std.state_dict())
    fast.load_state_dict(std.state_dict())
    with torch.inference_mode():
        np.testing.assert_array_equal(both(x1, x2)[1][-1].numpy(), fast(x1, x2)[1][-1].numpy())


@pytest.mark.parametrize("extra", [(), ("--fast",)], ids=["standard", "fast"])
def test_time_eval_bf16_within_the_serving_limit(extra):
    from eemflow_tpu_torch.tools.time_eval import main as time_eval

    res = time_eval(["--size", "64", "128", "-bs", "1", "--reps", "1", "--bf16", "--device", "cpu", *extra])
    assert res["bf16"] and 0 < res["rel_l2"] <= 0.02
