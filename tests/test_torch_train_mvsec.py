"""MVSEC training in the port against the JAX package, on the CPU: the
batches of the train split (the host path with the augmentor's resize
branch, and the raw-event path with its flips and crop offsets and the
device preprocess) equal JAX's for one seed; the ``train_mvsec`` CLI runs
two steps of ERAFT (``configs/mvsec_eraft.json``'s recipe, host path) and
of EEMFlow (``--device_voxelize --bf16``) on a shrunken sensor; the MVSEC
configs of the four registered models build their models.  The step
function itself is held against JAX's in ``tests/test_torch_train*.py``."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eemflow_tpu.data.mvsec as jax_mvsec
from eemflow_tpu.data.device_input import make_device_preprocess as jax_preprocess
from eemflow_tpu.data.loader import batch_iterator as jax_batches
from eemflow_tpu.utils.config import model_kwargs_from_config as jax_model_kwargs
from test_torch_mvsec import make_mvsec_fixture

import eemflow_tpu_torch.data.mvsec as port_mvsec
from eemflow_tpu_torch.data.device_input import make_device_preprocess
from eemflow_tpu_torch.data.loader import batch_iterator
from eemflow_tpu_torch.models.registry import get_model
from eemflow_tpu_torch.tools.train_mvsec import main as train_cli
from eemflow_tpu_torch.utils.config import load_config, model_kwargs_from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 80      # the shrunken sensor
CROP = (48, 64)    # the crop of the shrunken recipe
FRAMES = (3, 9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_mvsec_fixture(str(tmp_path_factory.mktemp("mvsec_train")), ("outdoor_day2",), h=H, w=W,
                              n_events=800, seed=21, first=FRAMES[0], last=FRAMES[1] + 8)


@pytest.fixture
def small_sensor(monkeypatch):
    """Both packages' datasets on the 64x80 sensor and the fixture's frames."""
    for mod in (jax_mvsec, port_mvsec):
        monkeypatch.setattr(mod.MvsecEventFlow, "image_height", H)
        monkeypatch.setattr(mod.MvsecEventFlow, "image_width", W)
        monkeypatch.setitem(mod.VALID_TIME_INDEX, "outdoor_day2", [FRAMES])


@pytest.mark.parametrize("raw", [False, True], ids=["host", "device_voxelize"])
@pytest.mark.parametrize("dt", ["dt1", "dt4"])
def test_train_batches_match_jax(root, small_sensor, raw, dt):
    aug = {"crop_size": list(CROP), "min_scale": -0.1, "max_scale": 1.0, "do_flip": True}
    kw = dict(train=True, aug_params=aug, raw_events=raw, bucket_size=1 << 12, bucket_rungs=4)
    pairs = []
    for mod in (jax_mvsec, port_mvsec):
        cls = mod.MvsecEventFlow if dt == "dt1" else mod.MvsecEventFlow_dt4
        pairs.append(cls(root, "outdoor_day2", rng=np.random.default_rng(7), **kw))
    theirs = jax_batches(pairs[0], 2, shuffle=True, seed=7)
    ours = batch_iterator(pairs[1], 2, shuffle=True, seed=7)
    for _ in range(3):  # an epoch of 6 samples
        a, b = next(theirs), next(ours)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        if raw:
            assert "crop_y" in b and b["flow"].shape == (2,) + CROP + (2,)
            got = make_device_preprocess(5, H, W, crop_size=CROP)({k: torch.from_numpy(v) for k, v in b.items()})
            ref = jax.jit(jax_preprocess(5, H, W, crop_size=CROP))({k: jnp.asarray(v) for k, v in a.items()})
            for k in ("event_volume_old", "event_volume_new"):
                assert got[k].shape == (2,) + CROP + (5,)
                np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5)
        else:
            assert b["event_volume_old"].shape == (2,) + CROP + (5,)


def _config(tmp_path, name, mixed_precision):
    with open(os.path.join(REPO, "configs", name)) as f:
        cfg = json.load(f)
    cfg["data_loader"]["train"]["args"]["aug_params"]["crop_size"] = list(CROP)
    cfg["train"]["mixed_precision"] = mixed_precision
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.mark.parametrize("model,config,extra", [
    ("eraft", "mvsec_eraft.json", ()),
    ("eemflow", "mvsec_event_flow_dense.json", ("--device_voxelize", "--bf16")),
], ids=["eraft_host", "eemflow_device_voxelize_bf16"])
def test_train_cli_two_steps(root, small_sensor, tmp_path, model, config, extra):
    out = tmp_path / "out"
    state = train_cli([
        "-model", model, "--config", _config(tmp_path, config, False), "--data_root", root, "-bs", "2",
        "--lr", "1e-4", "--train_iters", "2", "--val_iters", "2", "--save_dir", str(out), "--device", "cpu",
        "--bucket_size", str(1 << 12), *extra,
    ])
    assert state.step == 2
    run = glob.glob(str(out / f"{model}_dt1_outdoor_day2_lr0.0001_wd5e-05"))[0]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        epoch = [json.loads(line) for line in f if '"epoch"' in line][-1]
    assert epoch["n_steps"] == 2 and np.isfinite(epoch["mean_loss"]) and epoch["mean_loss"] > 0
    assert os.path.exists(os.path.join(run, "ckpt", "epoch_1.pt"))
    with open(os.path.join(run, "config.json")) as f:
        snap = json.load(f)
    assert snap["cli"]["model"] == model and snap["data_loader"]["train"]["args"]["aug_params"]["crop_size"] == list(CROP)
    with open(os.path.join(run, "log.txt")) as f:
        assert f"dataset: {FRAMES[1] - FRAMES[0]} samples" in f.read()


def test_train_cli_refuses_other_families(root):
    with pytest.raises(KeyError, match="item 7"):
        train_cli(["-model", "gma_rnn", "--data_root", root, "--device", "cpu"])


def test_mvsec_configs_of_registered_models():
    """Each MVSEC config of the registered models: the port forwards the
    model fields JAX forwards (SKFlow's and KPAFlow's iterations, widths and
    patch sizes; none beyond the defaults for the others), and the model
    builds at the config's bins."""
    seen = set()
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "mvsec_*.json"))):
        cfg = load_config(path)
        model = cfg.get("model")
        if model not in ("eemflow", "eemflow_plus", "eraft", "raft", "gma", "skflow", "kpaflow"):
            continue
        seen.add(model)
        kwargs = model_kwargs_from_config(model, cfg)
        assert kwargs == jax_model_kwargs(model, cfg), path
        bins = cfg["data_loader"]["train"]["args"]["num_voxel_bins"]
        get_model(model, n_first_channels=bins, **kwargs)
    assert seen == {"eemflow", "eraft", "raft", "gma", "skflow", "kpaflow"}
