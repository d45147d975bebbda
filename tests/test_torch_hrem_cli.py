"""The port's HREM eval CLI on the CPU at protocol resolution (720×1280):
the golden checkpoint on the seed-99 synthetic split must reproduce the
committed AEE within 0.01, and the device-voxelize paths and the fused
modes (``--fast_head --fast_pyramid``) must agree with the host path
within 1e-5.  Also the port's HREM dataset against the JAX package's on
the same files, and the profiling and timing tools at a tiny size."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from eemflow_tpu.data.hrem import HREMEventFlow as JaxHREM
from test_golden_acceptance import CKPT, GOLDEN, make_hrem_fixture

from eemflow_tpu_torch.data.hrem import HREMEventFlow
from eemflow_tpu_torch.tools.test_hrem import main


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests share the machine with the suite's
    other workers, and threads beyond its cores only wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hrem_root(tmp_path_factory):
    with open(GOLDEN) as f:
        seed = json.load(f)["fixture_seed"]
    return make_hrem_fixture(str(tmp_path_factory.mktemp("hrem")), seed=seed)


def _run(root, out_dir, *extra):
    res = main([
        "-model", "eemflow", "-int", "dt1", "--data_root", root, "--checkpoint", CKPT,
        "--save_dir", str(out_dir), "--save_csv", "--device", "cpu", *extra,
    ])
    with open(os.path.join(str(out_dir), "eemflow_dt1", "test_epe_per_sample.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    csv_aee = float(np.mean([float(r["epe"]) for r in rows]))
    assert abs(csv_aee - res["mean"]["AEE"]) < 1e-6
    return csv_aee


@pytest.fixture(scope="module")
def golden_aee():
    with open(GOLDEN) as f:
        return json.load(f)["aee"]


@pytest.fixture(scope="module")
def host_aee(hrem_root, tmp_path_factory):
    """AEE of the standard host-voxelize run."""
    return _run(hrem_root, tmp_path_factory.mktemp("host"))


def test_cli_reproduces_golden_aee(hrem_root, tmp_path, golden_aee, host_aee):
    host = host_aee
    assert abs(host - golden_aee) < 0.01
    for name, extra in (
        ("dev", ("--device_voxelize",)),
        ("dev_b2", ("--device_voxelize", "--eval_batch", "2")),
        ("fast", ("--fast",)),
    ):
        assert abs(_run(hrem_root, tmp_path / name, *extra) - host) < 1e-5, name


def test_cli_fused_modes(hrem_root, tmp_path, golden_aee, host_aee):
    fused = _run(hrem_root, tmp_path, "--fast_head", "--fast_pyramid")
    assert abs(fused - host_aee) < 1e-5
    assert abs(fused - golden_aee) < 0.01


@pytest.mark.parametrize("raw", [False, True], ids=["voxel", "raw_events"])
def test_dataset_matches_jax(hrem_root, raw):
    ours = HREMEventFlow(hrem_root, raw_events=raw)
    ref = JaxHREM(hrem_root, train=False, raw_events=raw)
    assert list(ours.nori_list) == list(ref.nori_list) == ["indoor_fast"]
    a, b = ours[0], ref[0]
    keys = ("events_old", "n_old", "events_new", "n_new") if raw else (
        "event_volume_old", "event_volume_new", "event_valid")
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    np.testing.assert_allclose(a["flow"], b["flow"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(a["valid"], b["valid"])


@pytest.mark.parametrize(
    "extra",
    [["--events", "0"], ["--events", "3000"], ["--fast_head", "--fast_pyramid"]],
    ids=["forward", "device_voxelize_sample", "fused_forward"],
)
def test_profile_model_on_cpu(tmp_path, extra):
    from eemflow_tpu_torch.tools.profile_model import main as profile_main

    res = profile_main([
        "--device", "cpu", "--size", "64", "96", "--reps", "2", *extra,
        "--logdir", str(tmp_path),
    ])
    assert res["ms_per_call"] > 0 and os.path.exists(res["trace"])
    # no device on the CPU: device metrics are not measured, not invented
    assert res["device_busy_share"] is None and res["top_kernels"] == []


@pytest.mark.parametrize(
    "extra", [[], ["--fast_head", "--fast_pyramid_bf16"]], ids=["standard", "fused_bf16"]
)
def test_time_eval_on_cpu(extra):
    from eemflow_tpu_torch.tools.time_eval import main as time_main

    res = time_main(["--device", "cpu", "--size", "64", "96", "-bs", "1", "--reps", "2", *extra])
    assert res["device"] == "cpu" and res["ms_per_img"] > 0
    assert res["modes"] == ({} if not extra else
                            {"fast_head": True, "fast_head_impl": "kernel",
                             "fast_pyramid": True, "fast_pyramid_dtype": "bf16"})


def test_update_block_bound():
    """K5's computed bound at ERAFT 512x960, B=1, 12 iterations: the layer
    list of update_block.py gives 2,675,968 multiply-adds per grid pixel;
    float32 mode is bound by the split's three TF32 products at 495
    TFLOP/s, bf16 mode by one product at 989."""
    from eemflow_tpu_torch.tools.update_block_bound import main as bound_main

    res = bound_main(["--size", "512", "960", "-bs", "1", "--iters", "12"])
    assert res["grid"] == [64, 120] and res["launches"] == 24
    assert res["flop"] == 2 * 2_675_968 * 64 * 120 * 12
    assert res["bound_by"] == "operations" and abs(res["bound_ms"] - 3 * res["flop"] / 495e9) < 1e-9
    assert abs(res["bf16_bound_ms"] - res["flop"] / 989e9) < 1e-9
    assert abs(res["fp32_simt_ms"] - res["flop"] / 67e9) < 1e-9


def test_device_busy_ms_is_the_union_of_device_intervals(tmp_path):
    """Overlapping kernels count once, copies and fills count, and the user
    annotations and host ops the profiler also exports do not."""
    from eemflow_tpu_torch.tools.profile_model import device_busy_ms

    events = [
        {"ph": "X", "cat": "kernel", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "ts": 5, "dur": 10},  # overlaps the first
        {"ph": "X", "cat": "kernel", "ts": 6, "dur": 2},  # inside both
        {"ph": "X", "cat": "gpu_memcpy", "ts": 20, "dur": 5},
        {"ph": "X", "cat": "gpu_memset", "ts": 30, "dur": 1.5},
        {"ph": "X", "cat": "gpu_user_annotation", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "ts": 40, "dur": 50},
        {"ph": "i", "cat": "kernel", "ts": 95},
    ]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    assert device_busy_ms(str(trace)) == pytest.approx((15 + 5 + 1.5) / 1e3)
    trace.write_text(json.dumps({"traceEvents": events[5:]}))
    assert device_busy_ms(str(trace)) is None
