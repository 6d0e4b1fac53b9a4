"""The port's bench (``python -m ptbxl_torch.bench``) on the host.

``PTBXL_TORCH_BENCH_SMOKE=1`` shrinks every row to batch <= 8 and iters <= 2,
so the whole ``--full`` table runs here with ``--device cpu``: a wiring check
of every row, the parity gates, the sidecar and the regression gate.  The
numbers are host times, no device measurement.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from ptbxl_torch import bench  # noqa: E402
from tests.torch_port_common import HERE  # noqa: E402

HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "device", "tflops", "mfu_pct",
                 "parity_gate", "row"}
FULL_TABLE = [
    ("framework", "highest", "f32", [512, 2048]),
    ("framework", "default", "bf16", [512, 2048, 8192]),
    ("framework", "default", "bf16_act", [8192, 16384]),
    ("int8", "int8", "int8", [8192, 11264, 12288, 16384]),
    ("kernel", "highest", "f32", [512, 2048]),
    ("hybrid", "default", "bf16", [8192]),
]


def _run_bench(*args, out):
    # one intra-op thread: the smoke rows are tiny, and eight threads a process
    # thrash when the suite's workers share the host's cores
    env = dict(os.environ, PTBXL_TORCH_BENCH_SMOKE="1", PYTHONPATH=HERE, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "ptbxl_torch.bench", "--device", "cpu",
                           "--out", str(out), *args],
                          cwd=HERE, env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench") / "full.json"
    r = _run_bench("--full", out=out)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        return r, json.load(f)


def test_headline_is_one_json_line(full_run):
    r, suite = full_run
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert set(head) == HEADLINE_KEYS
    assert head == suite["headline"]
    assert head["metric"] == "ecg_inference_records_per_sec_per_gpu"
    assert head["unit"] == "records/s" and head["value"] > 0
    assert head["device"] == "cpu" and head["mfu_pct"] is None  # no peak off the card
    assert head["parity_gate"] == {"name": "demo_pack_parity", "tol": 5e-3}


def test_sidecar_schema(full_run):
    _, suite = full_run
    assert suite["schema"] == "ptbxl_torch_bench_v1"
    assert suite["mode"] == "full" and suite["smoke"] is True
    assert suite["failures"] == []
    assert suite["device"]["platform"] == "cpu"
    peaks = suite["mfu_model"]["peaks_assumed"]
    assert peaks["f32_no_tensor_cores"] == 67e12 and peaks["bf16_dense"] == 989e12
    for key in ("multimodal_bf16", "demo_latency", "train", "train_phases", "regressions"):
        assert key in suite and "error" not in suite[key], key
    assert [(r["dtype"], r["batch"]) for r in suite["train"]] == [
        ("f32", 8), ("bf16", 8), ("bf16", 8), ("bf16", 8)]
    assert [r["batch"] for r in suite["train_phases"]] == [8, 8]
    assert suite["multimodal_bf16"]["parity_ok"] is True
    assert suite["multimodal_bf16"]["parity_gate"]["tol"] == 5e-3


def test_every_inference_row_is_parity_gated(full_run):
    _, suite = full_run
    rows = suite["inference"]["rows"]
    assert [(r["path"], r["dtype"]) for r in rows] == [
        (p, d) for p, _, d, _ in FULL_TABLE]  # every batch shrinks to 8 under the smoke
    for r in rows:
        assert r["batch"] == 8 and "error" not in r
        # the int8 row is gated at the battery's max (bench.py:385, 413-418)
        gate = ({"name": "battery_max", "tol": 4e-2} if r["path"] == "int8"
                else {"name": "demo_pack_parity", "tol": 5e-3})
        assert r["parity_ok"] is True and r["prob_err"] <= gate["tol"]
        assert r["parity_gate"] == gate
    hybrid = [r for r in rows if r["path"] == "hybrid"]
    assert len(hybrid) == 1 and hybrid[0]["dtype"] == "bf16"


def test_full_table_matches_the_reference(monkeypatch):
    """The ``--full`` configurations of ``bench_inference`` (bench.py:346-368);
    headline mode runs the rows that can win on the card, ``bf16_act`` at
    16384 and the hybrid engine at 8192 (the int8 row, bench.py's headline
    on the TPU, loses on the H100 and runs under ``--full`` alone)."""
    monkeypatch.setattr(bench, "SMOKE", False)
    assert bench.inference_configs(True) == FULL_TABLE
    assert bench.inference_configs(False) == [("framework", "default", "bf16_act", [16384]),
                                              ("hybrid", "default", "bf16", [8192])]


def test_multimodal_int8_row_is_battery_gated(full_run):
    """The multimodal int8 row (bench.py:430, 488-492): gated at 4e-2, named battery_max."""
    mm = full_run[1]["multimodal_int8"]
    assert "error" not in mm and mm["precision"] == "int8" and mm["parity_ok"] is True
    assert mm["parity_gate"] == {"name": "battery_max", "tol": 4e-2}
    assert mm["prob_err"] <= 4e-2 and mm["rps"] > 0


def test_ceiling_decomposes_the_shipping_int8_model(full_run):
    """bench_ceiling (bench.py:901): six parts, each bounded by the H100's
    data-sheet peaks (no TPU rate) at or below its measurement, and that
    bound ratcheted to the measurement beside it."""
    ceil = full_run[1]["ceiling"]
    assert "error" not in ceil
    assert ceil["config"]["int8_layers"] == [3]
    assert [r["block"] for r in ceil["blocks"]] == [
        "zscore", "block0", "block1", "block2", "block3", "tail"]
    for r in ceil["blocks"]:
        assert r["ratcheted_bound_us"] == min(r["bound_us"], r["measured_us"])
        assert r["bound_kind"] in ("compute", "memory")
        if r["block"].startswith("block"):  # a conv block's time is no prefix-difference noise
            assert 0 < r["bound_us"] <= r["measured_us"], r
    assert sum(r["bound_us"] for r in ceil["blocks"]) <= sum(
        r["measured_us"] for r in ceil["blocks"])
    assert ceil["ceiling_rps"] >= ceil["analytic_ceiling_rps"] > 0
    assert ceil["peaks_assumed"]["int8_dense_tops"] == 1979.0
    assert ceil["peaks_assumed"]["bf16_dense_tflops"] == 989.0
    assert ceil["ceiling_rps"] >= ceil["decomposition_rps"] > 0


def test_ceiling_times_each_block_directly():
    """``bench_ceiling`` at a small batch in this process: each of the six
    parts is timed alone on its own stored input, so every ``measured_us`` is
    a positive time, not a difference of two; ``decomposition_check`` puts
    their sum beside one whole forward."""
    ceil = bench.bench_ceiling(bench.Clock(torch.device("cpu")), batch_size=4, iters=1)
    assert ceil["config"]["batch"] == 4 and ceil["config"]["rounds"] == bench.CEIL_ROUNDS
    assert [r["block"] for r in ceil["blocks"]] == [
        "zscore", "block0", "block1", "block2", "block3", "tail"]
    assert all(r["measured_us"] > 0 for r in ceil["blocks"]), ceil["blocks"]
    assert ceil["config"]["decomposition_check"] > 0
    assert ceil["decomposition_rps"] == pytest.approx(
        1e6 / sum(r["measured_us"] for r in ceil["blocks"]))


def test_regression_gate_against_a_prior_sidecar(full_run, tmp_path):
    _, suite = full_run
    prior = json.loads(json.dumps(suite))
    for r in prior["inference"]["rows"]:
        if r["path"] == "hybrid":
            r["rps"] *= 2.0  # the prior run was twice as fast on this row
    prior["demo_latency"]["onchip_ms"] /= 2.0  # and twice as quick here
    path = tmp_path / "prior.json"
    path.write_text(json.dumps(prior))
    now = json.loads(json.dumps(suite))
    bench._check_regressions(now, str(path))
    reg = now["regressions"]
    assert reg["threshold_pct"] == 5.0 and reg["baseline_device"] == "cpu"
    assert "inference_hybrid_bf16_bs8_rps" in reg["flagged"]
    assert "demo_onchip_ms" in reg["flagged"]
    rows = {r["row"]: r for r in reg["rows"]}
    assert rows["inference_hybrid_bf16_bs8_rps"]["delta_pct"] == pytest.approx(-50.0)
    assert not rows["headline_rps"]["regressed"]


def test_no_prior_sidecar_is_noted(full_run, tmp_path):
    now = json.loads(json.dumps(full_run[1]))
    bench._check_regressions(now, str(tmp_path / "missing.json"))
    assert now["regressions"]["flagged"] == [] and "no prior sidecar" in now["regressions"]["note"]


def test_failed_row_is_recorded_and_exits_nonzero(monkeypatch, tmp_path, capsys):
    """A row that raises is written to the sidecar with its error; rc 1."""
    real = bench.build_forward

    def build_forward(path, dtype_name, device):
        if path == "hybrid":
            raise RuntimeError("no hybrid engine here")
        return real(path, dtype_name, device)

    monkeypatch.setattr(bench, "SMOKE", True)
    monkeypatch.setattr(bench, "build_forward", build_forward)
    monkeypatch.setattr(bench, "inference_configs", lambda full: [
        ("framework", "highest", "f32", [2]), ("hybrid", "default", "bf16", [2])])
    out = tmp_path / "failed.json"
    assert bench.main(["--device", "cpu", "--out", str(out)]) == 1
    suite = json.loads(out.read_text())
    bad = [r for r in suite["inference"]["rows"] if r["path"] == "hybrid"]
    assert bad and "no hybrid engine here" in bad[0]["error"]
    assert suite["failures"] and suite["headline"]["row"]["path"] == "framework"
    assert json.loads(capsys.readouterr().out.strip()) == suite["headline"]


def test_missed_parity_gate_fails_the_row(monkeypatch, tmp_path):
    """A row outside the 5e-3 demo-pack gate is an error, not a headline."""
    real = bench.build_forward

    def build_forward(path, dtype_name, device):
        fwd = real(path, dtype_name, device)
        return (lambda x: fwd(x) + 0.01) if path == "kernel" else fwd

    monkeypatch.setattr(bench, "SMOKE", True)
    monkeypatch.setattr(bench, "build_forward", build_forward)
    monkeypatch.setattr(bench, "inference_configs", lambda full: [
        ("framework", "highest", "f32", [2]), ("kernel", "highest", "f32", [2])])
    failures = []
    best, rows = bench.bench_inference(False, bench.Clock(torch.device("cpu")), failures)
    assert best["path"] == "framework"
    assert rows[1]["parity_ok"] is False and rows[1]["error"].startswith("parity")
    assert len(failures) == 1


def test_default_device_needs_a_gpu(tmp_path):
    """Without ``--device cpu`` the bench runs on the GPU or raises: no fallback."""
    env = dict(os.environ, PTBXL_TORCH_BENCH_SMOKE="1", PYTHONPATH=HERE, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "ptbxl_torch.bench", "--out",
                        str(tmp_path / "x.json")], cwd=HERE, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0 and "CUDA GPU" in r.stderr
    assert r.stdout.strip() == ""


def test_pipeline_rows_read_the_data_layer(full_run):
    """The three pipeline rows run on the synthetic tree under the smoke (24
    records of [12, 512]): every stage, the thread sweep and the end-to-end
    epoch through the ADC cache and the int16 path; none is regression-gated."""
    _, suite = full_run
    stages, scaling, e2e = suite["pipeline_stages"], suite["host_scaling"], suite["pipeline_e2e"]
    for key in ("host_cold", "host_warm", "host_nocache", "h2d", "h2d_MBps"):
        assert stages[key] > 0, key
    assert stages["reader"] == "adc_cache" and stages["nocache_reader"] == "native"
    assert scaling["rows"] and scaling["method"].startswith("warmup")
    assert scaling["valid"] == (scaling["cpu_count"] > 1)
    assert e2e["rps"] > 0 and e2e["reader"] == "adc_cache" and e2e["emit_adc"] is True
    assert e2e["records"] == 2 * stages["records"]
    assert not any(k.startswith(("pipeline", "host")) for k in bench._extract_perf_keys(suite))
