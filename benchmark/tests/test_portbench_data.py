"""BENCHMARK.json against the contract's shape, and every cell, configuration,
mix and metric reader found by name from data."""

import importlib
import json
import re

import pytest

from benchmark import drive, run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    names = [e["name"] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for e in BENCH[section]:
        assert set(e) <= allowed[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")


def test_every_cell_finds_its_files_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell, cfg, traffic = run.cell_files(BENCH, w["name"])
        assert cfg["name"] == w["config"] and callable(drive.kind(traffic["kind"]))
        assert set(traffic["limits"]) and traffic["control"] in ("tf32", "fp8")
        reported = run.cell_metrics(BENCH, cell, False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        per_layer = run.cell_metrics(BENCH, cell, True)
        assert per_layer, w["name"]
        assert all(m["moves"] in {r["name"] for r in reported} for m in per_layer)
        assert all(m["moves"] in e2e for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    mod = importlib.import_module(f"benchmark.metrics.{metric.split('.')[0]}")
    assert callable(mod.read)


def test_configs_are_the_published_widths():
    for c in BENCH["configs"]:
        cfg = run.load_json(run.ROOT / c["file"])
        assert c["reduced"] == [] and cfg["source"] == c["source"]
        assert cfg["channels"] == [32, 64, 128, 256] and cfg["input_length"] == 5000
        assert cfg["kernel_size"] == 15 and cfg["feat_dim"] == 256 and cfg["num_labels"] == 5


def test_kernel_engine_names_are_data():
    kernels, ends = run.engine_kernels()
    assert "tf32x3_conv_block_kernel" in kernels and ends <= kernels
