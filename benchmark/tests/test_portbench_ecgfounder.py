"""The ``ecgfounder`` configuration's pieces of the benchmark: the cell run
small on the host through ``run_cell``'s ``overrides`` (sound, then with a
planted fault in the timed path), its operation counts against hand counts,
the roofline reader on synthetic windows, and the traffic's limit."""

import math

import pytest

from benchmark import drive, roofline, roofline_ecgfounder, run
from benchmark.kinds import closed_ecgfounder
from benchmark.metrics import ecgfounder_roofline
from benchmark.reference import ecgfounder as reference
from benchmark.trace import Reduced, Spans
from ptbxl_torch.models import ecgfounder as program
from ptbxl_torch.utils import profiling

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CFG = run.load_json(run.ROOT / "benchmark/configs/ecgfounder.json")
CELL = "ecgfounder.bulk_bf16"
SMALL = {"base_filters": 16, "filter_list": [16, 32, 48], "m_blocks_list": [2, 1, 2],
         "num_labels": 6}
OVERRIDES = {
    "config": {**SMALL, "params": reference.param_shapes({**CFG, **SMALL})},
    "traffic": {"call_records": 16, "pool_records": 16,
                "predictor": {"precision": "default", "engine": "auto", "chunk_size": 8}},
}


def _run():
    return run.run_cell(BENCH, CELL, 3000000029, 0.5, False, "cpu", OVERRIDES)[0]


def test_the_configuration_is_the_published_widths():
    entry = next(c for c in BENCH["configs"] if c["name"] == "ecgfounder")
    assert entry["reduced"] == [] and CFG["source"] == entry["source"]
    assert {k: CFG[k] for k in ("arch", "input_length", "leads", "base_filters", "filter_list",
                                "m_blocks_list", "kernel_size", "stride", "groups_width",
                                "ratio", "se_reduction", "num_labels")} == {
        "arch": "ecgfounder", "input_length": 5000, "leads": 12, "base_filters": 64,
        "filter_list": [64, 160, 160, 400, 400, 1024, 1024],
        "m_blocks_list": [2, 2, 2, 3, 3, 4, 4], "kernel_size": 16, "stride": 2,
        "groups_width": 16, "ratio": 1, "se_reduction": 2, "num_labels": 150}
    assert CFG["params"] == [[k, s] for k, s in reference.param_shapes(CFG)]
    assert roofline.param_count(CFG) == 30_752_646


def test_the_configuration_params_build_the_model():
    import torch

    with torch.device("meta"):
        state = {k: torch.empty(s) for k, s in CFG["params"]}
        model = program.Net1D(**program.widths(state))
    assert {k: list(v.shape) for k, v in model.state_dict().items()} == dict(
        (k, s) for k, s in CFG["params"])


def test_the_traffic_has_a_limit_and_a_control():
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "ecgfounder"
    traffic = run.cell_files(BENCH, CELL)[2]
    assert traffic["kind"] == "closed_ecgfounder" and traffic["control"] == "fp8"
    assert 0 < traffic["limits"]["max_prob_gap"] < 1
    assert traffic["predictor"] == {"precision": "default", "engine": "auto", "chunk_size": 512}
    assert traffic["call_records"] == traffic["pool_records"] == 4096


def test_the_window_counts_net1d_operations():
    import torch

    cell, cfg, traffic = run.cell_files(BENCH, CELL)
    cfg.update(OVERRIDES["config"])
    traffic.update(OVERRIDES["traffic"])
    load = closed_ecgfounder.Load(cfg, traffic, 3000000031, "cpu")
    load.setup()
    w = drive.Window(Spans())
    with torch.no_grad():
        load.window(0.2, w, lambda: None)
    assert w.records == 16 * w.attempted > 0 and w.launched == [8, 8] * w.attempted
    assert w.flops == roofline_ecgfounder.forward_flops(cfg, w.records)
    assert closed_ecgfounder.closed.roofline is roofline  # the CNN's yardstick is back
    c = load.control()
    assert 0 < c["max_prob_gap"] < 1 and 0 <= c["live_share"] <= 1


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["metrics"]["records_per_s"]["value"] > 0


def _gate_left_out(monkeypatch):
    monkeypatch.setattr(program.Block, "gate", lambda self, out, dtype: out[:, 0] * 0 + 1)


def _shortcut_left_out(monkeypatch):
    monkeypatch.setattr(program.Block, "shortcut", lambda self, x: x.new_zeros(()))


# A one-sample shift of the k=16 convs' pads (8 | 7 for 7 | 8) or a skipped
# last block moves these small seeded models' probabilities by 5e-3 to 2e-2,
# not surely past the bf16 limit: the CPU tests hold the pads to the f32
# tolerance (tests/test_torch_ecgfounder.py).
@pytest.mark.parametrize("fault", [_gate_left_out, _shortcut_left_out],
                         ids=["no_gate", "no_shortcut"])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]


def test_forward_flops_at_the_published_widths():
    hand, t, cin = 2 * 64 * 12 * 16 * 2500, 2500, 64
    for c, m in zip(CFG["filter_list"], CFG["m_blocks_list"]):
        for j in range(m):
            t_out = math.ceil(t / 2) if j == 0 else t
            c_in = cin if j == 0 else c
            hand += 2 * c * c_in * t + 2 * c * 16 * 16 * t_out + 2 * c * c * t_out
            hand += 2 * c * (c // 2) * 2
            t = t_out
        cin = c
    hand += 2 * 1024 * 150
    assert hand == 2_337_282_560
    assert roofline_ecgfounder.forward_flops(CFG, 1) == hand
    assert roofline_ecgfounder.forward_flops(CFG, 512) == 512 * hand
    by = roofline_ecgfounder.flops_by_kind(CFG)
    assert by["conv1x1"] == 1_750_187_520 and by["grouped"] == 506_429_440
    assert sum(by.values()) == hand


def test_bytes_and_bound():
    assert roofline_ecgfounder.activation_elements(CFG) * 2 == 4_675_520
    b = roofline_ecgfounder.bound_s(CFG, 512, 2)
    # at B=512 a forward is bound by its operations: 1.21 ms against 0.75 ms
    assert b == pytest.approx(512 * 2_337_282_560 / roofline.PEAK_FLOPS)
    assert roofline_ecgfounder.forward_bytes(CFG, 512, 2) / roofline.PEAK_BYTES < b


def _ctx(by_kernel, precision="default"):
    spans = Spans()
    spans.offset = 0
    w = drive.Window(spans, t0=0, t1=1000)
    red = Reduced(1e-6, 0.0, by_kernel, {}, [])
    return run.Context(CFG, {"predictor": {"precision": precision}}, w, red, frozenset(),
                       frozenset(), 0.0)


BY_KERNEL = {"sm90_xmma_fprop_implicit_gemm_bf16": (40, 0.010), "nvjet_gemm": (80, 0.012),
             "Memcpy HtoD (Pinned -> Device)": (2, 0.5)}


def test_the_reader_reads_nothing_without_spans(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert ecgfounder_roofline.read(_ctx(BY_KERNEL)) is None
    none = _ctx(BY_KERNEL)._replace(trace=None)
    assert ecgfounder_roofline.read(none) is None


def test_the_reader_on_a_window_with_spans(monkeypatch):
    # two chunks of 512 rows, each an encoder span holding 7 stage spans
    spans = [profiling.Span("ecgfounder.encoder", 200 * c, 200 * c + 190, 100 + c, 0, 100 + c,
                            1, {"rows": 512, "samples": 512 * 5000}) for c in range(2)]
    spans += [profiling.Span("ecgfounder.stage", 10 * i, 10 * i + 5, i + 1, 100 + i // 7,
                             100 + i // 7, 1, {"rows": 512, "channels": 64, "length": 1250,
                                               "blocks": 2}) for i in range(14)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    bound = 2 * roofline_ecgfounder.bound_s(CFG, 512, 2)
    assert ecgfounder_roofline.read(_ctx(BY_KERNEL)) == pytest.approx(100.0 * bound / 0.022)
    hi = 2 * roofline_ecgfounder.bound_s(CFG, 512, 4)
    assert ecgfounder_roofline.read(_ctx(BY_KERNEL, "highest")) == pytest.approx(
        100.0 * hi / 0.022)
    assert ecgfounder_roofline.read(_ctx({"Memcpy HtoD (Pinned -> Device)": (2, 0.5)})) is None
