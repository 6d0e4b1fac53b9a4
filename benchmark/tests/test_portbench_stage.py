"""The reader of the program's staging spans (``stage_gbps``) on synthetic
program spans, in the style of ``test_portbench_tracing.py``."""

import pytest

from benchmark import drive, run
from benchmark.metrics import stage_gbps
from benchmark.trace import Reduced, Spans
from ptbxl_torch.utils import profiling

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")


def _span(name, t0, t1, id, parent=0, **counts):
    return profiling.Span(name, t0, t1, id, parent, parent or id, 1, counts)


def _ctx(t0=0, t1=1000):
    w = drive.Window(Spans(), t0=t0, t1=t1)
    return run.Context({}, {}, w, Reduced(0.0, 0.0, {}, {}, []), frozenset(), frozenset(), 0.0)


@pytest.fixture
def program(monkeypatch):
    def use(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return use


def test_stage_rate_over_the_spans_host_seconds(program):
    program([_span("predictor.call", 0, 1000, 1, rows=8),
             _span("predictor.stage", 10, 110, 2, parent=1, bytes=3_000_000_000),
             _span("predictor.h2d", 110, 120, 3, parent=1, bytes=3_000_000_000, overlap=0),
             _span("predictor.stage", 950, 1250, 4, parent=1, bytes=1_000_000_000),  # straddles
             _span("predictor.stage", 2000, 2100, 5, bytes=9)])  # after the window
    # 4e9 bytes over 100 + 300 ns of staging
    assert stage_gbps.read(_ctx()) == pytest.approx(4e9 / 400e-9 / 1e9)


def test_no_stage_spans_read_nothing(program):
    program([_span("predictor.h2d", 10, 300, 1, bytes=100)])  # the parent's serial path
    assert stage_gbps.read(_ctx()) is None
    program([_span("predictor.stage", 2000, 2100, 1, bytes=100)])  # none in the window
    assert stage_gbps.read(_ctx()) is None
    program([_span("predictor.stage", 10, 20, 1, bytes=0)])
    assert stage_gbps.read(_ctx()) is None


def test_no_trace_or_no_spans_read_nothing(program, monkeypatch):
    program([_span("predictor.stage", 10, 110, 1, bytes=100)])
    assert stage_gbps.read(_ctx()._replace(trace=None)) is None
    monkeypatch.delattr(profiling, "spans")
    assert stage_gbps.read(_ctx()) is None


def test_the_metric_names_the_bulk_cells():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    assert per["stage_gbps.bulk"] == {
        "name": "stage_gbps.bulk", "unit": "GB/s", "better": "higher",
        "source": "program_span", "layer": "Serving API", "moves": "records_per_s",
        "workloads": ["ecgcnn.bulk", "multimodal.bulk", "ecgcnn.bulk_bf16"]}
