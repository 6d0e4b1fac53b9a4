"""The readers of the program's spans (``h2d_gbps``, ``step_idle_pct``,
``feed_idle_pct``) on synthetic device events and program spans, and on the
card a traced run: the device events hold no program span, and the readers
read the spans of a real window."""

import threading

import pytest

from benchmark import drive, run
from benchmark.metrics import feed_idle_pct, h2d_gbps, step_idle_pct
from benchmark.trace import DeviceEvent, Profiler, Reduced, Spans
from ptbxl_torch.utils import profiling

MAIN, PRODUCER = 1, 2
READERS = (h2d_gbps, step_idle_pct, feed_idle_pct)
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")


def _span(name, t0, t1, id, parent=0, thread=MAIN, **counts):
    return profiling.Span(name, t0, t1, id, parent, id if not parent else parent, thread, counts)


def _ctx(events, t0=0, t1=1000):
    spans = Spans()
    spans.offset = 0  # the synthetic spans sit on the device events' clock
    w = drive.Window(spans, t0=t0, t1=t1)
    red = Reduced(1e-9 * sum(e.end_ns - e.start_ns for e in events), 0.0, {}, {}, list(events))
    return run.Context({}, {}, w, red, frozenset(), frozenset(), 0.0)


def _kernel(a, b):
    return DeviceEvent("k", a, b, False)


# window [0, 1000) ns; the device busy [0,100) [150,210) [240,300) [400,600) [700,900)
BUSY = [_kernel(0, 100), _kernel(150, 210), _kernel(240, 300), _kernel(400, 600),
        _kernel(700, 900)]
TRAIN = [
    _span("train.step", 90, 500, 1, rows=64),
    _span("train.forward", 95, 200, 2, parent=1),  # holds the gap [100, 150)
    # the gap [210, 240) falls in the step's own time, after forward closed
    _span("train.backward", 250, 480, 3, parent=1),  # holds the gap [300, 400)
    _span("prefetch.wait", 520, 690, 4),  # holds the gap [600, 700)
    # [900, 1000) lies outside every span of the training thread
    _span("prefetch.batch", 880, 1000, 5, thread=PRODUCER),
    _span("prefetch.read", 890, 990, 6, parent=5, thread=PRODUCER),
]


@pytest.fixture
def program(monkeypatch):
    def use(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return use


def test_idle_is_put_down_to_the_innermost_span(program):
    program(TRAIN)
    ctx = _ctx(BUSY)
    assert step_idle_pct.read(ctx) == pytest.approx(100.0 * (50 + 30 + 100) / 1000)
    assert feed_idle_pct.read(ctx) == pytest.approx(100.0 * 100 / 1000)


def test_a_gap_outside_every_span_counts_in_neither(program):
    program(TRAIN)
    only_last_gap = [_kernel(0, 900)]  # idle [900, 1000): the producer's spans alone
    ctx = _ctx(only_last_gap)
    assert step_idle_pct.read(ctx) == 0.0 and feed_idle_pct.read(ctx) == 0.0


def test_a_gap_deep_in_the_backward_counts_for_the_step(program):
    nested = TRAIN[:3] + [_span("inner", 290, 420, 9, parent=3)]
    program(nested)
    ctx = _ctx([_kernel(0, 350), _kernel(360, 1000)])  # one gap, [350, 360)
    assert step_idle_pct.read(ctx) == pytest.approx(1.0)
    assert feed_idle_pct.read(ctx) == 0.0


def test_no_trace_reads_nothing(program):
    program(TRAIN)
    ctx = _ctx(BUSY)._replace(trace=None)
    assert [r.read(ctx) for r in READERS] == [None] * 3


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert [r.read(_ctx(BUSY)) for r in READERS] == [None] * 3


def test_no_train_step_reads_nothing(program):
    program([s for s in TRAIN if not s.name.startswith("train.")])
    assert step_idle_pct.read(_ctx(BUSY)) is None and feed_idle_pct.read(_ctx(BUSY)) is None


def test_h2d_rate_over_the_union_of_host_to_device_copies(program):
    program([_span("predictor.call", 0, 1000, 1, rows=8),
             _span("predictor.h2d", 10, 300, 2, parent=1, bytes=3_000_000_000),
             _span("predictor.h2d", 400, 700, 3, parent=1, bytes=1_000_000_000),
             _span("predictor.h2d", 2000, 2100, 4, bytes=9)])  # after the window
    events = [DeviceEvent("Memcpy HtoD (Pageable -> Device)", 0, 300, True),
              DeviceEvent("Memcpy HtoD (Pageable -> Device)", 200, 500, True),  # overlaps
              DeviceEvent("Memcpy DtoH (Device -> Pageable)", 600, 900, True),
              DeviceEvent("Memcpy HtoD (Pageable -> Device)", 900, 1500, True),  # clipped
              _kernel(500, 600)]
    # 4e9 bytes over [0, 500) and [900, 1000): 600 ns
    assert h2d_gbps.read(_ctx(events)) == pytest.approx(4e9 / 600e-9 / 1e9)


def test_h2d_without_copies_or_spans_reads_nothing(program):
    program([_span("predictor.h2d", 10, 300, 1, bytes=100)])
    assert h2d_gbps.read(_ctx([_kernel(0, 100)])) is None
    program([])
    assert h2d_gbps.read(_ctx([DeviceEvent("Memcpy HtoD", 0, 10, True)])) is None


def test_the_new_metrics_name_their_cells():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    assert per["h2d_gbps.bulk"]["workloads"] == ["ecgcnn.bulk", "multimodal.bulk",
                                                 "ecgcnn.bulk_bf16"]
    assert per["step_idle_pct.train"]["workloads"] == ["ecgcnn.train"]
    assert per["feed_idle_pct.train"]["workloads"] == ["ecgcnn.train"]


@pytest.mark.card
def test_device_events_hold_no_program_span(card):
    """A traced ``Predictor`` call: the device event list that ``busy_s``,
    ``copy_s``, ``idle_pct`` and ``copy_pct`` read holds no event named
    after a program span, while the program recorded its spans."""
    import torch

    from benchmark import synth

    cfg = run.load_json(run.ROOT / "benchmark/configs/ecgcnn.json")
    p = drive.Predictor(synth.weights(cfg["params"], 3000000041, card), device=card,
                        chunk_size=64)
    x = synth.records(130, cfg["input_length"], 3000000041, card)
    p(x)
    torch.cuda.synchronize()
    profiling.clear()
    prof = Profiler()
    prof.start()
    prof.window_start()
    p(x)
    torch.cuda.synchronize()
    events = prof.stop()
    names = {s.name for s in profiling.spans()}
    assert {"predictor.call", "predictor.h2d", "predictor.kernel"} <= names
    assert events and not {e.name for e in events} & names
    assert {s.thread for s in profiling.spans()} == {threading.get_ident()}


@pytest.mark.card
@pytest.mark.parametrize("name,small", [
    ("ecgcnn.bulk", {"call_records": 1024, "pool_records": 1024}),
    ("ecgcnn.train", {"pool_records": 256})])
def test_a_traced_run_reads_the_spans(name, small, card):
    res, _ = run.run_cell(BENCH, name, 3000000043, 2.0, True, card, {"traffic": small})
    m = {k: v["value"] for k, v in res["metrics"].items()}
    if name == "ecgcnn.bulk":
        assert m["h2d_gbps.bulk"] > 0
    else:
        assert 0 < m["step_idle_pct.train"] + m["feed_idle_pct.train"] <= m["idle_pct.train"]
