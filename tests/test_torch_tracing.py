"""The port's spans (ptbxl_torch/utils/profiling.py::span) at their sites:
``Predictor.__call__``'s chunk path, the train step and its epoch loop, and
``device_prefetch``'s two threads.  Spans are recorded only while a
``torch.profiler`` session records, nest by thread, carry the counts the
benchmark's readers read, and change no output."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.drive import chunk_rows  # noqa: E402
from ptbxl_torch.data.pipeline import device_prefetch  # noqa: E402
from ptbxl_torch.inference import Predictor  # noqa: E402
from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.training.loop import make_train_step, train_one_epoch  # noqa: E402
from ptbxl_torch.training.train_state import create_train_state  # noqa: E402
from ptbxl_torch.utils import profiling  # noqa: E402
from tests.torch_port_common import CKPT, CKPT_MM  # noqa: E402

T = 256  # any length runs the model (global mean pool); short keeps the CPU quick
LABELS = 5
ENGINE_SPANS = ("predictor.kernel", "predictor.framework", "predictor.int8")
TRAIN_CHILDREN = {"train.forward", "train.backward", "train.optimizer"}


def _signals(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, T, 12)).astype(np.float32), \
        rng.standard_normal((n, 5)).astype(np.float32)


def _predictor(arch, **kw):
    ckpt = CKPT_MM if arch == "multimodal" else CKPT
    return Predictor.from_checkpoint(ckpt, arch=arch, **{"device": "cpu", **kw})


def _call(p, n, seed=0):
    x, d = _signals(n, seed)
    return p(x, d) if p.arch == "multimodal" else p(x)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"ecg": rng.standard_normal((4, 64, 12)).astype(np.float32),
             "y": (rng.uniform(size=(4, LABELS)) > 0.7).astype(np.float32),
             "mask": np.array([1, 1, 1, 0], np.float32)} for _ in range(n)]


def _epoch(n=2, seed=0):
    torch.manual_seed(seed)
    state = create_train_state(ECGCNN(num_labels=LABELS), 1e-3, 1e-4)
    return train_one_epoch(state, make_train_step(), iter(_batches(n, seed)))[1]


def _traced(fn):
    """(fn's result, the spans it recorded, the profiler) under a CPU session."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = profiling.spans()
    profiling.clear()
    return out, got, prof


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_span_is_a_shared_noop_without_a_session():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("a", rows=1) is profiling.span("b")


@pytest.mark.parametrize("site", ["predictor", "train", "prefetch"])
def test_nothing_recorded_without_a_session(site):
    profiling.clear()
    if site == "predictor":
        _call(_predictor("ecgcnn"), 3)
    elif site == "train":
        _epoch()
    else:
        list(device_prefetch(iter(_batches(3)), device="cpu"))
    assert profiling.spans() == []


def test_span_records_nesting_ids_and_counts():
    def nest():
        with profiling.span("outer", rows=7):
            with profiling.span("inner", bytes=3):
                pass
            with profiling.span("inner"):
                pass
        with profiling.span("outer"):
            pass

    _, got, _ = _traced(nest)
    first, second = _named(got, "outer")
    inner = _named(got, "inner")
    assert first.parent == 0 and first.root == first.id and first.counts == {"rows": 7}
    assert second.root == second.id != first.id
    assert [s.parent for s in inner] == [first.id] * 2
    assert [s.root for s in inner] == [first.id] * 2
    assert inner[0].counts == {"bytes": 3} and inner[1].counts == {}
    for s in inner:
        assert first.start_ns <= s.start_ns <= s.end_ns <= first.end_ns
    assert {s.thread for s in got} == {threading.get_ident()}


@pytest.mark.parametrize("arch", ["ecgcnn", "multimodal"])
def test_predictor_call_spans(arch):
    p = _predictor(arch)
    _, got, _ = _traced(lambda: _call(p, 3))
    (root,) = _named(got, "predictor.call")
    assert root.parent == 0 and root.counts == {"rows": 3}
    children = [s for s in got if s is not root]
    assert {s.name for s in children} == {"predictor.prepare", "predictor.h2d",
                                          "predictor.kernel", "predictor.d2h"}
    for s in children:
        assert s.root == root.id and s.parent == root.id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert _named(got, "predictor.prepare")[0].counts == {"pad_rows": 1}
    demo_bytes = 4 * 5 * 4 if arch == "multimodal" else 0
    assert _named(got, "predictor.h2d")[0].counts == {"bytes": 4 * 12 * T * 4 + demo_bytes}
    assert _named(got, "predictor.kernel")[0].counts == {"rows": 4}
    assert _named(got, "predictor.d2h")[0].counts == {"bytes": 3 * LABELS * 4}


@pytest.mark.parametrize("n", [3, 8, 20])
def test_launched_rows_follow_the_chunk_rule(n):
    """The engine spans' launched rows are the benchmark's ``chunk_rows``, and
    each chunk's padding is its launched rows less its real ones."""
    p = _predictor("ecgcnn", chunk_size=8)
    _, got, _ = _traced(lambda: _call(p, n))
    launched = [s.counts["rows"] for s in got if s.name in ENGINE_SPANS]
    assert launched == chunk_rows(n, 8)
    pads = [s.counts["pad_rows"] for s in _named(got, "predictor.prepare")]
    assert sum(pads) == sum(launched) - n
    assert _named(got, "predictor.call")[0].counts == {"rows": n}


@pytest.mark.parametrize("engine,precision,branch", [
    ("framework", "default", "predictor.framework"), ("auto", "int8", "predictor.int8")])
def test_engine_branch_is_named(engine, precision, branch):
    p = _predictor("ecgcnn", engine=engine, precision=precision)
    _, got, _ = _traced(lambda: _call(p, 5))
    assert [(s.name, s.counts) for s in got if s.name in ENGINE_SPANS] == [(branch, {"rows": 8})]


def test_replica_path_spans():
    p = _predictor("ecgcnn", data_parallel=True, device=["cpu", "cpu"], chunk_size=8)
    _, got, _ = _traced(lambda: _call(p, 3))
    (root,) = _named(got, "predictor.call")
    assert [s.counts for s in _named(got, "predictor.h2d")] == [{"bytes": 2 * 12 * T * 4}] * 2
    assert [s.counts for s in _named(got, "predictor.framework")] == [{"rows": 2}] * 2
    assert _named(got, "predictor.d2h")[0].counts == {"bytes": 4 * LABELS * 4}
    assert all(s.root == root.id for s in got)


def test_train_step_spans():
    _, got, _ = _traced(lambda: _epoch(2))
    steps = _named(got, "train.step")
    # the CPU's convs keep autograd's weight gradient: no kernel's (wgrad 0)
    assert len(steps) == 2 and all(
        s.parent == 0 and s.counts == {"rows": 4, "graph": 0, "wgrad": 0} for s in steps)
    for st in steps:
        kids = [s for s in got if s.parent == st.id]
        assert {s.name for s in kids} == TRAIN_CHILDREN
        assert all(s.root == st.id and st.start_ns <= s.start_ns <= s.end_ns <= st.end_ns
                   for s in kids)
    order = [s.name for s in sorted((s for s in got if s.parent == steps[0].id),
                                    key=lambda s: s.start_ns)]
    assert order == ["train.forward", "train.optimizer", "train.backward", "train.optimizer"]
    settles = _named(got, "train.settle")
    assert len(settles) == 2 and all(s.parent == 0 for s in settles)
    # one step late: the first loss is read after the second step is queued
    assert steps[1].end_ns <= settles[0].start_ns


def test_prefetch_spans_on_both_threads():
    main = threading.get_ident()
    out, got, _ = _traced(lambda: list(device_prefetch(iter(_batches(3)), device="cpu")))
    assert len(out) == 3
    waits = _named(got, "prefetch.wait")
    assert len(waits) == 4 and {s.thread for s in waits} == {main}  # 3 batches and the end
    roots = _named(got, "prefetch.batch")
    assert len(roots) == 4 and all(s.parent == 0 for s in roots)  # the last read finds the end
    assert {s.thread for s in roots} != {main} and len({s.thread for s in roots}) == 1
    for r in roots[:3]:
        kids = [s for s in got if s.parent == r.id]
        assert [s.name for s in kids] == ["prefetch.read", "prefetch.pin"]
        assert all(s.thread == r.thread and s.root == r.id for s in kids)


def test_profiler_events_hold_the_main_thread_spans():
    p = _predictor("ecgcnn", chunk_size=8)

    def work():
        _call(p, 10)
        _epoch(2)

    _, got, prof = _traced(work)
    names = {e.name for e in prof.events()}
    main = {s.name for s in got if s.thread == threading.get_ident()}
    assert {"predictor.call", "predictor.h2d", "train.step", "train.settle"} <= main
    assert main <= names


@pytest.mark.parametrize("arch", ["ecgcnn", "multimodal"])
def test_probabilities_bit_identical_traced(arch):
    p = _predictor(arch, chunk_size=8)
    off = _call(p, 11, seed=3)
    on, got, _ = _traced(lambda: _call(p, 11, seed=3))
    assert got and np.array_equal(on, off)


def test_epoch_loss_bit_identical_traced():
    off = _epoch(3, seed=1)
    on, got, _ = _traced(lambda: _epoch(3, seed=1))
    assert got and on == off
