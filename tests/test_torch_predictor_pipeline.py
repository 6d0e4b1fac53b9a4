"""``Predictor.__call__``'s chunk loop against the serial path it replaced:
each chunk padded as ``benchmark/drive.py::chunk_rows`` says, copied to the
device as it comes, run by ``_forward`` and read back at once.

On the host the loop runs plain tensors; the staging ring (pinned slots, a
side stream, events) runs only on a GPU.  So the host tests also run the ring
with stand-ins for torch's streams and events (``fake_cuda``), which log the
guards in the order they are set, and the ``card`` tests run it for real:
``python -m pytest tests/test_torch_predictor_pipeline.py -m card --noconftest
-q`` on a machine with an NVIDIA GPU."""

import contextlib
import gc
import os
import sys
import threading
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.drive import chunk_rows  # noqa: E402
from ptbxl_torch.inference import Predictor  # noqa: E402
from ptbxl_torch.utils import profiling  # noqa: E402

# the checkpoints of tests/torch_port_common.py, named here: on the card the
# module's namespace package ``tests`` loses to any installed package of that name
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
CKPT_MM = os.path.join(ROOT, "outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz")

T = 128  # any length runs the model (global mean pool); short keeps the CPU quick
CS = 8
ARCHS = ["ecgcnn", "multimodal"]


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's ops on one intra-op thread: the tests run many small
    forwards, which wait on their threads' barriers when the suite's workers
    share the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the staging ring's pinned slots, stream and events")
    return "cuda"


class _Stream:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def wait_event(self, ev):
        self.log.append(("wait", self.name, ev.name))

    def synchronize(self):
        self.log.append(("stream_sync", self.name))


@pytest.fixture
def fake_cuda(monkeypatch):
    """Streams and events that log what waits for what; the work they would
    order runs at once on the host.  Returns the log."""
    log = []
    names = iter(f"{kind}{i}" for i in range(100) for kind in ("copied", "used"))

    class Event:
        def __init__(self):
            self.name = next(names)

        def record(self, stream):
            log.append(("record", stream.name, self.name))

        def synchronize(self):
            log.append(("host_wait", self.name))

    compute = _Stream(log, "compute")
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream(log, "side"))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: compute)
    return log


def _predictor(arch, device="cpu", ring=False, **kw):
    ckpt = CKPT_MM if arch == "multimodal" else CKPT
    p = Predictor.from_checkpoint(ckpt, arch=arch, device=device, **kw)
    p._pipelined = p._pipelined or ring  # on the host only with fake_cuda
    return p


def _inputs(n, t=T, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, t, 12)).astype(np.float32),
            rng.uniform(size=(n, 5)).astype(np.float32)]


def _call(p, arrays):
    return p(*arrays[:2 if p.arch == "multimodal" else 1])


def _chunks(arrays, n, cs):
    """Each chunk's rows padded to its launched rows, and its real rows."""
    for i0, rows in zip(range(0, n, cs), chunk_rows(n, cs)):
        part = [a[i0:i0 + cs] for a in arrays]
        real = part[0].shape[0]
        yield [np.concatenate([a, np.repeat(a[-1:], rows - real, axis=0)]) for a in part], real


def _serial(p, arrays):
    """The serial path: each padded chunk copied as it comes, run by
    ``_forward`` and read back before the next."""
    n, out = arrays[0].shape[0], []
    for part, real in _chunks(arrays, n, p.chunk_size):
        args = [torch.from_numpy(a).to(p.device) for a in part[:2 if p.arch == "multimodal" else 1]]
        out.append(p._forward(*args)[:real].cpu().numpy())
    return np.concatenate(out)


def _traced(fn):
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    got = profiling.spans()
    profiling.clear()
    return out, got


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [3 * CS, 3 * CS + 5, 1, CS - 1])
@pytest.mark.parametrize("ring", [False, True], ids=["host", "ring"])
def test_multi_chunk_call_equals_one_chunk_calls(arch, n, ring, fake_cuda):
    p = _predictor(arch, ring=ring, chunk_size=CS)
    arrays = _inputs(n, seed=n)
    got = _call(p, arrays)
    ones = np.concatenate([_call(p, part)[:real] for part, real in _chunks(arrays, n, CS)])
    assert got.dtype == np.float32 and got.shape == (n, 5)
    assert np.array_equal(got, ones) and np.array_equal(got, _serial(p, arrays))


@pytest.mark.parametrize("ring", [False, True], ids=["host", "ring"])
def test_the_callers_arrays_are_neither_written_nor_kept(ring, fake_cuda):
    p = _predictor("multimodal", ring=ring, chunk_size=CS)
    arrays = _inputs(2 * CS + 3)
    before = [a.copy() for a in arrays]
    refs = [weakref.ref(a) for a in arrays]
    first = _call(p, arrays)
    assert all(np.array_equal(a, b) for a, b in zip(arrays, before))
    assert np.array_equal(_call(p, before), first)
    del arrays
    gc.collect()
    assert [r() for r in refs] == [None, None]


@pytest.mark.parametrize("ring", [False, True], ids=["host", "ring"])
def test_reference_layout_and_negative_strides(ring, fake_cuda):
    p = _predictor("ecgcnn", ring=ring, chunk_size=CS)
    x = _inputs(2 * CS + 1)[0]
    want = p(np.ascontiguousarray(x[::-1]))
    assert np.array_equal(p(x[::-1]), want)
    assert np.array_equal(p(np.ascontiguousarray(x[::-1].transpose(0, 2, 1))), want)
    assert np.array_equal(p(x[::-1][:1]), p(np.ascontiguousarray(x[::-1][:1])))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ring", [False, True], ids=["host", "ring"])
def test_a_call_with_another_length_or_more_rows(arch, ring, fake_cuda):
    """One Predictor across record lengths and call sizes reads what a fresh
    one reads; the ring takes new slots for a new length or more rows."""
    p = _predictor(arch, ring=ring, chunk_size=CS)
    for n, t in ((3, T), (2 * CS + 1, T), (2, T // 2), (CS + 1, T)):
        arrays = _inputs(n, t, seed=t + n)
        assert np.array_equal(_call(p, arrays),
                              _call(_predictor(arch, ring=ring, chunk_size=CS), arrays))
        if ring:
            assert (p._ring.rows, p._ring.shapes) == (max(chunk_rows(n, CS)),
                                                      [(t, 12), (5,)][:1 + (arch == "multimodal")])


def test_ring_guards_each_slot_by_events(fake_cuda):
    """Chunk k in slot k % 2: the host rewrites the pinned slot after the
    slot's last copy, the side stream copies after the slot's last engine,
    the compute stream runs after the copy, and nothing waits for the device
    as a whole."""
    p = _predictor("ecgcnn", ring=True, chunk_size=CS)
    _call(p, _inputs(4 * CS + 1))
    copied, used = ["copied0", "copied1"], ["used0", "used1"]
    want = []
    for k in range(5):
        s = k % 2
        want += [("host_wait", copied[s]), ("wait", "side", used[s]),
                 ("record", "side", copied[s]), ("wait", "compute", copied[s]),
                 ("record", "compute", used[s])]
    assert fake_cuda == want


def test_ring_spans_stage_and_overlap(fake_cuda):
    p = _predictor("multimodal", ring=True, chunk_size=CS)
    n = 3 * CS + 2
    _, got = _traced(lambda: _call(p, _inputs(n)))
    (root,) = [s for s in got if s.name == "predictor.call"]
    row = T * 12 * 4 + 5 * 4
    stage = [s for s in got if s.name == "predictor.stage"]
    h2d = [s for s in got if s.name == "predictor.h2d"]
    assert [s.counts for s in stage] == [{"bytes": CS * row}] * 4
    assert [s.counts for s in h2d] == [{"bytes": CS * row, "overlap": int(k > 0)}
                                       for k in range(4)]
    assert [s.counts["pad_rows"] for s in got if s.name == "predictor.prepare"] == [0, 0, 0, 6]
    assert [s.counts for s in got if s.name == "predictor.d2h"] == [{"bytes": n * 5 * 4}]
    assert all(s.parent == root.id for s in got if s is not root)


def test_host_path_records_no_stage_or_overlap():
    p = _predictor("ecgcnn", chunk_size=CS)
    _, got = _traced(lambda: _call(p, _inputs(2 * CS + 1)))
    assert not [s for s in got if s.name == "predictor.stage"]
    assert all("overlap" not in s.counts for s in got if s.name == "predictor.h2d")
    assert len([s for s in got if s.name == "predictor.d2h"]) == 1


def test_calls_from_threads_take_turns_on_the_ring(fake_cuda):
    """Eight threads share one Predictor's two slots: each call reads its own
    rows back, which a slot rewritten by another call would break."""
    p = _predictor("ecgcnn", ring=True, chunk_size=CS)
    inputs = [_inputs(2 * CS + 1 + i, t=64, seed=i) for i in range(8)]
    want = [_serial(p, a) for a in inputs]
    got = [None] * len(inputs)

    def work(i):
        for _ in range(3):
            got[i] = _call(p, inputs[i])
            if not np.array_equal(got[i], want[i]):
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(inputs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_card_ring_is_bit_identical_to_the_serial_path(arch, precision, card):
    """5 x 512 + 37 records whose chunks differ, at T=5000: a slot rewritten
    before its copy or its engine is done changes some chunk's answers."""
    p = _predictor(arch, device=card, precision=precision)
    arrays = _inputs(5 * 512 + 37, t=5000, seed=11)
    got = _call(p, arrays)
    assert np.array_equal(got, _serial(p, arrays))
    assert np.array_equal(got, np.concatenate(
        [_call(p, part)[:real] for part, real in _chunks(arrays, len(got), 512)]))
    short = [a[:700, :2500] if a.ndim == 3 else a[:700] for a in arrays]
    assert np.array_equal(_call(p, short), _serial(p, short))


@pytest.mark.card
def test_card_ring_overlaps_seven_of_eight_chunks(card):
    p = _predictor("ecgcnn", device=card)
    arrays = _inputs(4096, t=5000, seed=12)
    want = _call(p, arrays)
    got, spans = _traced(lambda: _call(p, arrays))
    assert np.array_equal(got, want)
    stage = [s for s in spans if s.name == "predictor.stage"]
    h2d = [s for s in spans if s.name == "predictor.h2d"]
    assert [s.counts["bytes"] for s in stage] == [512 * 5000 * 12 * 4] * 8
    assert [s.counts["overlap"] for s in h2d] == [0] + [1] * 7
