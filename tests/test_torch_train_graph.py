"""The train step as one CUDA graph (ptbxl_torch/training/loop.py::make_train_step).

On a CUDA device the step runs eager for the first step of a key, captures
itself on the next and replays the graph after.  The host tests hold the
rule that decides it (``graph_key``) with stand-ins, and show that on the
CPU every step runs eager and AdamW is not ``capturable``.  The ``card``
tests hold graph steps to eager steps bit for bit (both with
``capturable=True``) on the card: ``python -m pytest
tests/test_torch_train_graph.py -m card --noconftest -q`` on a machine with an
NVIDIA GPU.  The file imports nothing of JAX.
"""

import hashlib
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from ptbxl_torch.data.pipeline import device_prefetch  # noqa: E402
from ptbxl_torch.models.factory import build_ecgcnn, build_multimodal  # noqa: E402
from ptbxl_torch.ops.kernels import relu_pool as k6  # noqa: E402
from ptbxl_torch.ops.relu_pool import force_framework_pool_bwd  # noqa: E402
from ptbxl_torch.training import loop  # noqa: E402
from ptbxl_torch.training.loop import graph_key, make_train_step, train_one_epoch  # noqa: E402
from ptbxl_torch.training.train_state import TrainState, create_train_state  # noqa: E402
from ptbxl_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["ecgcnn", "multimodal"]
LR, WD = 1.5e-3, 1e-4  # the ecgcnn.train cell's
B, T = 64, 5000  # the ecgcnn.train cell's batch at full length on the card
CPU_B, CPU_T = 4, 64


# -- the key, with stand-ins -----------------------------------------------------

def _stand_ins(device="cuda", capturable=True):
    """(state, batch on the device) of stand-ins: what ``graph_key`` reads."""
    params = [_Memory(device=torch.device(device), requires_grad=True) for _ in range(3)]
    buffers = [_Memory(), _Memory()]
    model = SimpleNamespace(parameters=lambda: iter(params), buffers=lambda: iter(buffers),
                            precision="highest")
    group = {"params": params, "lr": LR, "betas": (0.9, 0.999), "eps": 1e-8,
             "weight_decay": WD, "capturable": capturable}
    opt = SimpleNamespace(param_groups=[group], state={
        p: {"step": _Memory(), "exp_avg": _Memory(), "exp_avg_sq": _Memory()} for p in params})
    batch = {k: SimpleNamespace(shape=s, dtype=torch.float32, device=torch.device("cuda", 0))
             for k, s in (("ecg", (B, T, 12)), ("y", (B, 5)), ("mask", (B,)))}
    return TrainState(model=model, optimizer=opt), batch


class _Memory:
    """A stand-in for a tensor: its memory at an address of its own."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def data_ptr(self):
        return id(self)


def test_stand_ins_have_a_key():
    state, batch = _stand_ins()
    key = graph_key(state, batch)
    assert key is not None and key == graph_key(state, dict(batch))
    state.step = 7  # the step count is no part of what a graph bakes in
    assert graph_key(state, batch) == key


INELIGIBLE = {
    "scheduler": lambda s, b: setattr(s, "scheduler", object()),
    "no_optimizer": lambda s, b: setattr(s, "optimizer", None),
    "a_cpu_parameter": lambda s, b: setattr(next(s.model.parameters()), "device",
                                            torch.device("cpu")),
    "not_capturable": lambda s, b: s.optimizer.param_groups[0].update(capturable=False),
}


@pytest.mark.parametrize("case", sorted(INELIGIBLE))
def test_steps_that_always_run_eager_have_no_key(case):
    state, batch = _stand_ins()
    INELIGIBLE[case](state, batch)
    assert graph_key(state, batch) is None


def _group(s):
    return s.optimizer.param_groups[0]


CHANGES = {
    "lr": lambda s, b: _group(s).update(lr=LR / 2),
    "betas": lambda s, b: _group(s).update(betas=(0.8, 0.999)),
    "eps": lambda s, b: _group(s).update(eps=1e-6),
    "weight_decay": lambda s, b: _group(s).update(weight_decay=0.0),
    "requires_grad": lambda s, b: setattr(_group(s)["params"][1], "requires_grad", False),
    "a_parameter_replaced": lambda s, b: _group(s)["params"].__setitem__(
        2, _Memory(device=torch.device("cuda"), requires_grad=True)),
    "a_parameter_moved": lambda s, b: setattr(
        _group(s)["params"][0], "data_ptr", lambda: 0),
    "a_buffer_moved": lambda s, b: setattr(next(s.model.buffers()), "data_ptr", lambda: 0),
    "optimizer_state_replaced": lambda s, b: s.optimizer.state[
        _group(s)["params"][1]].update(exp_avg=_Memory()),
    "optimizer_state_empty": lambda s, b: s.optimizer.state.clear(),
    "model": lambda s, b: setattr(s, "model", SimpleNamespace(
        parameters=s.model.parameters, buffers=s.model.buffers, precision="highest")),
    "optimizer": lambda s, b: setattr(s, "optimizer", SimpleNamespace(
        param_groups=s.optimizer.param_groups, state=s.optimizer.state)),
    "precision": lambda s, b: setattr(s.model, "precision", "default"),
    "batch_shape": lambda s, b: setattr(b["ecg"], "shape", (B // 2, T, 12)),
    "batch_dtype": lambda s, b: setattr(b["ecg"], "dtype", torch.bfloat16),
    "batch_device": lambda s, b: setattr(b["y"], "device", torch.device("cuda", 1)),
    "batch_keys": lambda s, b: b.update(demo=SimpleNamespace(
        shape=(B, 5), dtype=torch.float32, device=torch.device("cuda", 0))),
}


@pytest.mark.parametrize("case", sorted(CHANGES))
def test_the_key_changes_with_what_the_graph_bakes_in(case):
    state, batch = _stand_ins()
    before = graph_key(state, batch)
    CHANGES[case](state, batch)
    after = graph_key(state, batch)
    assert after is not None and after != before


def test_the_key_holds_the_forced_framework_pool_backward():
    state, batch = _stand_ins()
    before = graph_key(state, batch)
    with force_framework_pool_bwd():
        assert graph_key(state, batch) != before
    assert graph_key(state, batch) == before


# -- the CPU: every step eager ---------------------------------------------------

def _model(arch, device, seed=0):
    build = build_multimodal if arch == "multimodal" else build_ecgcnn
    return build(num_labels=5, seed=seed, device=device)


def _batches(n, arch, bs, t, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"ecg": rng.standard_normal((bs, t, 12)).astype(np.float32),
             "y": (rng.uniform(size=(bs, 5)) < 0.3).astype(np.float32),
             "mask": np.concatenate([np.ones(bs - 1), np.zeros(1)]).astype(np.float32)}
        if arch == "multimodal":
            b["demo"] = rng.standard_normal((bs, 5)).astype(np.float32)
        out.append(b)
    return out


def _traced_steps(fn):
    """(fn's result, each train.step's ``graph``, the number of train.capture spans)."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    got = profiling.spans()
    profiling.clear()
    steps = sorted((s for s in got if s.name == "train.step"), key=lambda s: s.start_ns)
    return out, [s.counts["graph"] for s in steps], sum(s.name == "train.capture" for s in got)


@pytest.fixture
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_steps_run_eager(arch, one_thread):
    state = create_train_state(_model(arch, "cpu"), LR, WD)
    step = make_train_step(multimodal=arch == "multimodal")
    batches = _batches(4, arch, CPU_B, CPU_T)
    _, graphs, captures = _traced_steps(lambda: [step(state, b) for b in batches])
    assert graphs == [0, 0, 0, 0] and captures == 0
    assert state.step == 4


@pytest.mark.parametrize("check_numerics", [False, True])
def test_check_numerics_never_asks_for_a_key(check_numerics, monkeypatch, one_thread):
    """Eligibility fixed when the step is made: a step with ``check_numerics``
    runs eager without asking ``graph_key``."""
    asked = []
    monkeypatch.setattr(loop, "graph_key", lambda *a: asked.append(a) or None)
    state = create_train_state(_model("ecgcnn", "cpu"), LR, WD)
    step = make_train_step(check_numerics=check_numerics)
    for b in _batches(2, "ecgcnn", CPU_B, CPU_T):
        step(state, b)
    assert len(asked) == (0 if check_numerics else 2) and state.step == 2


def test_make_optimizer_leaves_capturable_off_for_cpu_parameters():
    state = create_train_state(_model("ecgcnn", "cpu"), LR, WD)
    assert [g["capturable"] for g in state.optimizer.param_groups] == [False]
    meta = create_train_state(torch.nn.Linear(3, 2, device="meta"), LR, WD)
    assert [g["capturable"] for g in meta.optimizer.param_groups] == [False]


# -- the card: graph steps against eager steps -----------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs")
    return "cuda"


def _on_card(batches):
    return [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in batches]


def _snapshot(state):
    """Parameters, BatchNorm buffers and AdamW's state, copied."""
    out = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            out[f"adamw.{i}.{k}"] = v.detach().clone()
    return out


def _assert_bit_equal(got, want):
    assert got.keys() == want.keys()
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, f"not bit-equal: {bad}"


def _run(arch, batches, eager=False, state=None, step=None):
    """The batches through one step function: (losses read after the last
    step, each step's ``graph``, the captures, the state).  ``eager``: a step
    with ``check_numerics``, which never captures and changes no number."""
    state = state or create_train_state(_model(arch, "cuda"), LR, WD)
    step = step or make_train_step(multimodal=arch == "multimodal", check_numerics=eager)
    losses, graphs, captures = _traced_steps(lambda: [step(state, b)[1] for b in batches])
    return [float(x) for x in losses], graphs, captures, state


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_card_graph_steps_equal_eager_steps(arch, card):
    batches = _on_card(_batches(6, arch, B, T, seed=1))
    losses, graphs, captures, state = _run(arch, batches)
    want, eager_graphs, _, ref = _run(arch, batches, eager=True)
    assert all(g["capturable"] for g in state.optimizer.param_groups)
    assert all(g["capturable"] for g in ref.optimizer.param_groups)
    # a fresh AdamW makes its state on the first step, so the key settles on the second
    assert graphs == [0, 0, 1, 1, 1, 1] and captures == 1
    assert eager_graphs == [0] * 6
    assert losses == want and len(set(losses)) == 6  # each its own step's, read late
    _assert_bit_equal(_snapshot(state), _snapshot(ref))


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_card_replays_launch_k6_from_the_card(arch, card):
    """K6's wrapper launches on the two eager steps and into the capture; a
    replay launches the captured four from the card, which only the device
    trace sees."""
    batches = _on_card(_batches(6, arch, B, T, seed=1))
    state = create_train_state(_model(arch, "cuda"), LR, WD)
    step = make_train_step(multimodal=arch == "multimodal")
    k6.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
    on_trace = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "relu_pool_bwd" in e.name)
    assert k6.launches == 4 * 3
    assert on_trace == 4 * 6


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_card_replayed_wgrad_kernel_equals_eager_steps(arch, card):
    """The f32 step's four conv weight gradients come from the hand-written
    kernel (ops/conv_wgrad.py) on eager steps, in the capture and in every
    replay: each ``train.step`` span counts 4 (a replay its capture's), the
    device trace holds the kernel four times a step, and the graph steps equal
    eager ones bit for bit."""
    batches = _on_card(_batches(6, arch, B, T, seed=8))
    state = create_train_state(_model(arch, "cuda"), LR, WD)
    step = make_train_step(multimodal=arch == "multimodal")
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        losses = [step(state, b)[1] for b in batches]
        torch.cuda.synchronize()
    steps = sorted((s for s in profiling.spans() if s.name == "train.step"),
                   key=lambda s: s.start_ns)
    profiling.clear()
    on_trace = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "conv_wgrad_kernel" in e.name)
    assert [s.counts["graph"] for s in steps] == [0, 0, 1, 1, 1, 1]
    assert [s.counts["wgrad"] for s in steps] == [4] * 6
    assert on_trace == 4 * 6
    want, _, _, ref = _run(arch, batches, eager=True)
    assert [float(x) for x in losses] == want
    _assert_bit_equal(_snapshot(state), _snapshot(ref))


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_card_epoch_through_the_feed_equals_eager(arch, card):
    """``train_one_epoch`` (each loss read one step late) fed by
    ``device_prefetch``, whose producer thread pins and copies while the
    step captures."""
    host = _batches(6, arch, B, T, seed=2)

    def epoch(eager):
        state = create_train_state(_model(arch, "cuda"), LR, WD)
        step = make_train_step(multimodal=arch == "multimodal", check_numerics=eager)
        _, loss = train_one_epoch(state, step, device_prefetch(iter(host), "cuda"))
        return loss, _snapshot(state)

    got, want = epoch(False), epoch(True)
    assert got[0] == want[0]
    _assert_bit_equal(got[1], want[1])


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_card_reset_in_place_replays_the_first_run(arch, card):
    """The benchmark's ``finish``: the model and AdamW set back in place, the
    same batches again, through the same step (now every step a replay)."""
    batches = _on_card(_batches(3, arch, B, T, seed=3))
    state = create_train_state(_model(arch, "cuda"), LR, WD)
    step = make_train_step(multimodal=arch == "multimodal")
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    first, graphs, _, _ = _run(arch, batches, state=state, step=step)
    after = _snapshot(state)
    with torch.no_grad():
        for k, v in state.model.state_dict().items():
            v.copy_(init[k])
        for st in state.optimizer.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    v.zero_()
    state.step = 0
    again, graphs_again, captures, _ = _run(arch, batches, state=state, step=step)
    assert graphs == [0, 0, 1] and graphs_again == [1, 1, 1] and captures == 0
    assert again == first
    _assert_bit_equal(_snapshot(state), after)


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_card_another_shape_runs_eager(arch, card):
    big = _on_card(_batches(4, arch, B, T, seed=4))
    small = _on_card(_batches(2, arch, B // 2, T, seed=5))
    batches = big[:3] + small + big[3:]
    losses, graphs, captures, state = _run(arch, batches)
    want, _, _, ref = _run(arch, batches, eager=True)
    # the small key is captured on its second step; the big one, back, runs eager
    assert graphs == [0, 0, 1, 0, 1, 0] and captures == 2
    assert losses == want
    _assert_bit_equal(_snapshot(state), _snapshot(ref))


@pytest.mark.card
@pytest.mark.parametrize("case", ["scheduler", "check_numerics"])
def test_card_scheduler_or_check_numerics_runs_eager(case, card):
    batches = _on_card(_batches(4, "ecgcnn", B, T, seed=6))
    state = create_train_state(_model("ecgcnn", "cuda"), LR, WD,
                               warmup_steps=2 if case == "scheduler" else 0)
    step = make_train_step(check_numerics=case == "check_numerics")
    losses, graphs, captures, _ = _run("ecgcnn", batches, state=state, step=step)
    assert graphs == [0] * 4 and captures == 0
    assert np.isfinite(losses).all()


@pytest.mark.card
def test_card_a_late_read_waits_for_its_own_step_alone(card):
    """``train_one_epoch`` reads step 1's loss after step 2 is queued; the
    read ends when step 1 is done, not when the stream holding step 2 is."""
    def slow_step(state, batch):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock
        return state, batch["mask"].mean() * 0.5

    batches = [{"mask": torch.ones(4, device="cuda")} for _ in range(2)]
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter_ns()
        _, loss = train_one_epoch(TrainState(model=None), slow_step, iter(batches))
        t1 = time.perf_counter_ns()
    settles = sorted((s for s in profiling.spans() if s.name == "train.settle"),
                     key=lambda s: s.start_ns)
    profiling.clear()
    assert loss == 0.5 and len(settles) == 2
    assert settles[0].end_ns - t0 < 0.75 * (t1 - t0)  # about half: step 1 of two


def _digest(arch: str) -> str:
    """sha256 of six graph steps' losses and the state after, from seed 0."""
    losses, graphs, _, state = _run(arch, _on_card(_batches(6, arch, B, T, seed=7)))
    assert graphs == [0, 0, 1, 1, 1, 1]
    h = hashlib.sha256(np.asarray(losses, np.float64).tobytes())
    for k, v in sorted(_snapshot(state).items()):
        h.update(k.encode())
        h.update(v.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_card_second_process_repeats_bit_for_bit(arch, card):
    here = _digest(arch)
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, os.path.abspath(__file__), arch], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split()[-1] == here


if __name__ == "__main__":  # the second process of the test above
    print(_digest(sys.argv[1]))
