"""The port's step timer and trace (ptbxl_torch/utils/profiling.py): the JAX
package's cases of tests/test_interpret_extras.py:87-121, the trace under
torch.profiler, and the timer hooked into the train loop
(ptbxl_tpu/training/loop.py:126-159)."""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.training.loop import make_train_step, train_one_epoch  # noqa: E402
from ptbxl_torch.training.train_state import create_train_state  # noqa: E402
from ptbxl_torch.utils.profiling import StepTimer, perf_enabled, trace  # noqa: E402


def test_step_timer():
    t = StepTimer()
    t.start()
    t.stop(100)
    t.start()
    t.stop(50)
    assert t.records == 150
    assert t.records_per_sec > 0
    assert "150 records" in t.report("train")


def test_trace_noop_without_dir(monkeypatch):
    monkeypatch.delenv("PTBXL_TORCH_TRACE", raising=False)
    with trace(None):
        pass  # must not require a profiler session


def test_profiler_trace_writes_artifacts(tmp_path, monkeypatch):
    """PTBXL_TORCH_TRACE=<dir> produces a TensorBoard-loadable torch.profiler trace."""
    d = str(tmp_path / "trace")
    monkeypatch.setenv("PTBXL_TORCH_TRACE", d)
    with trace():
        x = torch.ones((64, 64))
        (x @ x).sum().item()
    files = glob.glob(os.path.join(d, "**", "*"), recursive=True)
    assert any(f.endswith(".pt.trace.json") or f.endswith(".json.gz") for f in files), files


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"ecg": rng.standard_normal((4, 64, 12)).astype(np.float32),
             "y": (rng.uniform(size=(4, 5)) > 0.7).astype(np.float32),
             "mask": np.array([1, 1, 1, 0], np.float32)} for _ in range(n)]


@pytest.mark.parametrize("value,timed", [("1", True), ("0", False), ("", False)])
def test_train_loop_timer(monkeypatch, capsys, value, timed):
    """PTBXL_TORCH_PERF=1 syncs every step and prints the report; the epoch
    loss is the one-step-late loop's, to the bit."""
    def epoch():
        torch.manual_seed(0)
        state = create_train_state(ECGCNN(num_labels=5), 1e-3, 1e-4)
        return train_one_epoch(state, make_train_step(), iter(_batches(3)))[1]

    monkeypatch.delenv("PTBXL_TORCH_PERF", raising=False)
    plain = epoch()
    monkeypatch.setenv("PTBXL_TORCH_PERF", value)
    assert perf_enabled() is timed
    capsys.readouterr()
    got = epoch()
    out = capsys.readouterr().out
    assert got == plain
    assert ("[PERF] train: 9 records in" in out) is timed
