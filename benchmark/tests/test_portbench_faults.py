"""A run on the host, small, with the timed path broken underneath: the
check has to come out not correct.  Each test skips the look for a card and
drives the rest of a run (set-up, window, check) through ``run_cell``."""

import numpy as np
import pytest

from benchmark import drive, run
from benchmark.kinds import train as train_kind

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
# a cell that is only data: the train mix on the multimodal configuration
BENCH["workloads"].append({"name": "multimodal.train", "config": "multimodal",
                           "traffic": "train", "chips": 1})
next(m for m in BENCH["end_to_end"] if m["name"] == "train_records_per_s")["workloads"].append(
    "multimodal.train")
SMALL = {"config": {"input_length": 256}}
SERVE = {
    "ecgcnn.bulk": {"call_records": 16, "pool_records": 16,
                    "predictor": {"precision": "highest", "engine": "auto", "chunk_size": 8}},
    "ecgcnn.bulk_bf16": {"call_records": 16, "pool_records": 16,
                         "predictor": {"precision": "default", "engine": "auto", "chunk_size": 8}},
    "multimodal.bulk": {"call_records": 16, "pool_records": 16,
                        "predictor": {"precision": "highest", "engine": "auto", "chunk_size": 8}},
}
TRAIN = {"pool_records": 32, "batch": 8}


def _run(name, traffic, seed=3000000017):
    return run.run_cell(BENCH, name, seed, 0.5, False, "cpu", {**SMALL, "traffic": traffic})[0]


@pytest.mark.parametrize("name", sorted(SERVE))
def test_a_sound_serving_run_is_correct(name):
    assert _run(name, SERVE[name])["correct"]


@pytest.mark.parametrize("name", sorted(SERVE))
def test_an_answer_altered_where_it_is_produced_is_not_correct(name, monkeypatch):
    real = drive.Predictor.__call__

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        out[-1, 0] = np.float32(1.0) - out[-1, 0]
        return out

    monkeypatch.setattr(drive.Predictor, "__call__", altered)
    assert not _run(name, SERVE[name])["correct"]


@pytest.mark.parametrize("name", ["ecgcnn.train", "multimodal.train"])
def test_a_sound_train_run_is_correct(name):
    res = _run(name, TRAIN)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["metrics"]["train_records_per_s"]["value"] > 0


def _broken_step(monkeypatch, broken):
    """Every train step the run builds, wrapped by ``broken(step, calls)``."""
    real = train_kind.make_train_step

    def make(*a, **k):
        step, calls = real(*a, **k), []

        def run_step(state, batch):
            calls.append(1)
            return broken(step, len(calls), state, batch)
        return run_step

    monkeypatch.setattr(train_kind, "make_train_step", make)


def _frozen(step, state, batch):
    saved = {n: p.detach().clone() for n, p in state.model.state_dict().items()}
    state, loss = step(state, batch)
    state.model.load_state_dict(saved)
    return state, loss


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    _broken_step(monkeypatch, lambda step, n, state, batch: _frozen(step, state, batch))
    res = _run("ecgcnn.train", TRAIN)
    assert not res["correct"] and res["checks"]["change_gap"]["value"] > 0.5


def test_a_step_that_goes_wrong_after_its_first_calls_is_not_correct(monkeypatch):
    # sound through set-up's checked steps, then frozen: as a step that is
    # captured or cached after its first calls and then trains wrongly
    checked = run.load_json(run.HERE / "traffic" / "train.json")["checked_steps"]
    _broken_step(monkeypatch, lambda step, n, state, batch:
                 step(state, batch) if n <= checked else _frozen(step, state, batch))
    res = _run("ecgcnn.train", TRAIN)
    assert not res["correct"] and res["checks"]["change_gap"]["value"] > 0.5


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    def half(step, n, state, batch):
        h = len(batch["mask"]) // 2
        return step(state, {k: v[:h] for k, v in batch.items()})

    _broken_step(monkeypatch, half)
    res = _run("ecgcnn.train", TRAIN)
    assert not res["correct"], res["checks"]
