"""The plain reference against the port's own paths at a small size on the
host, and the check's numbers on sound and broken runs."""

import numpy as np
import pytest
import torch

from benchmark import drive, run, synth
from benchmark.kinds import train as train_kind
from benchmark.reference import ecg as reference
from ptbxl_torch.inference import Predictor
from ptbxl_torch.models.factory import merge_state
from ptbxl_torch.training.loop import make_train_step
from ptbxl_torch.training.train_state import create_train_state

T = 256


def _cfg(name):
    return dict(run.load_json(run.ROOT / f"benchmark/configs/{name}.json"), input_length=T)


@pytest.mark.parametrize("arch", ["ecgcnn", "multimodal"])
@pytest.mark.parametrize("engine", ["framework", "kernel"])
def test_reference_matches_the_port_forward(arch, engine):
    cfg = _cfg(arch)
    w = synth.weights(cfg["params"], 7, "cpu")
    x = synth.records(9, T, 7, "cpu")
    d = synth.demographics(9, 7, "cpu") if arch == "multimodal" else None
    pred = Predictor(w, arch=arch, engine=engine, device="cpu")
    got = pred(x, d) if d is not None else pred(x)
    ref = reference.probs(w, cfg, x, d).numpy()
    assert np.max(np.abs(got - ref)) < 2e-6
    assert 0.05 < ref.mean() < 0.95  # logits of order one: the sigmoid is not saturated


def test_the_fp8_control_departs_from_the_reference():
    cfg = _cfg("ecgcnn")
    w = synth.weights(cfg["params"], 3, "cpu")
    x = synth.records(8, T, 3, "cpu")
    t = torch.linspace(-3, 3, 1001)
    assert torch.max(torch.abs(reference.fp8(t) - t)) <= 3 * 2.0 ** -4 + 1e-6  # 3 mantissa bits
    gap = (reference.probs(w, cfg, x, precision="fp8") - reference.probs(w, cfg, x)).abs().max()
    assert gap > 1e-3


@pytest.mark.parametrize("arch", ["ecgcnn", "multimodal"])
def test_reference_train_steps_match_the_port_step(arch):
    cfg, tr = _cfg(arch), {"lr": 1.5e-3, "weight_decay": 1e-4, "precision": "highest"}
    w0 = synth.weights(cfg["params"], 5, "cpu")
    x = synth.records(12, T, 5, "cpu")
    y = synth.labels(12, 5, 0.3, 5, "cpu")
    d = synth.demographics(12, 5, "cpu")
    model = train_kind.build_model(cfg, tr["precision"], "cpu")
    merge_state(model, w0, strict=True)
    state = create_train_state(model, tr["lr"], tr["weight_decay"])
    step = make_train_step(multimodal=arch == "multimodal")
    batches = [{"ecg": x[i:i + 4], "y": y[i:i + 4], "demo": d[i:i + 4],
                "mask": np.ones(4, np.float32)} for i in (0, 4, 8)]
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(step(state, b)[1]))
        if i == 0:
            g1 = {k: state.optimizer.state[p]["exp_avg"] / 0.1 for k, p in model.named_parameters()}
    after = {k: v.clone() for k, v in model.state_dict().items() if "num_batches" not in k}
    ref = reference.train_steps(w0, cfg, [{k: torch.as_tensor(b[k]) for k in ("ecg", "y", "demo")}
                                          for b in batches], tr["lr"], tr["weight_decay"])
    gaps = drive.train_gaps((losses, g1, after), ref, w0)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-2


def test_train_gaps_see_a_state_left_unchanged():
    cfg = _cfg("ecgcnn")
    w0 = synth.weights(cfg["params"], 5, "cpu")
    x = torch.as_tensor(synth.records(8, T, 5, "cpu"))
    y = torch.as_tensor(synth.labels(8, 5, 0.3, 5, "cpu"))
    ref = reference.train_steps(w0, cfg, [{"ecg": x, "y": y}] * 3, 1.5e-3, 1e-4)
    unchanged = (ref[0], ref[1], {k: v.clone() for k, v in w0.items()})
    assert drive.train_gaps(unchanged, ref, w0)["change_gap"] == pytest.approx(1.0)
