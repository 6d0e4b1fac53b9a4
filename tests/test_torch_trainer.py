"""The port's trainer (ptbxl_torch/training/trainer.py) and checkpoint writers
(ptbxl_torch/models/params_io.py, factory.merge_backbone) against ptbxl_tpu's.

Both trainers run on one in-memory dataset (read through ``get_raw``, as the
JAX ``BatchSource`` reads a dataset without an ADC cache); per-epoch losses
agree at rtol 5e-3 (the 50-step tolerance of test_train_parity_torch.py).
"""

import csv
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.models.factory import build_multimodal as jax_build_multimodal  # noqa: E402
from ptbxl_tpu.models.factory import merge_backbone as jax_merge_backbone  # noqa: E402
from ptbxl_tpu.models.params_io import (  # noqa: E402
    load_checkpoint as jax_load_checkpoint,
    load_npz as jax_load_npz,
    read_pth as jax_read_pth,
    torch_to_flax_ecgcnn,
    torch_to_flax_multimodal,
)
from ptbxl_tpu.training.trainer import TrainRun as JaxTrainRun  # noqa: E402
from ptbxl_tpu.training.trainer import train as jax_train  # noqa: E402
from ptbxl_tpu.utils.csv_log import EPOCH_CSV_HEADER  # noqa: E402

import ptbxl_torch.training.trainer as trainer_mod  # noqa: E402
from ptbxl_torch.inference import Predictor  # noqa: E402
from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.models.ecg_multimodal import ECGMultimodal  # noqa: E402
from ptbxl_torch.models.factory import merge_backbone  # noqa: E402
from ptbxl_torch.models.params_io import (  # noqa: E402
    export_pth,
    from_flax_variables,
    load_checkpoint,
    read_pth,
    save_npz,
    to_flax_variables,
)
from ptbxl_torch.training.trainer import TrainRun, train  # noqa: E402
from tests.torch_port_common import CKPT, InMemoryECG  # noqa: E402

CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]
T = 256
LOSS_RTOL = 5e-3


@pytest.fixture(scope="module")
def data():
    return InMemoryECG(n=20, t=T, seed=11), InMemoryECG(n=12, t=T, seed=12)


@pytest.fixture(scope="module")
def jax_vars():
    return jax.device_get(jax_build_ecgcnn(num_labels=5, seed=0)[1])


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _port_run(data, jax_vars, out, epochs, **kw):
    model = ECGCNN(num_labels=5)
    model.load_state_dict(from_flax_variables(jax_vars))
    args = dict(model=model, train_ds=data[0], val_ds=data[1], batch_size=8, epochs=epochs,
                lr=1e-3, weight_decay=1e-4, seed=42, run_name="port",
                metrics_csv=str(out / "logs" / "metrics.csv"),
                ckpt_path=str(out / "ckpts" / "best.npz"), config_path="cfg.yaml",
                classes=CLASSES)
    args.update(kw)
    return TrainRun(**args)


@pytest.fixture(scope="module")
def both_fits(data, jax_vars, tmp_path_factory):
    jout = tmp_path_factory.mktemp("jax_fit")
    jm, _ = jax_build_ecgcnn(num_labels=5, seed=0)
    jax_train(JaxTrainRun(
        model=jm, variables=jax_vars, train_ds=data[0], val_ds=data[1], batch_size=8,
        epochs=2, lr=1e-3, weight_decay=1e-4, seed=42, run_name="jax",
        metrics_csv=str(jout / "m.csv"), ckpt_path=str(jout / "best.npz"),
        config_path="cfg.yaml", classes=CLASSES, pth_export=False))
    pout = tmp_path_factory.mktemp("port_fit")
    train(_port_run(data, jax_vars, pout, 2))
    return _rows(jout / "m.csv"), _rows(pout / "logs" / "metrics.csv"), pout


def test_epoch_losses_match_jax(both_fits):
    jrows, prows, _ = both_fits
    assert jrows[0] == prows[0] == EPOCH_CSV_HEADER
    assert len(jrows) == len(prows) == 3
    for j, p in zip(jrows[1:], prows[1:]):
        assert j[2] == p[2]
        np.testing.assert_allclose(float(p[3]), float(j[3]), rtol=LOSS_RTOL)  # train_bce
        np.testing.assert_allclose(float(p[7]), float(j[7]), rtol=LOSS_RTOL)  # val_bce


def test_best_checkpoint_loads_in_jax_and_predictor(both_fits):
    _, prows, pout = both_fits
    best = str(pout / "ckpts" / "best.npz")
    with open(best + ".meta.json") as f:
        auprc = json.load(f)["val_auprc"]
    assert auprc == max(float(r[5]) for r in prows[1:])
    variables, classes = jax_load_npz(best)
    assert classes == CLASSES
    jm, _ = jax_build_ecgcnn(num_labels=5, seed=0)
    x = np.random.default_rng(0).standard_normal((3, T, 12)).astype(np.float32) * 2 + 1
    from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch as jax_zscore
    want = np.asarray(jax.nn.sigmoid(jm.apply(variables, jax_zscore(jnp.asarray(x)))))
    p = Predictor.from_checkpoint(best, engine="framework", device="cpu")
    assert p.classes == CLASSES
    np.testing.assert_allclose(p(x), want, atol=1e-5)
    state, cls = read_pth(str(pout / "ckpts" / "best.pth"))
    assert cls == CLASSES
    for k, v in from_flax_variables(variables).items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)


def test_resume_continues_and_matches_a_straight_run(data, jax_vars, tmp_path, capsys):
    """Two epochs, then a resume to three, equals three epochs straight
    (mirrors tests/test_trainer_resume.py)."""
    train(_port_run(data, jax_vars, tmp_path / "a", 2))
    out1 = capsys.readouterr().out
    assert "Epoch 1/2" in out1 and "Epoch 2/2" in out1
    train(_port_run(data, jax_vars, tmp_path / "a", 3, resume=True))
    out2 = capsys.readouterr().out
    assert "Resumed from" in out2 and "Epoch 3/3" in out2 and "Epoch 1/3" not in out2
    train(_port_run(data, jax_vars, tmp_path / "b", 3))
    out3 = capsys.readouterr().out
    assert "Resumed from" not in out3
    resumed, straight = _rows(tmp_path / "a/logs/metrics.csv"), _rows(tmp_path / "b/logs/metrics.csv")
    assert [r[2] for r in resumed[1:]] == ["1", "2", "3"]
    for r, s in zip(resumed[1:], straight[1:]):
        assert r[3:8] == s[3:8]


def test_resume_reconciles_with_sidecar(data, jax_vars, tmp_path, capsys):
    """A sidecar ahead of the resume point (a crash between the two writes) wins."""
    train(_port_run(data, jax_vars, tmp_path, 1))
    with open(tmp_path / "ckpts" / "best.npz.meta.json", "w") as f:
        json.dump({"val_auprc": 2.0}, f)
    capsys.readouterr()
    train(_port_run(data, jax_vars, tmp_path, 2, resume=True))
    out = capsys.readouterr().out
    assert "best AUPRC 2.0000" in out and "New best" not in out


def test_early_stopping_triggers(data, jax_vars, tmp_path, monkeypatch, capsys):
    """Non-improving val AUPRC stops after ``patience`` epochs (mirrors
    tests/test_early_stopping.py)."""
    seq = iter([0.5, 0.4, 0.3, 0.2, 0.1, 0.05])

    def fake_eval(state, eval_step, batches, threshold=0.5, loss_mode="per_sample", desc=None):
        list(batches)
        return {"auroc_macro": 0.5, "auprc_macro": next(seq), "f1_macro": 0.0, "bce_loss": 1.0}

    monkeypatch.setattr(trainer_mod, "eval_one_epoch", fake_eval)
    train(_port_run(data, jax_vars, tmp_path, 10, early_stop_patience=2, pth_export=False))
    out = capsys.readouterr().out
    assert "Epoch 3/10" in out and "Epoch 4/10" not in out
    assert "[INFO] Early stopping." in out
    assert os.path.exists(tmp_path / "ckpts" / "best.npz")
    assert not os.path.exists(tmp_path / "ckpts" / "best.pth")


def test_pth_export_failure_warns_and_training_goes_on(data, jax_vars, tmp_path, monkeypatch,
                                                       capsys):
    """A ``.pth`` that cannot be written (a directory sits at its path) is
    reported as the JAX trainer reports it (ptbxl_tpu/training/trainer.py:113-121);
    the ``.npz`` and its sidecar stay and the next epoch runs."""
    seq = iter([0.5, 0.6])  # every epoch improves, so every epoch exports

    def fake_eval(state, eval_step, batches, threshold=0.5, loss_mode="per_sample", desc=None):
        list(batches)
        return {"auroc_macro": 0.5, "auprc_macro": next(seq), "f1_macro": 0.0, "bce_loss": 1.0}

    monkeypatch.setattr(trainer_mod, "eval_one_epoch", fake_eval)
    os.makedirs(tmp_path / "ckpts" / "best.pth")
    train(_port_run(data, jax_vars, tmp_path, 2))
    out = capsys.readouterr().out
    assert out.count("[WARN] .pth export failed (") == 2
    assert out.count("); native .npz saved") == 2
    assert "Epoch 2/2" in out
    assert jax_load_npz(str(tmp_path / "ckpts" / "best.npz"))[1] == CLASSES
    with open(tmp_path / "ckpts" / "best.npz.meta.json") as f:
        assert json.load(f)["val_auprc"] == 0.6
    assert len(_rows(tmp_path / "logs" / "metrics.csv")) == 3
    assert os.path.isdir(tmp_path / "ckpts" / "best.pth")


def test_csv_rows_match_jax(tmp_path):
    """The same row through both writers: equal bytes but for the timestamp."""
    from ptbxl_tpu.utils.csv_log import log_epoch_to_csv as jax_log

    from ptbxl_torch.utils.csv_log import log_epoch_to_csv

    m = {"auroc_macro": 0.75, "auprc_macro": float("nan"), "f1_macro": 0.5, "bce_loss": 0.25}
    for fn, name in ((jax_log, "j.csv"), (log_epoch_to_csv, "p.csv")):
        for epoch in (1, 2):
            fn(str(tmp_path / "d" / name), "run", epoch, np.float32(0.123456789), m,
               "ck.npz", "c.yaml")
    j, p = _rows(tmp_path / "d" / "j.csv"), _rows(tmp_path / "d" / "p.csv")
    assert len(j) == len(p) == 3 and j[0] == p[0]
    assert [r[1:] for r in j] == [r[1:] for r in p]


def test_set_seed():
    from ptbxl_torch.utils.rng import set_seed

    g = set_seed(5)
    a = (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g).item())
    g = set_seed(5)
    assert a == (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g).item())


# -- checkpoint writers vs the JAX package ------------------------------------------

@pytest.mark.parametrize("arch", ["ecgcnn", "multimodal"])
def test_to_flax_variables_inverts_the_bridge(arch):
    build = jax_build_multimodal if arch == "multimodal" else jax_build_ecgcnn
    variables = jax.device_get(build(num_labels=5, seed=1)[1])
    state = from_flax_variables(variables, arch)
    got = to_flax_variables(state, arch)
    to_flax = torch_to_flax_multimodal if arch == "multimodal" else torch_to_flax_ecgcnn
    want = to_flax({k: v.numpy() for k, v in state.items()})
    for ref in (want, variables):
        gl = jax.tree_util.tree_leaves_with_path(got)
        rl = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in gl] == [p for p, _ in rl]
        for (_, a), (_, b) in zip(gl, rl):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_save_npz_and_export_pth_read_by_jax(tmp_path, jax_vars):
    state = from_flax_variables(jax_vars)
    npz, pth = str(tmp_path / "m.npz"), str(tmp_path / "m.pth")
    save_npz(npz, to_flax_variables(state), classes=CLASSES)
    variables, classes = jax_load_npz(npz)
    assert classes == CLASSES
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(variables),
                                jax.tree_util.tree_leaves_with_path(jax_vars)):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b))
    export_pth(pth, state, classes=CLASSES)
    ck = jax_read_pth(pth)
    assert ck["classes"] == CLASSES and set(ck["model_state"]) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(ck["model_state"][k], v.numpy(), err_msg=k)
    export_pth(pth, state)
    assert "classes" not in jax_read_pth(pth)


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_merge_backbone_matches_jax(tmp_path, fmt):
    path = CKPT
    if fmt == "pth":
        path = str(tmp_path / "base.pth")
        export_pth(path, load_checkpoint(CKPT)[0])
    bb, _ = load_checkpoint(path, arch="backbone")
    assert not any(k.startswith("head.") for k in bb) and "proj.weight" in bb
    mm_vars = jax.device_get(jax_build_multimodal(num_labels=5, seed=0)[1])
    want = from_flax_variables(jax_merge_backbone(mm_vars, jax_load_checkpoint(path, "backbone")[0]),
                               "multimodal")
    model = ECGMultimodal(num_labels=5)
    model.load_state_dict(from_flax_variables(mm_vars, "multimodal"))
    got = merge_backbone(model, bb).state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_merge_backbone_shape_mismatch_raises():
    bb, _ = load_checkpoint(CKPT, arch="backbone")
    with pytest.raises(ValueError, match="warm-start shape mismatch"):
        merge_backbone(ECGMultimodal(feat_dim=128, num_labels=5), bb)
