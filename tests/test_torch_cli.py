"""The port's CLIs (ptbxl_torch/cli/) in-process with ``--device cpu`` on the
hermetic fixture (``ptbxl_dir``), against the JAX package.

* 03/04/05 write the JAX scripts' metrics CSV header, checkpoints and prints;
  03 with its model factory returning the JAX init (carried across by
  ``from_flax_variables``) matches the JAX trainer's per-epoch losses and
  metrics at rtol 5e-3 (tests/test_torch_trainer.py's tolerance).
* 06/07/08 on the committed checkpoints write the JAX scripts' columns;
  ``y_prob`` is within 2e-5 of JAX's ``PTBXLDataset`` + ``BatchSource`` +
  ``predict_all``; ``y_true`` is identical, and ``y_pred`` too except where a
  probability lies within 2e-5 of the threshold.
* 12's CAM matches JAX's ``GradCAM`` (2e-3) and its importance JAX's
  ``demo_importance`` (1e-4).
"""

import csv
import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.data import PTBXLAFDataset as JAF  # noqa: E402
from ptbxl_tpu.data import PTBXLDataset as JDS  # noqa: E402
from ptbxl_tpu.data import PTBXLECGMultimodalDataset as JMM  # noqa: E402
from ptbxl_tpu.data.pipeline import BatchSource as JBatchSource  # noqa: E402
from ptbxl_tpu.data.pipeline import device_prefetch as jax_prefetch  # noqa: E402
from ptbxl_tpu.interpret.grad_cam import GradCAM as JGradCAM  # noqa: E402
from ptbxl_tpu.interpret.grad_cam import demo_importance as jax_demo_importance  # noqa: E402
from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.models.factory import load_ecgcnn as jax_load_ecgcnn  # noqa: E402
from ptbxl_tpu.models.factory import load_multimodal as jax_load_multimodal  # noqa: E402
from ptbxl_tpu.training.loop import make_eval_step as jax_eval_step  # noqa: E402
from ptbxl_tpu.training.loop import predict_all as jax_predict_all  # noqa: E402
from ptbxl_tpu.training.train_state import create_train_state, make_optimizer  # noqa: E402
from ptbxl_tpu.training.trainer import TrainRun as JaxTrainRun  # noqa: E402
from ptbxl_tpu.training.trainer import train as jax_train  # noqa: E402
from ptbxl_tpu.utils.csv_log import EPOCH_CSV_HEADER  # noqa: E402

from ptbxl_torch.cli import (  # noqa: E402
    af_binary_test,
    ecg_baseline_test,
    ecg_multimodal_test,
    grad_cam_ecg_demo,
    train_af_binary,
    train_ecg_baseline,
    train_multimodal_prototype,
)
from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.models.params_io import from_flax_variables, load_npz  # noqa: E402
from tests.torch_port_common import HERE  # noqa: E402

CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]
CKPT = os.path.join(HERE, "outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
CKPT_MM = os.path.join(HERE, "outputs/ecg_multimodal/ckpts/ecg_multimodal_best.npz")
CKPT_AF = os.path.join(HERE, "outputs/af_binary/ckpts/af_binary_best.npz")
RTOL = 5e-3
PROB_TOL = 2e-5


def _cfg(path, ptbxl_dir, out_dir, epochs=2, extra=""):
    path.write_text(f"""seed: 42
data:
  base_dir: {ptbxl_dir}
  normalize: per_lead
  labels: ["MI", "STTC", "HYP", "CD", "NORM"]
train:
  batch_size: 8
  epochs: {epochs}
  lr: 1e-3
  weight_decay: 1e-4
{extra}log:
  out_dir: {out_dir}
""")
    return str(path)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _columns(path):
    rows = _rows(path)
    return {name: [r[i] for r in rows[1:]] for i, name in enumerate(rows[0])}


# -- training CLIs ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def baseline_runs(ptbxl_dir, tmp_path_factory):
    """03 through the port with the JAX init, and the JAX trainer on the same data."""
    out = tmp_path_factory.mktemp("cli03")
    _, jvars = jax_build_ecgcnn(num_labels=5, seed=42)
    jvars = jax.device_get(jvars)

    def build(**kw):
        model = ECGCNN(num_labels=kw["num_labels"])
        model.load_state_dict(from_flax_variables(jvars))
        return model.to(kw["device"]).eval()

    cfg = _cfg(out / "bl.yaml", ptbxl_dir, str(out / "port"))
    mp = pytest.MonkeyPatch()
    mp.setattr(train_ecg_baseline, "build_ecgcnn", build)
    try:
        state = train_ecg_baseline.main(["--config", cfg, "--device", "cpu"])
    finally:
        mp.undo()
    jm, _ = jax_build_ecgcnn(num_labels=5, seed=42)
    jcsv = str(out / "jax" / "m.csv")
    jax_train(JaxTrainRun(
        model=jm, variables=jvars, train_ds=JDS(ptbxl_dir, "train", CLASSES),
        val_ds=JDS(ptbxl_dir, "val", CLASSES), batch_size=8, epochs=2, lr=1e-3,
        weight_decay=1e-4, seed=42, run_name="ecg_baseline", metrics_csv=jcsv,
        ckpt_path=str(out / "jax" / "best.npz"), config_path=cfg, classes=CLASSES,
        pth_export=False))
    return out, state, jcsv


def test_baseline_cli_outputs(baseline_runs):
    out, state, _ = baseline_runs
    run = out / "port" / "ecg_baseline"
    rows = _rows(run / "logs" / "metrics_ecg_baseline.csv")
    assert rows[0] == EPOCH_CSV_HEADER and len(rows) == 3
    assert [r[1] for r in rows[1:]] == ["ecg_baseline"] * 2 and state.step == 8
    assert os.path.exists(run / "ckpts" / "ecg_baseline_best.npz")
    assert os.path.exists(run / "ckpts" / "ecg_baseline_best.pth")
    assert load_npz(str(run / "ckpts" / "ecg_baseline_best.npz"))[1] == CLASSES


def test_baseline_cli_matches_jax_trainer(baseline_runs):
    out, _, jcsv = baseline_runs
    prows = _rows(out / "port" / "ecg_baseline" / "logs" / "metrics_ecg_baseline.csv")
    jrows = _rows(jcsv)
    for p, j in zip(prows[1:], jrows[1:]):
        assert p[2] == j[2]
        for col in range(3, 8):  # train_bce, val auroc / auprc / f1, val_bce
            np.testing.assert_allclose(float(p[col]), float(j[col]), rtol=RTOL,
                                       err_msg=EPOCH_CSV_HEADER[col])


def test_multimodal_cli_warm_start_and_outputs(ptbxl_dir, tmp_path, capsys):
    cfg = _cfg(tmp_path / "mm.yaml", ptbxl_dir, str(tmp_path / "outputs/ecg_multimodal"), 1,
               "  early_stop_patience: 8\nmodel:\n  ecg_multimodal:\n    in_leads: 12\n"
               f"    ecg_feat_dim: 256\n    demo_hidden_dim: 64\n    pretrained_ecg_ckpt: {CKPT}\n")
    train_multimodal_prototype.main(["--config", cfg, "--device", "cpu"])
    text = capsys.readouterr().out
    for want in ("Loading pretrained ECG encoder", "ECG encoder loaded.", "Train-ECG-MM BCE:",
                 "[INFO] New best AUPRC", "[ECG-MM] train size = 30"):
        assert want in text, want
    out = tmp_path / "outputs/ecg_multimodal"
    rows = _rows(out / "logs" / "metrics_ecg_multimodal.csv")
    assert rows[0] == EPOCH_CSV_HEADER and len(rows) == 2 and rows[1][1] == "ecg_multimodal"
    assert os.path.exists(out / "ckpts" / "ecg_multimodal_best.npz")


def test_af_cli_outputs_carry_no_classes(ptbxl_dir, tmp_path, monkeypatch, capsys):
    cfg = _cfg(tmp_path / "af.yaml", ptbxl_dir, "outputs/af_binary\n  run_name: af_binary_ecg", 1)
    monkeypatch.chdir(tmp_path)
    train_af_binary.main(["--config", cfg, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Train-AF BCE:" in text and "[AF] Train size: 31" in text
    out = tmp_path / "outputs/af_binary"
    rows = _rows(out / "logs" / "metrics_af_binary.csv")
    assert rows[0] == EPOCH_CSV_HEADER and rows[1][1] == "af_binary_ecg"
    assert load_npz(str(out / "ckpts" / "af_binary_best.npz"))[1] is None


# -- eval CLIs -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_predictions(kind, ptbxl_dir):
    if kind == "af":
        ds = JAF(ptbxl_dir, "test")
        model, variables, _ = jax_load_ecgcnn(CKPT_AF, num_labels=1, strict=True)
        multimodal, loss_mode = False, "per_sample"
    elif kind == "mm":
        ds = JMM(ptbxl_dir, "test", CLASSES)
        model, variables, _ = jax_load_multimodal(CKPT_MM, num_labels=5, strict=True)
        multimodal, loss_mode = True, "per_batch"
    else:
        ds = JDS(ptbxl_dir, "test", CLASSES)
        model, variables, _ = jax_load_ecgcnn(CKPT, num_labels=5, strict=True)
        multimodal, loss_mode = False, "per_sample"
    state = create_train_state(model, variables, make_optimizer(0.0, 0.0))
    step = jax_eval_step(model, multimodal=multimodal, normalize="per_lead")
    src = JBatchSource(ds, 8, shuffle=False)
    return jax_predict_all(state, step, jax_prefetch(src.epoch(0)), loss_mode=loss_mode)


EVAL = {
    "baseline": (ecg_baseline_test, CKPT, [(f"y_true_{c}", f"y_prob_{c}", f"y_pred_{c}")
                                          for c in CLASSES]),
    "mm": (ecg_multimodal_test, CKPT_MM, [(f"y_true_{c}", f"y_prob_{c}_mm", f"y_pred_{c}_mm")
                                         for c in CLASSES]),
    "af": (af_binary_test, CKPT_AF, [("y_true_AF", "y_prob_AF", "y_pred_AF")]),
}


@pytest.mark.parametrize("kind", sorted(EVAL))
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_eval_cli_csv_matches_jax(kind, threshold, ptbxl_dir, tmp_path, capsys):
    mod, ckpt, triples = EVAL[kind]
    cfg = _cfg(tmp_path / "c.yaml", ptbxl_dir, str(tmp_path / "o"))
    out_csv = str(tmp_path / "preds" / f"{kind}.csv")
    metrics = mod.main(["--config", cfg, "--ckpt", ckpt, "--out_csv", out_csv,
                        "--threshold", str(threshold), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Saved" in text and "[INFO] Done." in text
    if kind == "baseline":
        assert "[Baseline][TEST] metrics:" in text
    cols = _columns(out_csv)
    assert list(cols) == [c for t in triples for c in t]
    y_true, y_prob, loss = _jax_predictions(kind, ptbxl_dir)
    np.testing.assert_allclose(metrics["bce_loss"], loss, rtol=1e-4)
    for j, (ct, cp, cd) in enumerate(triples):
        prob = np.array(cols[cp], np.float64)
        np.testing.assert_allclose(prob, y_prob[:, j], atol=PROB_TOL, rtol=0)
        np.testing.assert_array_equal(np.array(cols[ct], int), y_true[:, j].astype(int))
        want = (y_prob[:, j] >= threshold).astype(int)
        far = np.abs(y_prob[:, j] - threshold) > PROB_TOL
        np.testing.assert_array_equal(np.array(cols[cd], int)[far], want[far])


def test_eval_cli_threshold_search(ptbxl_dir, tmp_path, capsys):
    cfg = _cfg(tmp_path / "c.yaml", ptbxl_dir, str(tmp_path / "o"))
    ecg_baseline_test.main(["--config", cfg, "--ckpt", CKPT, "--out_csv",
                            str(tmp_path / "p.csv"), "--thresholds", "search_per_class",
                            "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[Baseline][TEST] val-fitted per-class thresholds:" in text
    assert "[Baseline][TEST] metrics @ val-fitted thresholds:" in text


def test_eval_cli_missing_checkpoint_fails(ptbxl_dir, tmp_path):
    cfg = _cfg(tmp_path / "c.yaml", ptbxl_dir, str(tmp_path / "o"))
    with pytest.raises(AssertionError, match="Checkpoint not found"):
        ecg_baseline_test.main(["--config", cfg, "--ckpt", str(tmp_path / "none.npz"),
                                "--out_csv", str(tmp_path / "p.csv"), "--device", "cpu"])


# -- 12: multimodal Grad-CAM -------------------------------------------------------------

def test_grad_cam_cli_matches_jax(ptbxl_dir, tmp_path, monkeypatch, capsys):
    cfg = _cfg(tmp_path / "c.yaml", ptbxl_dir, str(tmp_path / "o"))
    monkeypatch.chdir(tmp_path)
    cam_path, importance = grad_cam_ecg_demo.main(
        ["--config", cfg, "--ckpt", CKPT_MM, "--index", "1", "--device", "cpu"])
    assert cam_path == "outputs/gradcam_multimodal/sample_1_MI_cam.npy"
    assert "[INFO] Saved CAM to:" in capsys.readouterr().out
    cam = np.load(tmp_path / cam_path)
    ds = JMM(ptbxl_dir, "test", CLASSES)
    x_ecg, x_demo, _ = ds[1]
    model, variables, _ = jax_load_multimodal(CKPT_MM, num_labels=5, strict=False)
    x, d = jnp.asarray(x_ecg.T[None]), jnp.asarray(x_demo[None])
    _, want = JGradCAM(model, variables, signal_length=x_ecg.shape[-1], norm_first=False,
                       eps=1e-8, multimodal=True)(x, class_idx=0, x_demo=d)
    assert cam.shape == (x_ecg.shape[-1],)
    np.testing.assert_allclose(cam, np.asarray(want)[0], atol=2e-3, rtol=0)
    np.testing.assert_allclose(importance, np.asarray(jax_demo_importance(
        model, variables, x, d, class_idx=0)), atol=1e-4, rtol=0)
