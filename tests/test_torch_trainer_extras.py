"""The port trainer's opt-in switches and training gates
(ptbxl_torch/training/{trainer,loop}.py) against the JAX trainer's:
``PTBXL_TORCH_TB`` (ptbxl_tpu/training/trainer.py:166-177, 230-234) through a
fake ``SummaryWriter``, ``PTBXL_TORCH_CHECK_NUMERICS`` (:132-134) raising
before the bad update, and tests/test_determinism.py's seed pair on the port,
at the JAX test's size (one epoch, batch 8)."""

import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ptbxl_torch.data import PTBXLDataset  # noqa: E402
from ptbxl_torch.data.pipeline import BatchSource, device_prefetch  # noqa: E402
from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.models.factory import build_ecgcnn  # noqa: E402
from ptbxl_torch.training.loop import make_train_step, train_one_epoch  # noqa: E402
from ptbxl_torch.training.train_state import create_train_state  # noqa: E402
from ptbxl_torch.training.trainer import TrainRun, train  # noqa: E402
from tests.torch_port_common import CLASSES, InMemoryECG, block_module  # noqa: E402

T = 64


class FakeWriter:
    made = []

    def __init__(self, log_dir):
        self.log_dir, self.scalars, self.closed = log_dir, [], False
        FakeWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass

    def close(self):
        self.closed = True


def _run(tmp_path, epochs=2, train_ds=None):
    return TrainRun(model=ECGCNN(num_labels=5),
                    train_ds=train_ds or InMemoryECG(n=8, t=T, seed=1),
                    val_ds=InMemoryECG(n=8, t=T, seed=2), batch_size=4, epochs=epochs,
                    lr=1e-3, weight_decay=1e-4, seed=42, run_name="tb_run",
                    metrics_csv=str(tmp_path / "m.csv"), ckpt_path=str(tmp_path / "best.npz"),
                    config_path="c.yaml", classes=CLASSES, pth_export=False,
                    train_desc=None, eval_desc=None)


@pytest.fixture
def fake_tb(monkeypatch):
    FakeWriter.made = []
    mod = types.ModuleType("torch.utils.tensorboard")
    mod.SummaryWriter = FakeWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", mod)
    return FakeWriter


def test_tb_writes_scalars_every_epoch(tmp_path, monkeypatch, fake_tb):
    monkeypatch.setenv("PTBXL_TORCH_TB", str(tmp_path / "tb"))
    seen = []
    run = _run(tmp_path)
    run.progress = lambda epoch, loss, metrics: seen.append((epoch, loss, metrics))
    train(run)
    (w,) = fake_tb.made
    assert w.log_dir == str(tmp_path / "tb" / "tb_run") and w.closed
    want = []
    for epoch, loss, metrics in seen:
        want.append(("train/bce", loss, epoch))
        want += [(f"val/{k}", float(v), epoch) for k, v in metrics.items()]
    assert w.scalars == want
    assert {t for t, _, _ in w.scalars} == {"train/bce", "val/auroc_macro", "val/auprc_macro",
                                            "val/f1_macro", "val/bce_loss"}


def test_tb_dormant_by_default(tmp_path, monkeypatch, fake_tb):
    monkeypatch.delenv("PTBXL_TORCH_TB", raising=False)
    train(_run(tmp_path, epochs=1))
    assert fake_tb.made == []


def test_tb_unavailable_warns_and_trains(tmp_path, monkeypatch, capsys):
    block_module(monkeypatch, "torch.utils.tensorboard")
    monkeypatch.setenv("PTBXL_TORCH_TB", str(tmp_path / "tb"))
    train(_run(tmp_path, epochs=1))
    assert "[WARN] TensorBoard requested but unavailable" in capsys.readouterr().out
    assert (tmp_path / "m.csv").exists()


def _inf_batch():
    rng = np.random.default_rng(3)
    ecg = rng.standard_normal((4, T, 12)).astype(np.float32)
    ecg[1, 7, 3] = np.inf  # one sample: its z-score and loss turn NaN
    return {"ecg": ecg, "y": (rng.uniform(size=(4, 5)) > 0.7).astype(np.float32),
            "mask": np.ones(4, np.float32)}


@pytest.mark.parametrize("check", [True, False])
def test_check_numerics_raises_before_the_update(check):
    torch.manual_seed(0)
    state = create_train_state(ECGCNN(num_labels=5), 1e-3, 1e-4)
    before = {k: v.clone() for k, v in state.model.state_dict().items()
              if "running" not in k}
    step = make_train_step(check_numerics=check)
    if not check:  # without the switch the bad update lands
        step(state, _inf_batch())
        assert not torch.isfinite(state.model.head.weight).all()
        return
    with pytest.raises(FloatingPointError, match="at step 0"):
        step(state, _inf_batch())
    for k, v in state.model.state_dict().items():
        if k in before:
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert not state.optimizer.state  # no AdamW moment was taken


def test_check_numerics_names_the_parameter():
    torch.manual_seed(0)
    state = create_train_state(ECGCNN(num_labels=5), 1e-3, 1e-4)
    batch = _inf_batch()
    batch["ecg"] = np.nan_to_num(batch["ecg"], posinf=0.0)
    hook = state.model.head.weight.register_hook(lambda g: g * float("inf"))
    with pytest.raises(FloatingPointError, match=r"gradient of head\.weight at step 0"):
        make_train_step(check_numerics=True)(state, batch)
    hook.remove()


def test_check_numerics_switch_in_trainer(tmp_path, monkeypatch):
    ds = InMemoryECG(n=8, t=T, seed=1)
    ds.x[5, 2, 9] = np.inf
    monkeypatch.setenv("PTBXL_TORCH_CHECK_NUMERICS", "1")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train(_run(tmp_path, epochs=1, train_ds=ds))
    monkeypatch.setenv("PTBXL_TORCH_CHECK_NUMERICS", "0")
    train(_run(tmp_path / "off", epochs=1, train_ds=ds))  # NaN training goes on unchecked


def _one_epoch(ptbxl_dir, seed):
    ds = PTBXLDataset(ptbxl_dir, "train", CLASSES)
    model = build_ecgcnn(num_labels=5, seed=seed, device="cpu")
    state = create_train_state(model, 1e-3, 1e-4)
    src = BatchSource(ds, 8, shuffle=True, seed=seed)
    state, loss = train_one_epoch(state, make_train_step(), device_prefetch(src.epoch(0), "cpu"))
    return loss, state.model.head.weight.detach().numpy().copy()


def test_identical_seeds_identical_training(ptbxl_dir):
    loss1, params1 = _one_epoch(ptbxl_dir, seed=3)
    loss2, params2 = _one_epoch(ptbxl_dir, seed=3)
    assert loss1 == loss2
    np.testing.assert_array_equal(params1, params2)


def test_different_seeds_differ(ptbxl_dir):
    loss1, _ = _one_epoch(ptbxl_dir, seed=3)
    loss2, _ = _one_epoch(ptbxl_dir, seed=4)
    assert loss1 != loss2
