"""Learnability gate on the port (tests/test_learning.py:79-119): the whole
training stack (ptbxl_torch/training/loop.py, train_state.py, the models'
train mode and K6's backward) must fit the JAX test's synthetic AF-like task,
the label in the beat rate, to val AUROC > 0.9 in six epochs.  The bf16
case is the quality gate of the bf16 training path (``train.dtype:
bfloat16``), whose epochs the card otherwise checks only for finite losses."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from ptbxl_torch.models.factory import build_ecgcnn  # noqa: E402
from ptbxl_torch.training.loop import (  # noqa: E402
    eval_one_epoch,
    make_eval_step,
    make_train_step,
    train_one_epoch,
)
from ptbxl_torch.training.train_state import create_train_state  # noqa: E402
from tests.test_learning import _ArraySource, _SyntheticBeats  # noqa: E402


@pytest.mark.slow
@pytest.mark.parametrize("precision,dtype", [("highest", torch.float32), (None, torch.bfloat16)],
                         ids=["f32-parity", "bf16"])
def test_training_learns_af_like_task(precision, dtype):
    train_ds = _SyntheticBeats(192, seed=0)
    val_ds = _SyntheticBeats(64, seed=1)
    model = build_ecgcnn(num_labels=1, seed=0, precision=precision, dtype=dtype, device="cpu")
    state = create_train_state(model, 1e-3, 1e-4)
    train_step, eval_step = make_train_step(), make_eval_step()
    train_src = _ArraySource(train_ds, 16, True)
    val_src = _ArraySource(val_ds, 16, False)

    first = eval_one_epoch(state, eval_step, val_src.epoch(0))
    losses = []
    for epoch in range(6):
        state, loss = train_one_epoch(state, train_step, train_src.epoch(epoch))
        losses.append(loss)
    final = eval_one_epoch(state, eval_step, val_src.epoch(0))

    assert losses[-1] < losses[0] * 0.7, f"loss did not drop: {losses}"
    assert final["auroc_macro"] > 0.9, (
        f"AUROC {final['auroc_macro']:.3f} after training (untrained: {first['auroc_macro']:.3f})")
    assert final["auroc_macro"] > first["auroc_macro"]
