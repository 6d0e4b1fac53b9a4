"""What the eval CLIs share: one split's predictions through the eval loop."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
from ptbxl_torch.training.loop import make_eval_step, predict_all
from ptbxl_torch.training.train_state import TrainState


def predict_split(model: torch.nn.Module, ds, batch_size: int, multimodal: bool,
                  normalize: str, loss_mode: str = "per_sample"
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(y_true, y_prob, mean BCE) of ``model`` over ``ds`` in order:
    ``BatchSource`` (the ADC cache, f32 batches) -> ``device_prefetch`` ->
    ``make_eval_step`` -> ``predict_all``, on the model's device."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(multimodal=multimodal, normalize=normalize)
    src = BatchSource(ds, batch_size, shuffle=False)
    return predict_all(TrainState(model=model), eval_step,
                       device_prefetch(src.epoch(0), device), loss_mode=loss_mode)
