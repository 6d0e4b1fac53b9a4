"""Closed loop over ST-MEM's ViT encoder (configuration ``st_mem``): the
``closed`` kind's load, with ST-MEM's weights, ``Predictor`` settings,
operations, reference and control.

* weights: ``synth.weights`` draws every leaf of the configuration's
  ``params``; a LayerNorm gain, which it would draw as a fan-in-1 kernel,
  is then redrawn near 1 (``1 + 0.1 N(0, 1)``) from a stream of its own;
* ``Predictor(arch="st_mem")``, its sizes read from the weights' shapes;
* the window: ``closed.Load.window``'s loop, its ``w.flops`` counted by
  ``roofline_st_mem.forward_flops`` in place of the CNN's ``roofline``;
* reference and control: ``benchmark/reference/st_mem.py`` in f32 and in the
  traffic's ``control`` (fp8).  ST-MEM has no int8 path.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping
from unittest import mock

import numpy as np
import torch

from benchmark import roofline_st_mem, synth
from benchmark.drive import Window, max_gap, reset_peak
from benchmark.kinds import closed
from benchmark.reference import st_mem as reference
from ptbxl_torch.inference import Predictor

GAIN_STREAM = 5


def layer_norm_gains(w: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """``w`` with every LayerNorm gain redrawn as ``1 + 0.1 N(0, 1)``."""
    g = synth.generator(seed, device, GAIN_STREAM)
    for key in w:
        if key.endswith(".weight") and key.split(".")[-2].startswith("norm"):
            w[key] = 1.0 + 0.1 * torch.randn(w[key].shape, generator=g, device=device)
    return w


class Load(closed.Load):
    def setup(self) -> None:
        n, t = self.traffic["pool_records"], self.cfg["input_length"]
        self.pool = synth.records(n, t, self.seed, self.device)
        self.weights = layer_norm_gains(synth.weights(self.cfg["params"], self.seed, self.device),
                                        self.seed, self.device)
        reset_peak(self.device)
        self.predictor = self.make_predictor(self.traffic["predictor"])
        self.warm()

    def make_predictor(self, settings: Mapping) -> Predictor:
        return Predictor(self.weights, num_labels=self.cfg["num_labels"], arch="st_mem",
                         device=self.device, **settings)

    def window(self, seconds: float, w: Window, on_start: Callable[[], None]) -> None:
        # the closed loop itself; it counts ``w.flops`` through its module's
        # ``roofline``, the CNN's yardstick, so ST-MEM's stands in for it
        with mock.patch.object(closed, "roofline", roofline_st_mem):
            super().window(seconds, w, on_start)

    def reference_probs(self, rows: np.ndarray, precision: str = "f32") -> np.ndarray:
        return reference.probs(self.weights, self.cfg, self.pool[rows], precision=precision,
                               device=self.device).numpy()

    def control(self) -> Dict[str, float]:
        """The check's number with the reference in the traffic's control
        precision in the program's place."""
        pairs = self.checked()
        rows = np.unique(np.concatenate([r for r, _ in pairs]))
        ref = self.reference_probs(rows)
        low = self.reference_probs(rows, self.traffic["control"])
        return {"max_prob_gap": max_gap([(low, ref)])}
