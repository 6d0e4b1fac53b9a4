"""Closed loop over ECGFounder's Net1D (configuration ``ecgfounder``): the
``closed`` kind's load, with Net1D's ``Predictor`` settings, operations,
reference and control.

* weights: ``synth.weights`` draws every leaf of the configuration's
  ``params`` (lecun-scaled kernels, small biases), as for the CNNs;
* ``Predictor(arch="ecgfounder")``, its widths and labels read from the
  weights' shapes;
* the window: ``closed.Load.window``'s loop, its ``w.flops`` counted by
  ``roofline_ecgfounder.forward_flops`` in place of the CNN's ``roofline``;
* reference and control: ``benchmark/reference/ecgfounder.py`` in f32 and in
  the traffic's ``control`` (fp8).  Net1D has no int8 path.  The control
  also reports ``live_share``: the share of the reference's probabilities
  inside (0.01, 0.99) on the checked rows, so that the check compares values
  the sigmoid has not flattened.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping
from unittest import mock

import numpy as np

from benchmark import roofline_ecgfounder
from benchmark.drive import Window, max_gap
from benchmark.kinds import closed
from benchmark.reference import ecgfounder as reference
from ptbxl_torch.inference import Predictor


class Load(closed.Load):
    def make_predictor(self, settings: Mapping) -> Predictor:
        return Predictor(self.weights, arch="ecgfounder", device=self.device, **settings)

    def window(self, seconds: float, w: Window, on_start: Callable[[], None]) -> None:
        # the closed loop itself; it counts ``w.flops`` through its module's
        # ``roofline``, the CNN's yardstick, so Net1D's stands in for it
        with mock.patch.object(closed, "roofline", roofline_ecgfounder):
            super().window(seconds, w, on_start)

    def reference_probs(self, rows: np.ndarray, precision: str = "f32") -> np.ndarray:
        return reference.probs(self.weights, self.cfg, self.pool[rows], precision=precision,
                               device=self.device).numpy()

    def control(self) -> Dict[str, float]:
        """The check's number with the reference in the traffic's control
        precision in the program's place, and the reference's live share."""
        pairs = self.checked()
        rows = np.unique(np.concatenate([r for r, _ in pairs]))
        ref = self.reference_probs(rows)
        low = self.reference_probs(rows, self.traffic["control"])
        return {"max_prob_gap": max_gap([(low, ref)]),
                "live_share": float(np.mean((ref > 0.01) & (ref < 0.99)))}
