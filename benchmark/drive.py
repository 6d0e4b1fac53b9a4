"""What every kind of load shares: the measured window's record, the serving
set-up, and the checks' arithmetic.

A traffic file (``benchmark/traffic/<name>.json``) names its ``kind``, and
``kind(name)`` finds its load generator, the class ``Load`` of the module
``benchmark/kinds/<kind>.py``.  A ``Load`` is built from the cell's
configuration, the traffic file, ``--seed`` and the device, and has:

* ``setup()``: make the inputs and weights from the seed, build the
  program's object and warm up the shapes the traffic uses;
* ``window(seconds, w, on_start)``: call ``on_start()``, then measure for
  ``seconds`` into the ``Window`` ``w``;
* ``finish()``: after the window and the memory peak's reading, collect what
  the check compares and free the program's state;
* ``check()`` and ``control()``: the numbers compared with the plain
  reference, and the same numbers with the traffic's control in the
  program's place.
"""

from __future__ import annotations

import importlib
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from benchmark import synth
from benchmark.reference import ecg as reference
from benchmark.trace import Spans
from ptbxl_torch.inference import Predictor


@dataclass
class Window:
    """What one measured window leaves for the metrics: its bounds on the
    ``perf_counter_ns`` clock, the host spans, and the work counted."""

    spans: Spans
    t0: int = 0
    t1: int = 0
    records: int = 0  # real records scored or trained
    flops: float = 0.0  # model operations of those records
    launched: List[int] = field(default_factory=list)  # rows of each forward chunk
    steps: int = 0
    attempted: int = 0
    failed: int = 0

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def kind(name: str):
    """The load generator of the traffic kind ``name``."""
    return importlib.import_module(f"benchmark.kinds.{name}").Load


def chunk_rows(n: int, chunk_size: int) -> List[int]:
    """The rows of each forward chunk ``Predictor`` launches for a call of
    ``n`` records: chunks of ``chunk_size``, the last padded to it when the
    call spans chunks, a lone chunk padded to the next power of two."""
    if n > chunk_size:
        return [chunk_size] * math.ceil(n / chunk_size)
    return [1 << (n - 1).bit_length() if n > 1 else 1]


def now() -> int:
    return time.perf_counter_ns()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    """The memory peak counts from here: the program's, not the draws'."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def max_gap(outputs: List[Tuple[np.ndarray, np.ndarray]]) -> float:
    """Widest absolute gap between a probability and the reference's."""
    return max(float(np.max(np.abs(o - r))) for o, r in outputs)


class Serve:
    """Shared set-up of the serving kinds: pool, demographics, weights and a
    ``Predictor`` built as the traffic's ``predictor`` settings say.  A kind
    adds ``warm``, ``window`` and ``checked``."""

    def __init__(self, cfg: Mapping, traffic: Mapping, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.mm = cfg["arch"] == "multimodal"

    def setup(self) -> None:
        n, t = self.traffic["pool_records"], self.cfg["input_length"]
        self.pool = synth.records(n, t, self.seed, self.device)
        self.demo = synth.demographics(n, self.seed, self.device) if self.mm else None
        self.weights = synth.weights(self.cfg["params"], self.seed, self.device)
        reset_peak(self.device)
        self.predictor = self.make_predictor(self.traffic["predictor"])
        self.warm()

    def make_predictor(self, settings: Mapping) -> Predictor:
        return Predictor(self.weights, num_labels=self.cfg["num_labels"],
                         feat_dim=self.cfg["feat_dim"], arch=self.cfg["arch"],
                         device=self.device, **settings)

    def call(self, predictor: Predictor, i0: int, n: int) -> np.ndarray:
        x = self.pool[i0:i0 + n]
        return predictor(x, self.demo[i0:i0 + n]) if self.mm else predictor(x)

    def finish(self) -> None:
        self.predictor = None

    def reference_probs(self, rows: np.ndarray, precision: str = "f32") -> np.ndarray:
        demo = self.demo[rows] if self.mm else None
        return reference.probs(self.weights, self.cfg, self.pool[rows], demo,
                               precision=precision, device=self.device).numpy()

    def checked(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(rows, probabilities) of each answer the check compares."""
        raise NotImplementedError

    def check(self) -> Dict[str, float]:
        pairs = self.checked()
        rows = np.unique(np.concatenate([r for r, _ in pairs]))
        ref = self.reference_probs(rows)
        return {"max_prob_gap": max_gap([(p, ref[np.searchsorted(rows, r)]) for r, p in pairs])}

    def control(self) -> Dict[str, float]:
        """The check's numbers with the traffic's control in the program's
        place (the reference in TF32 or fp8), on the answers the check
        compares; and, for the record, those of the program's own int8 path."""
        pairs = self.checked()
        rows = np.unique(np.concatenate([r for r, _ in pairs]))
        ref = self.reference_probs(rows)
        low = self.reference_probs(rows, self.traffic["control"])
        int8 = self.make_predictor(dict(self.traffic["predictor"], precision="int8"))(
            self.pool[rows], *([self.demo[rows]] if self.mm else []))
        return {"max_prob_gap": max_gap([(low, ref)]), "int8.max_prob_gap": max_gap([(int8, ref)])}


def _norms(leaves: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def train_gaps(prog, ref, w0: Mapping[str, torch.Tensor], detail: bool = False) -> Dict[str, float]:
    """The train cell's numbers, from (losses, first gradients, state after
    the checked steps) of the program and of the reference.

    ``loss_gap``: the largest relative gap of a step's loss.  ``grad_gap`` and
    ``change_gap``: by the worst leaf, the gap between the program's norm and
    the reference's, over the larger of the reference's norm of that leaf and
    of the median leaf.  The change leaves out parameters whose reference
    gradient is under a thousandth of the median leaf's (a conv bias before
    BatchNorm, which only round-off moves under AdamW); the running
    statistics are counted.  ``detail`` adds the worst leaf of each number
    and each leaf's gradient gap."""
    (lp, gp, ap), (lr_, gr, ar) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr_))
    ngp, ngr = _norms({k: gp[k] for k in gr}), _norms(gr)
    med_g = statistics.median(ngr.values())
    grad = {k: abs(ngp[k] - ngr[k]) / max(ngr[k], med_g) for k in ngr}
    keep = [k for k in ar if k not in ngr or ngr[k] >= 1e-3 * med_g]
    dev = next(iter(ar.values())).device
    dp = _norms({k: ap[k].to(dev) - w0[k] for k in keep})
    dr = _norms({k: ar[k] - w0[k] for k in keep})
    med_c = statistics.median(dr.values())
    change = {k: abs(dp[k] - dr[k]) / max(dr[k], med_c) for k in keep}
    out = {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
           "change_gap": max(change.values()),
           "median_grad_gap": statistics.median(grad.values()),
           "step1_loss_gap": abs(lp[0] - lr_[0]) / abs(lr_[0])}
    if detail:
        out.update(worst_grad_leaf=max(grad, key=grad.get),
                   worst_change_leaf=max(change, key=change.get),
                   median_grad_leaf=sorted(grad, key=grad.get)[(len(grad) - 1) // 2])
        out.update(("grad." + k, v) for k, v in grad.items())
    return out
