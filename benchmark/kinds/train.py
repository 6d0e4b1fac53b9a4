"""Training: ``make_train_step`` under ``train_one_epoch``, fed as the
program's trainer feeds it (``training/trainer.py``): a shuffled
``BatchSource`` over the training set, each epoch through
``device_prefetch``, epoch after epoch until ``--seconds`` have passed.

The training set is ``pool_records`` synthetic records held in host memory
as a dataset the way ``BatchSource`` reads one (``y``, ``demo`` for the
multimodal model, ``__len__``, ``get_raw(idx) -> [leads, T]``), with
multi-hot labels.  Set-up builds the model through the program's factory
from the configuration's ``arch``, loads the seed's weights and runs the
first ``checked_steps`` batches of epoch 0 through the same step and feed;
the window runs epochs 1, 2, ...  After the window the same model and
optimizer are set back, in place, to the seed's weights and zero moments,
and the same step runs the checked batches again.  The reference follows the
checked steps once; each number compared is the worse of the two runs, so a
step that goes wrong only after its first calls fails the check too.
"""

from __future__ import annotations

import collections
import itertools
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from benchmark import roofline, synth
from benchmark.drive import Window, now, reset_peak, sync, train_gaps
from benchmark.reference import ecg as reference
from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
from ptbxl_torch.models.factory import build_ecgcnn, build_multimodal, merge_state
from ptbxl_torch.training.loop import make_train_step, train_one_epoch
from ptbxl_torch.training.train_state import create_train_state


class Records:
    """An in-memory training set: channels-last signals ``[N, T, leads]``,
    labels and, for the multimodal model, demographics.  ``get_raw`` gives
    a record's ``[leads, T]`` view, as ``data/datasets.py::load_ecg`` gives
    WFDB's ``p_signal`` transposed."""

    def __init__(self, signals: np.ndarray, y: np.ndarray, demo: Optional[np.ndarray]):
        self.signals, self.y = signals, y
        if demo is not None:  # BatchSource adds "demo" to a batch when the set has it
            self.demo = demo

    def __len__(self) -> int:
        return len(self.y)

    def get_raw(self, idx: int) -> np.ndarray:
        return self.signals[idx].T


def build_model(cfg: Mapping, precision: str, device) -> torch.nn.Module:
    """The configuration's model, built by the program's factory."""
    if cfg["arch"] == "multimodal":
        return build_multimodal(in_leads=cfg["leads"], ecg_feat_dim=cfg["feat_dim"],
                                demo_hidden_dim=cfg["demo_hidden_dim"],
                                num_labels=cfg["num_labels"], precision=precision, device=device)
    return build_ecgcnn(in_leads=cfg["leads"], feat_dim=cfg["feat_dim"],
                        num_labels=cfg["num_labels"], precision=precision, device=device)


class Load:
    def __init__(self, cfg: Mapping, traffic: Mapping, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.mm = cfg["arch"] == "multimodal"

    def setup(self) -> None:
        tr, cfg = self.traffic, self.cfg
        n = tr["pool_records"]
        signals = synth.records(n, cfg["input_length"], self.seed, self.device)
        y = synth.labels(n, cfg["num_labels"], tr["label_rate"], self.seed, self.device)
        demo = synth.demographics(n, self.seed, self.device) if self.mm else None
        self.src = BatchSource(Records(signals, y, demo), tr["batch"], shuffle=True,
                               seed=self.seed, emit_adc=True)
        self.w0 = synth.weights(cfg["params"], self.seed, self.device)
        reset_peak(self.device)
        model = build_model(cfg, tr["precision"], self.device)
        merge_state(model, self.w0, strict=True)
        self.init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.state = create_train_state(model, tr["lr"], tr["weight_decay"])
        self.step = make_train_step(multimodal=self.mm)
        self.checked_batches = list(itertools.islice(self.src.epoch(0), tr["checked_steps"]))
        self.runs = [self._checked_steps()]  # also the warm-up

    def _checked_steps(self):
        """The checked batches through the step and the feed: (each step's
        loss, the first gradients as AdamW got them, the state after)."""
        model, opt = self.state.model, self.state.optimizer
        losses: List[torch.Tensor] = []
        first: Dict[str, torch.Tensor] = {}

        def recorded(state, batch):
            state, loss = self.step(state, batch)
            losses.append(loss)
            if len(losses) == 1:
                b1 = opt.param_groups[0]["betas"][0]
                first.update((k, opt.state[p]["exp_avg"] / (1 - b1))
                             for k, p in model.named_parameters())
            return state, loss

        train_one_epoch(self.state, recorded,
                        device_prefetch(iter(self.checked_batches), self.device))
        after = {k: v.detach().clone() for k, v in model.state_dict().items()
                 if not k.endswith("num_batches_tracked")}
        return [float(x) for x in losses], first, after

    def _fed(self, epoch: int, w: Window, end: int):
        """Epoch ``epoch``'s batches through ``device_prefetch`` until
        ``end``; each wait for the next is a ``feed`` span."""
        real = collections.deque()  # each batch's real rows, from the producer

        def counted():
            for b in self.src.epoch(epoch):
                real.append(int(b["mask"].sum()))
                yield b

        batches = device_prefetch(counted(), self.device)
        try:
            while now() < end:
                s = now()
                b = next(batches, None)
                if b is None:
                    return
                w.spans.add("feed", s, now())
                w.steps += 1
                w.records += real.popleft()
                yield b
        finally:
            batches.close()

    def window(self, seconds: float, w: Window, on_start: Callable[[], None]) -> None:
        spans = w.spans

        def step(state, batch):
            s = now()
            out = self.step(state, batch)
            spans.add("step", s, now())
            return out

        on_start()
        w.t0 = now()
        end = w.t0 + int(seconds * 1e9)
        for epoch in itertools.count(1):
            if now() >= end:
                break
            train_one_epoch(self.state, step, self._fed(epoch, w, end))
        sync(self.device)
        w.t1 = now()
        w.attempted = w.steps
        w.flops = roofline.train_flops(self.cfg, w.records)

    def finish(self) -> None:
        """Set the model and optimizer back to the seed's weights and zero
        moments, in place (a captured graph or a cache stays valid), run the
        checked batches through the same step again, and free the state."""
        with torch.no_grad():
            for k, v in self.state.model.state_dict().items():
                v.copy_(self.init[k])
            for st in self.state.optimizer.state.values():
                for v in st.values():
                    if torch.is_tensor(v):
                        v.zero_()
        self.state.step = 0
        self.runs.append(self._checked_steps())
        self.state = self.init = None

    def _reference(self, precision: str = "f32", rows: Optional[int] = None):
        keys = ("ecg", "y", "demo") if self.mm else ("ecg", "y")
        batches = [{k: torch.as_tensor(b[k], device=self.device) for k in keys}
                   for b in self.checked_batches]
        return reference.train_steps(self.w0, self.cfg, batches, self.traffic["lr"],
                                     self.traffic["weight_decay"], precision, rows=rows)

    def check(self) -> Dict[str, float]:
        ref = self._reference()
        readings = [train_gaps(r, ref, self.w0) for r in self.runs]
        return {k: max(r[k] for r in readings) for k in readings[0]}

    def control(self) -> Dict[str, float]:
        """The check's numbers with the reference in TF32 in the program's
        place, and with the reference trained on half of each batch (the mean
        over the rest), each against the float32 reference; and the
        program's own, with its worst leaves."""
        ref = self._reference()
        low = train_gaps(self._reference(self.traffic["control"]), ref, self.w0)
        half = train_gaps(self._reference(rows=self.traffic["batch"] // 2), ref, self.w0)
        own = {}
        for i, r in enumerate(self.runs):
            own.update({f"program{i}.{k}": v
                        for k, v in train_gaps(r, ref, self.w0, detail=True).items()})
        return {**low, **{"half_batch." + k: v for k, v in half.items()}, **own}
