"""Batch pipeline: shuffle, fixed-shape padded batches, device prefetch
(port of ``ptbxl_tpu/data/pipeline.py:100-261``).

* ``BatchSource`` yields host batches ``{"ecg" [B, T, leads] f32 raw,
  "y" [B, L] f32, "mask" [B] f32, "demo" [B, 5] f32 when the dataset has
  ``demo``}``.  The epoch order is ``default_rng(seed + epoch)``'s shuffle;
  the last partial batch is padded to the full batch size by wrapping the
  epoch order (distinct records: train-mode BatchNorm sees pad rows, the
  mask keeps them out of the loss only).  The dataset needs ``y``,
  ``__len__`` and ``get_raw(idx) -> [leads, T]``.  The ADC cache, the
  native-decoder reader and the device-side ADC conversion
  (``ops/adc_convert.py``) come with the data layer.
* ``device_prefetch`` copies the next batches to the device from a
  background thread while the current step runs.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ptbxl_torch.utils.device import DeviceLike, resolve_device


class BatchSource:
    """Assembles host batches from a dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int = 42):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.n = len(dataset)
        self.has_demo = hasattr(dataset, "demo")

    @property
    def steps_per_epoch(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def _signals(self, idx: np.ndarray) -> np.ndarray:
        return np.stack([np.asarray(self.ds.get_raw(int(i)), np.float32) for i in idx])

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        bs = self.batch_size
        for start in range(0, self.n, bs):
            idx = order[start:start + bs]
            real = len(idx)
            if real < bs:  # pad to the fixed shape by wrapping the epoch order
                idx = np.concatenate([idx, np.resize(order, bs - real)])
            batch = {
                "y": self.ds.y[idx].astype(np.float32),
                "mask": (np.arange(bs) < real).astype(np.float32),
                "ecg": np.ascontiguousarray(self._signals(idx).transpose(0, 2, 1),
                                            dtype=np.float32),
            }
            if self.has_demo:
                batch["demo"] = self.ds.demo[idx].astype(np.float32)
            yield batch


def device_prefetch(
    host_iter: Iterator[Dict[str, np.ndarray]],
    device: DeviceLike = None,
    depth: int = 2,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Move batches to ``device`` ahead of consumption (at most ``depth`` queued).

    On a GPU a producer thread copies each batch from pinned host memory with
    ``non_blocking`` copies on a side stream and records an event; the
    consumer's stream waits for that event before it uses the batch, and each
    tensor is marked as used by the consumer's stream, so the allocator keeps
    its memory until the consumer's work is done.  A producer error is raised in the consumer; a consumer that stops early
    releases the producer and drops the queued batches.
    """
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    error = []
    closed = threading.Event()

    def to_device(batch):
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if side is None:
            return out, None
        with torch.cuda.stream(side):
            out = {k: v.pin_memory().to(dev, non_blocking=True) for k, v in out.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def put(item) -> bool:
        # a bounded put that gives up once the consumer is gone, so an
        # abandoned generator does not leave the producer blocked forever
        # holding device batches
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in host_iter:
                if not put(to_device(batch)):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            error.append(e)
        finally:
            put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if error:
                    raise error[0]
                break
            out, ready = item
            if ready is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(ready)
                for v in out.values():
                    v.record_stream(cur)
            yield out
    finally:
        closed.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
