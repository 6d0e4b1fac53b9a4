"""Batch pipeline: shuffle, fixed-shape padded batches, device prefetch
(port of ``ptbxl_tpu/data/pipeline.py``).

* ``BatchSource`` yields host batches ``{"y" [B, L] f32, "mask" [B] f32,
  "demo" [B, 5] f32 when the dataset has ``demo``}`` plus either ``"ecg"``
  ``[B, T, leads]`` f32 raw physical signals or, with ``emit_adc=True``,
  ``"adc_lt"`` ``[B, leads, T]`` int16 (the ADC cache's own layout) with
  ``"gain"`` / ``"baseline"`` ``[B, leads]`` f32, which the device converts.
  The epoch order is ``default_rng(seed + epoch)``'s shuffle; the last
  partial batch is padded to the full batch size by wrapping the epoch order
  (distinct records: train-mode BatchNorm sees pad rows, the mask keeps them
  out of the loss only).
* Where the signals come from (``reader``): the int16 ADC cache
  (``"adc_cache"``, ``data/cache.py``) for a PTB-XL dataset (one with
  ``base_dir`` and ``df``) when ``use_adc_cache``; otherwise per batch, the
  threaded C++ decoder (``"native"``, every record plain format 16) or a
  thread pool over ``get_raw`` (``"python"``), as
  ``ptbxl_tpu/data/pipeline.py:27-133`` does.  Any dataset with ``y``,
  ``__len__`` and ``get_raw(idx) -> [leads, T]`` works without the cache.
* ``device_prefetch`` copies the next batches to the device from a
  background thread while the current step runs; an ``"adc_lt"`` batch
  becomes ``"ecg"`` on the device through ``ops/adc_convert.py``.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ptbxl_torch.data.cache import ADCCache, gather_records
from ptbxl_torch.io import native
from ptbxl_torch.io.wfdb_io import read_header
from ptbxl_torch.ops.adc_convert import adc_lt_to_physical_batch
from ptbxl_torch.utils.device import DeviceLike, resolve_device
from ptbxl_torch.utils.profiling import span


class _ParallelRecordReader:
    """Per-batch parallel decode for datasets without an ADC cache.

    Single-file format-16 records (every PTB-XL record) of a dataset with
    ``record_path`` batch-decode through the threaded C++ decoder; anything
    else goes through a thread pool over ``get_raw``.
    """

    def __init__(self, ds, n_threads: Optional[int] = None):
        self.ds = ds
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._native = hasattr(ds, "record_path") and native.available()
        self._hdr: Dict[int, Optional[tuple]] = {}

    def _header(self, idx: int):
        """Memoized (dat_path, gains, baselines, T, L), or None if the record
        is not native-decodable."""
        if idx not in self._hdr:
            info = None
            try:
                rec = self.ds.record_path(idx)
                h = read_header(rec)
                plain = len({s.file_name for s in h.signals}) == 1 and all(
                    s.fmt == 16 and s.byte_offset == 0 and s.samps_per_frame == 1 and s.skew == 0
                    for s in h.signals)
                if plain:
                    info = (os.path.join(os.path.dirname(rec), h.signals[0].file_name),
                            np.array([s.gain for s in h.signals], np.float32),
                            np.array([s.effective_baseline for s in h.signals], np.float32),
                            h.n_samples, h.n_sig)
            except Exception:  # noqa: BLE001 -- the Python reader takes it
                info = None
            self._hdr[idx] = info
        return self._hdr[idx]

    def read(self, idx: np.ndarray) -> np.ndarray:
        """Decode the batch -> physical float32 [B, leads, T]."""
        if self._native:
            infos = [self._header(int(i)) for i in idx]
            if all(i is not None for i in infos) and len({i[3:] for i in infos}) == 1:
                t, n_leads = infos[0][3], infos[0][4]
                adc, ok = native.decode_batch_fmt16([i[0] for i in infos], t, n_leads,
                                                    n_threads=self.n_threads)  # [B, L, T]
                if ok.all():
                    gains = np.stack([i[1] for i in infos])[:, :, None]
                    bases = np.stack([i[2] for i in infos])[:, :, None]
                    phys = (adc.astype(np.float32) - bases) / gains
                    phys[adc == -32768] = np.nan
                    return phys
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.n_threads)
        return np.stack([np.asarray(v, np.float32)
                         for v in self._pool.map(self.ds.get_raw, [int(i) for i in idx])])


class BatchSource:
    """Assembles host batches from a dataset (through an ADCCache when it can)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int = 42,
                 use_adc_cache: bool = True, emit_adc: bool = False):
        """``emit_adc=True`` ships int16 ADC + per-lead gain/baseline and leaves
        the physical conversion to the device: half the H2D bytes of the f32
        path.  It needs the ADC cache; without one, batches carry ``"ecg"``."""
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.n = len(dataset)
        self.has_demo = hasattr(dataset, "demo")
        self._cache: Optional[ADCCache] = None
        if use_adc_cache and self.n > 0 and hasattr(dataset, "base_dir") and hasattr(dataset, "df"):
            try:
                self._cache = ADCCache(dataset.base_dir, list(dataset.df["filename_hr"])
                                       ).ensure_built()
            except Exception as e:  # non-uniform lengths etc. -> per-record reads
                print(f"[BatchSource] ADC cache unavailable ({e}); "
                      "falling back to per-record reads")
                self._cache = None
        self.emit_adc = emit_adc and self._cache is not None
        self._reader = None if self._cache is not None else _ParallelRecordReader(dataset)

    @property
    def reader(self) -> str:
        """Where the signals come from: "adc_cache", "native" or "python"."""
        if self._cache is not None:
            return "adc_cache"
        return "native" if self._reader._native else "python"

    @property
    def steps_per_epoch(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def _signals(self, idx: np.ndarray) -> np.ndarray:
        if self._cache is not None:
            return self._cache.get_physical(idx)  # [B, L, T]
        return self._reader.read(idx)

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
            }
            if self.emit_adc:
                c = self._cache
                # the memmap's own [B, L, T] layout, untouched: the host only
                # gathers; the transpose and conversion run on the device
                batch["adc_lt"] = gather_records(c._adc, idx)
                batch["gain"] = c._gain[idx]
                batch["baseline"] = c._baseline[idx]
            else:
                batch["ecg"] = np.ascontiguousarray(self._signals(idx).transpose(0, 2, 1),
                                                    dtype=np.float32)
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
    its memory until the consumer's work is done.  An ``"adc_lt"`` batch is
    converted to ``"ecg"`` on the side stream, after its copies
    (``adc_lt_to_physical_batch``: ``(adc - baseline) / gain`` in f32, the
    sentinel to NaN, the host float path's arithmetic).  A producer error is
    raised in the consumer; a consumer that stops early releases the producer
    and drops the queued batches.

    Under a ``torch.profiler`` session (``utils/profiling.py``) the consumer
    records ``prefetch.wait`` around each take of a batch (the wait for the
    queue, the stream wait and ``record_stream``), and the
    producer's thread a root ``prefetch.batch`` a batch, holding
    ``prefetch.read`` (the host iterator's next batch), ``prefetch.pin``
    (contiguous, and on a GPU pinned) and on a GPU ``prefetch.copy`` (the
    side stream's copies and conversion; ``bytes``).
    """
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    error = []
    closed = threading.Event()

    def convert(out):
        if "adc_lt" in out:
            out["ecg"] = adc_lt_to_physical_batch(out.pop("adc_lt"), out.pop("gain"),
                                                  out.pop("baseline"))
        return out

    def to_device(batch):
        with span("prefetch.pin"):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
            if side is not None:
                out = {k: v.pin_memory() for k, v in out.items()}
        if side is None:
            return convert(out), None
        with span("prefetch.copy", bytes=sum(v.nbytes for v in out.values())):
            with torch.cuda.stream(side):
                out = convert({k: v.to(dev, non_blocking=True) for k, v in out.items()})
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
            it = iter(host_iter)
            while True:
                with span("prefetch.batch"):
                    with span("prefetch.read"):
                        batch = next(it, end)
                    if batch is end:
                        break
                    item = to_device(batch)
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            error.append(e)
        finally:
            put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            with span("prefetch.wait"):
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
