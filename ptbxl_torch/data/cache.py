"""Lossless int16 ADC record cache (port of ``ptbxl_tpu/data/cache.py``).

The first pass decodes each record once into one memory-mapped int16 array
``[N, leads, T]`` plus per-lead gain and baseline arrays; every later read is
a row gather + ``(adc - baseline) / gain`` in f32, with the missing-sample
sentinel (-32768) restored to NaN.  Lossless: format 16 stores int16 ADC.

Files live under ``<base_dir>/.ptbxl_torch_cache/`` (the JAX package's
directory is ``.ptbxl_tpu_cache``), keyed as the JAX package keys them: a
hash of the record list and each ``.dat``'s size and mtime, so distinct
splits coexist and a record replaced in place invalidates its cache.
The PTB-XL case (format 16, one ``.dat`` a record, no byte offset) decodes
through the threaded C++ decoder (``io/native.py``); anything else, or no
compiler, goes through the Python reader with the int16-range and sentinel
checks of ``ptbxl_tpu/data/cache.py:159-179``.  ``decoder`` says which ran
("native", "python", or "cached" when the files were already there).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence

import numpy as np

from ptbxl_torch.data.manifest import CACHE_DIRNAME
from ptbxl_torch.io import native
from ptbxl_torch.io.wfdb_io import read_adc, read_header

_SENTINEL16 = -32768


def gather_records(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``arr[idx]`` materialized contiguously (the warm-cache hot path), by the
    native threaded row gather when the C++ library is available."""
    idx = np.asarray(idx)
    if idx.dtype == bool:  # numpy's fancy-index semantics for boolean masks
        idx = np.nonzero(idx)[0]
    idx = idx.astype(np.int64, copy=False)
    if native.available():
        return native.gather_rows(arr, idx)
    return np.asarray(arr[idx])


def _key(base_dir: str, rel_paths: Sequence[str]) -> str:
    """Cache key over the record list and each .dat's (size, mtime)."""
    h = hashlib.sha1("\n".join(rel_paths).encode())
    for p in rel_paths:
        try:
            st = os.stat(os.path.join(base_dir, p) + ".dat")
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
        except OSError:
            h.update(b"missing")
    return h.hexdigest()[:16]


def _native_decodable(headers) -> bool:
    return all(
        len({s.file_name for s in h.signals}) == 1
        and all(s.fmt == 16 and s.byte_offset == 0 and s.samps_per_frame == 1 and s.skew == 0
                for s in h.signals)
        for h in headers)


class ADCCache:
    """Decode-once memmap cache of a fixed record list."""

    def __init__(self, base_dir: str, rel_paths: Sequence[str], cache_dir: Optional[str] = None):
        self.base_dir = base_dir
        self.rel_paths = list(rel_paths)
        self.cache_dir = cache_dir or os.path.join(base_dir, CACHE_DIRNAME)
        self._adc: Optional[np.memmap] = None
        self._gain: Optional[np.ndarray] = None
        self._baseline: Optional[np.ndarray] = None
        self.n_leads = 0
        self.n_samples = 0
        self.decoder: Optional[str] = None

    def _paths(self):
        k = _key(self.base_dir, self.rel_paths)
        return (os.path.join(self.cache_dir, f"adc_{k}.bin"),
                os.path.join(self.cache_dir, f"adc_{k}.meta.npz"))

    def ensure_built(self, verbose: bool = True) -> "ADCCache":
        bin_path, meta_path = self._paths()
        if os.path.exists(bin_path) and os.path.exists(meta_path):
            self._open()
            self.decoder = self.decoder or "cached"
            return self

        os.makedirs(self.cache_dir, exist_ok=True)
        n = len(self.rel_paths)
        headers = [read_header(os.path.join(self.base_dir, p)) for p in self.rel_paths]
        T, L = headers[0].n_samples, headers[0].n_sig
        self.n_samples, self.n_leads = T, L
        for rel, h in zip(self.rel_paths, headers):
            if (h.n_samples, h.n_sig) != (T, L):
                raise ValueError(
                    f"Record {rel} shape {(h.n_samples, h.n_sig)} != cache shape {(T, L)}; "
                    "ADCCache requires uniform record length")

        mm = np.lib.format.open_memmap(bin_path + ".tmp", mode="w+", dtype=np.int16,
                                       shape=(n, L, T))
        gains = np.array([[s.gain for s in h.signals] for h in headers], dtype=np.float32)
        baselines = np.array([[s.effective_baseline for s in h.signals] for h in headers],
                             dtype=np.float32)

        self.decoder = "python"
        if _native_decodable(headers):
            try:
                if not native.available():
                    raise RuntimeError(native.build_error())
                dat_paths = [os.path.join(os.path.dirname(os.path.join(self.base_dir, rel)),
                                          h.signals[0].file_name)
                             for rel, h in zip(self.rel_paths, headers)]
                chunk = 1024
                for i0 in range(0, n, chunk):
                    i1 = min(i0 + chunk, n)
                    _, ok = native.decode_batch_fmt16(dat_paths[i0:i1], T, L, out=mm[i0:i1])
                    if not ok.all():
                        bad = [dat_paths[i0 + j] for j in np.nonzero(~ok)[0]]
                        raise RuntimeError(f"native decode failed for {bad[:3]}")
                    if verbose and i1 % 4096 < chunk:
                        print(f"[ADCCache] decoded {i1}/{n} records (native)")
                self.decoder = "native"
            except Exception as e:  # no toolchain etc. -> the Python reader
                if verbose:
                    print(f"[ADCCache] native decoder unavailable ({e}); python fallback")

        if self.decoder == "python":
            for i, rel in enumerate(self.rel_paths):
                adc, _ = read_adc(os.path.join(self.base_dir, rel), headers[i])
                # an int16 store: refuse records whose ADC values do not fit
                # (fmt 24/32) or that decode to frame-averaged floats, instead of
                # saturating or garbling them
                if adc.dtype != np.int32 or adc.min() < -32768 or adc.max() > 32767:
                    raise ValueError(
                        f"record {rel} has ADC samples outside int16 (or "
                        "frame-averaged float frames); the int16 ADC cache "
                        "cannot store it losslessly — run with "
                        "use_adc_cache=False for this dataset")
                # -32768 is the missing-sample marker only in fmt 16/61/160; in
                # other formats it would silently read back as NaN
                if (adc == _SENTINEL16).any() and any(
                        s.fmt not in (16, 61, 160) for s in headers[i].signals):
                    raise ValueError(
                        f"record {rel} (fmt "
                        f"{sorted({s.fmt for s in headers[i].signals})}) contains "
                        "ADC value -32768, which the int16 cache reserves as the "
                        "NaN sentinel — run with use_adc_cache=False for this "
                        "dataset")
                mm[i] = adc.T.astype(np.int16)
                if verbose and (i + 1) % 2000 == 0:
                    print(f"[ADCCache] decoded {i + 1}/{n} records")

        mm.flush()
        del mm
        np.savez(meta_path, gains=gains, baselines=baselines, n_samples=T, n_leads=L)
        os.replace(bin_path + ".tmp", bin_path)
        self._open()
        if verbose:
            print(f"[ADCCache] built cache for {n} records at {bin_path}")
        return self

    def _open(self):
        bin_path, meta_path = self._paths()
        self._adc = np.load(bin_path, mmap_mode="r")
        meta = np.load(meta_path)
        self._gain = meta["gains"]
        self._baseline = meta["baselines"]
        self.n_samples = int(meta["n_samples"])
        self.n_leads = int(meta["n_leads"])

    def __len__(self):
        return len(self.rel_paths)

    def get_physical(self, indices: Sequence[int]) -> np.ndarray:
        """float32 physical signals [B, leads, T] with NaN for sentinels."""
        if self._adc is None:
            self.ensure_built()
        idx = np.asarray(indices)
        adc_i16 = gather_records(self._adc, idx)  # [B, L, T], one memmap read
        adc = adc_i16.astype(np.float32)
        gain = self._gain[idx][:, :, None]
        baseline = self._baseline[idx][:, :, None]
        phys = (adc - baseline) / gain
        phys[adc_i16 == _SENTINEL16] = np.nan
        return phys
