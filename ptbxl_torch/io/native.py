"""ctypes bindings for the C++ batch WFDB decoder (port of ``ptbxl_tpu/io/native.py:17-197``).

The source is the port's copy, ``ptbxl_torch/csrc/host/wfdb_decode.cpp``.  At
first use it is compiled with the host C++ compiler (``$CXX``, else ``g++``)
and ``csrc/Makefile``'s flags into ``build/ptbxl_torch/<hash>/libwfdbdecode.so``
beside the CUDA kernels' libraries, keyed by a hash of the source, the
compiler and the flags (its own key: ``_build``'s covers ``csrc/*.cu`` only).
When no compiler is found or the build fails, ``available()`` is False and
the callers fall back to the pure-Python reader (``io/wfdb_io.py``, the
semantic source of truth), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from ptbxl_torch.ops.kernels._build import BUILD_DIR, CSRC

SOURCE = CSRC / "host" / "wfdb_decode.cpp"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall")

_lib = None
_build_error: Optional[str] = None


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX") or "g++")


def library_path(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx,) + CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return str(BUILD_DIR / h.hexdigest()[:16] / "libwfdbdecode.so")


def _make(cxx: str, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    r = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True,
                       timeout=300)
    if r.returncode:
        raise RuntimeError(f"{cxx} failed (exit {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builds agree


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        cxx = _compiler()
        if cxx is None:
            raise RuntimeError("no host C++ compiler ($CXX or g++)")
        path = library_path(cxx)
        if not os.path.exists(path):
            _make(cxx, path)
        lib = ctypes.CDLL(path)
    except Exception as e:  # noqa: BLE001 -- recorded; callers take the Python reader
        _build_error = f"{type(e).__name__}: {e}"
        return None
    lib.wfdb_decode_batch_fmt16.restype = ctypes.c_int
    lib.wfdb_decode_batch_fmt16.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.wfdb_gather_rows.restype = None
    lib.wfdb_gather_rows.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.wfdb_adc_to_physical.restype = None
    lib.wfdb_adc_to_physical.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded or was not tried)."""
    return _build_error


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native WFDB decoder unavailable ({_build_error})")
    return lib


def decode_batch_fmt16(
    dat_paths: List[str],
    n_samples: int,
    n_sig: int,
    out: Optional[np.ndarray] = None,
    n_threads: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode format-16 .dat files -> (adc [n, n_sig, n_samples] int16, ok [n] bool)."""
    lib = _need()
    n = len(dat_paths)
    if out is None:
        out = np.zeros((n, n_sig, n_samples), dtype=np.int16)
    # a real raise, not an assert: it guards a raw C write and must survive -O
    if out.shape != (n, n_sig, n_samples) or out.dtype != np.int16 or not out.flags.c_contiguous:
        raise ValueError(f"out buffer must be C-contiguous int16 {(n, n_sig, n_samples)}; "
                         f"got {out.dtype} {out.shape}")
    status = np.zeros(n, dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in dat_paths])
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    lib.wfdb_decode_batch_fmt16(
        c_paths, n, n_samples, n_sig,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads,
    )
    return out, status == 0


def gather_rows(
    src: np.ndarray,
    indices: np.ndarray,
    out: Optional[np.ndarray] = None,
    n_threads: Optional[int] = None,
) -> np.ndarray:
    """Threaded ``out[i] = src[indices[i]]`` over axis 0 of a C-contiguous
    array (memmaps too: the warm-cache batch-assembly hot path)."""
    lib = _need()
    if not src.flags.c_contiguous:
        raise ValueError("gather_rows requires a C-contiguous source")
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    n = len(idx)
    if n and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError("gather_rows index out of range")
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    if out is None:
        out = np.empty((n,) + src.shape[1:], dtype=src.dtype)
    if not out.flags.c_contiguous or out.dtype != src.dtype or out.shape != (n,) + src.shape[1:]:
        raise ValueError(f"out must be C-contiguous {src.dtype} of shape {(n,) + src.shape[1:]}")
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    lib.wfdb_gather_rows(
        ctypes.cast(src.ctypes.data, ctypes.POINTER(ctypes.c_uint8)),
        row_bytes,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads,
    )
    return out


def adc_to_physical(adc: np.ndarray, gains: np.ndarray, baselines: np.ndarray) -> np.ndarray:
    """adc [n_sig, T] int16 -> physical float32 with NaN sentinels
    (``(adc - baseline) * (1 / gain)`` in f32, as the C++ source computes it)."""
    lib = _need()
    adc = np.ascontiguousarray(adc, dtype=np.int16)
    n_sig, t = adc.shape
    gains = np.ascontiguousarray(gains, dtype=np.float32)
    baselines = np.ascontiguousarray(baselines, dtype=np.float32)
    phys = np.empty((n_sig, t), dtype=np.float32)
    lib.wfdb_adc_to_physical(
        adc.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n_sig, t,
        gains.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        baselines.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        phys.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return phys
