"""Build and load the port's CUDA kernels (``ptbxl_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, all sources in parallel, at first use.  The libraries go to
``build/ptbxl_torch/<hash>/`` beside the package, keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads.
They are bound with ``ctypes``: every pointer and the stream are
``c_void_p``, every entry returns ``cudaGetLastError()``, and ``check``
raises on a non-zero code.  A missing ``nvcc`` or a failed build raises;
nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ptbxl_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

VOIDP = ctypes.c_void_p  # every pointer and the stream: a bare int would be cut to 32 bits
INT = ctypes.c_int

_libs: Dict[str, ctypes.CDLL] = {}  # loaded once per process


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the ptbxl_torch CUDA "
            "kernels are built from source at first use"
        )
    return path


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built (one ``nvcc`` each, in parallel).

    Returns ``{stem: library path}``.  The compiler's output, including the
    ``-Xptxas -v`` register and shared-memory report, is kept beside each
    library as ``lib<stem>.log``.
    """
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_DIR / _key()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {s.stem: out_dir / f"lib{s.stem}.so" for s in sources}
    todo = [s for s in sources if not libs[s.stem].exists()]
    if todo:
        nvcc = _nvcc()
        procs = []
        for s in todo:
            tmp = libs[s.stem].with_suffix(f".so.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for s, tmp, p in procs:
            log, _ = p.communicate()
            libs[s.stem].with_suffix(".log").write_text(log)
            if p.returncode:
                failed.append(f"nvcc failed for {s.name} (exit {p.returncode}):\n{log}")
            else:
                os.replace(tmp, libs[s.stem])  # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def load_library(stem: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Load ``lib<stem>.so`` (building first if needed) and declare its entries.

    ``signatures`` maps each C entry to its ``argtypes``; every entry returns
    an ``int`` CUDA error code.
    """
    lib = _libs.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[stem]))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.ptbxl_strerror.argtypes = [ctypes.c_int]
        lib.ptbxl_strerror.restype = ctypes.c_char_p
        _libs[stem] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs)."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.ptbxl_strerror(err).decode()})")

