"""Build, load and launch the port's CUDA kernels (``ptbxl_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, all sources in parallel, at first use.  Every source includes
``csrc/hopper.cuh``: the Hopper PTX helpers, the device guard
(``ptbxl_ensure_device``) and ``ptbxl_strerror``.  ``nvcc_command`` is the one
command line, for these libraries and for the copies and variants the tools
build elsewhere.  The libraries go to ``build/ptbxl_torch/<hash>/`` beside
the package, keyed by a hash of the sources (the header with them) and
flags, so a changed source rebuilds and an unchanged one loads.  A
``Library`` binds one with ``ctypes`` and launches its C entries: every
entry is ``int entry(int device, ..., void* stream)`` and returns
``cudaGetLastError()``, and a non-zero code raises.  A missing ``nvcc`` or a
failed build raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ptbxl_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

VOIDP = ctypes.c_void_p  # every pointer and the stream: a bare int would be cut to 32 bits
INT = ctypes.c_int


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the ptbxl_torch CUDA "
            "kernels are built from source at first use"
        )
    return path


def nvcc_command(source: Path, output: Path) -> List[str]:
    """``nvcc`` building ``source`` into the shared library ``output`` with the
    port's flags; ``-I csrc`` lets a copy of a source written elsewhere find
    ``hopper.cuh``."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(output), str(source)]


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
        procs = []
        for s in todo:
            tmp = libs[s.stem].with_suffix(f".so.tmp{os.getpid()}")
            procs.append((s, tmp, subprocess.Popen(
                nvcc_command(s, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
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


def raw_stream(device: int) -> int:
    """The current CUDA stream's handle on ``device``, without building a
    ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device)


class Library:
    """The C entries of one kernel library, declared once beside the module
    that owns it.

    ``signatures`` maps each entry to the ctypes of its arguments between
    the device index and the stream, which every entry takes first and last.
    ``path`` is a library a tool built (``nvcc_command``); by default
    ``lib<stem>.so`` from ``build_all``.  ``entries`` holds each entry once
    it is bound (once per process), ``ptbxl_strerror`` too: the seam where
    tests put stand-ins for the C entries.
    """

    def __init__(self, stem: str, signatures: Dict[str, Sequence],
                 path: Optional[Path] = None):
        self.stem, self.signatures, self.path = stem, signatures, path
        self.entries: Dict[str, Callable] = {}
        self._dll: Optional[ctypes.CDLL] = None

    def entry(self, name: str) -> Callable:
        """The C entry ``name``, loading the library (building it first if
        needed) and declaring the entry's types on first use."""
        fn = self.entries.get(name)
        if fn is None:
            if self._dll is None:
                self._dll = ctypes.CDLL(str(self.path or build_all()[self.stem]))
            fn = getattr(self._dll, name)
            if name == "ptbxl_strerror":
                fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
            else:
                fn.argtypes, fn.restype = [INT, *self.signatures[name], VOIDP], ctypes.c_int
            self.entries[name] = fn
        return fn

    def launch(self, name: str, *args) -> None:
        """Call the entry ``name`` as ``(device, *args, stream)``: a tensor
        passes its ``data_ptr()``, None a null pointer, anything else as it
        is; the device is the first tensor's and the stream its current one.
        A non-zero code raises, naming the entry (a refused launch never
        runs)."""
        device, cargs = None, []
        for a in args:
            if isinstance(a, torch.Tensor):
                if device is None:
                    device = a.get_device()
                a = a.data_ptr()
            cargs.append(a)
        if device is None or device < 0:
            raise RuntimeError(f"{name}: the kernels need a CUDA tensor")
        fn = self.entries.get(name)
        if fn is None:
            fn = self.entry(name)
        err = fn(device, *cargs, raw_stream(device))
        if err:
            text = self.entry("ptbxl_strerror")(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err} ({text})")
