"""P1's TF32 dot against its split-K variant, on the card, in turns.

    python -m ptbxl_torch.tools.tune_dot [--iters 20] [--out PATH]

Builds ``ptbxl_torch/tools/dot_splitk.cu`` (the variant: a cluster of four
CTAs splits K of one 64 x 128 tile and adds its partial sums through
distributed shared memory; the file says more) under
``build/ptbxl_torch/tune_dot/``, holds it against the plain version at
``dot_tol`` in both forms at the probes' shapes (p1 TN, p2 NT), and times it
beside the shipped kernel (``probes.tn_dot`` / ``nt_dot``) in CUDA graphs, in
turns (shipped, variant, variant, shipped), with ``torch.matmul`` in TF32
after them.  Prints one JSON object: each side's graph microseconds a call,
the variant's errors and shared bytes a CTA, and how many of its clusters
the card holds at once (the probes need 32).  Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.kernels import probes as kp
from ptbxl_torch.tools.probe_dispatch import graph_ms
from ptbxl_torch.tools.probe_mosaic import dot_tol, normal

SOURCE = Path(__file__).resolve().with_name("dot_splitk.cu")
OUT_DIR = _build.BUILD_DIR / "tune_dot"
_P, _I, _L = _build.VOIDP, _build.INT, ctypes.c_longlong


def build():
    """The variant's library (``ptbxl_probe_dot_splitk``) and its
    ``ptbxl_probe_dot_splitk_clusters``, which takes no device or stream."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / "libdot_splitk.so"
    proc = subprocess.run(_build.nvcc_command(SOURCE, lib), capture_output=True, text=True)
    (OUT_DIR / "libdot_splitk.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    clusters = ctypes.CDLL(str(lib)).ptbxl_probe_dot_splitk_clusters
    clusters.argtypes, clusters.restype = [_I, _I, _L, ctypes.POINTER(_I)], ctypes.c_int
    # a, b, c, M, N, K, sam, sak, sbk, sbn, the shared bytes out
    return _build.Library("dot_splitk", {
        "ptbxl_probe_dot_splitk": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, ctypes.POINTER(_L)]},
        lib), clusters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_dot: needs a CUDA GPU", file=sys.stderr)
        return 2
    so, clusters_of = build()
    dev = torch.device("cuda")
    m, n, k = 2048, 128, 256
    forms = {
        "p1": (normal((k, m), 0, dev), normal((k, n), 1, dev), (1, m, n, 1), kp.tn_dot,
               kp.tn_dot_plain, lambda a, b: dot_tol(a, b), lambda a, b: torch.matmul(a.t(), b)),
        "p2": (normal((m, k), 0, dev), normal((n, k), 1, dev), (k, 1, 1, k), kp.nt_dot,
               kp.nt_dot_plain, lambda a, b: dot_tol(a.t(), b.t()),
               lambda a, b: torch.matmul(a, b.t())),
    }
    result = {"device": torch.cuda.get_device_name(0), "iters": args.iters}
    ok = True
    with torch.no_grad():
        for name, (a, b, strides, shipped, plain, tol, library) in forms.items():
            c = torch.empty(m, n, device=dev)
            smem = _L(0)

            def variant(a=a, b=b, c=c, strides=strides, smem=smem):
                so.launch("ptbxl_probe_dot_splitk", a, b, c, m, n, k, *strides,
                          ctypes.byref(smem))
                return c

            err = float((variant() - plain(a, b)).abs().max())
            clusters = _I(0)
            clusters_of(int(strides[1] == 1), int(strides[2] == 1), smem.value,
                        ctypes.byref(clusters))
            row = {"max_abs_err": err, "tol": tol(a, b), "smem_bytes": smem.value,
                   "clusters_at_once": clusters.value, "shipped_us": [], "variant_us": []}
            ok &= err <= row["tol"]
            for side in ("shipped", "variant", "variant", "shipped"):
                fn = (lambda: shipped(a, b)) if side == "shipped" else variant
                row[f"{side}_us"].append(graph_ms(fn, args.iters, dev) * 1e3)
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                row["matmul_tf32_us"] = graph_ms(lambda: library(a, b), args.iters, dev) * 1e3
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
            result[name] = row
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
