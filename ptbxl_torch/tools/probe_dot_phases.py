"""Where the TF32 dot's time goes inside a CTA (P1's p1 and p2), on the card.

    python -m ptbxl_torch.tools.probe_dot_phases [--reps 5]

Builds a copy of ``ptbxl_torch/csrc/probes.cu`` with timestamps added to
``dot_wgmma_tf32_kernel`` (``build/ptbxl_torch/phases/``; thread 0 of each
CTA records ``clock64`` at three points and ``%globaltimer`` at its start and
end), runs p1 and p2 at the probes' shapes and prints one JSON object: for
each probe, the median and the largest over the CTAs of the SM cycles from
the CTA's start until

* ``landed``: both operands are in shared memory and B is rounded into its
  core-matrix order (B's pass overlaps A's landing);
* ``products``: the last chunk of ``wgmma`` products is done (A's fragment
  loads and the products);
* ``stored``: the tile of C is written;

and the spread of the CTAs' start times and the last end, in ns from the
first start.  No tool on the machine profiles inside a kernel (``ncu`` does
not run there), so this is how the kernel's design was measured.  Needs the
card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from typing import Dict

import torch

from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.kernels import probes as kp

OUT_DIR = _build.BUILD_DIR / "phases"
SLOTS = 8  # a CTA's record: start ns, 3 unused, landed, products, stored, end ns

# (anchor in probes.cu, text put after it)
PATCHES = (
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "  unsigned long long* rec_ = g_phases + (size_t)(blockIdx.x * gridDim.y + blockIdx.y) * 8;\n"
     "  const unsigned long long c0_ = clock64();\n"
     "  if (tid == 0 && blockIdx.x * gridDim.y + blockIdx.y < kMaxCtas) rec_[0] = now_ns();\n"),
    ("  const int g = lane >> 2, t = lane & 3, r0 = warp * 16 + g;\n",
     "  if (tid == 0 && blockIdx.x * gridDim.y + blockIdx.y < kMaxCtas) rec_[4] = clock64() - c0_;\n"),
    ("  wg_wait<0>();\n#pragma unroll\n  for (int i = 0; i < 16; ++i) pin(acc[i]);\n",
     "  if (tid == 0 && blockIdx.x * gridDim.y + blockIdx.y < kMaxCtas) rec_[5] = clock64() - c0_;\n"),
    ("make_float2(acc[4 * i + 2], acc[4 * i + 3]);\n  }\n",
     "  if (tid == 0 && blockIdx.x * gridDim.y + blockIdx.y < kMaxCtas) {\n"
     "    rec_[6] = clock64() - c0_;\n    rec_[7] = now_ns();\n  }\n"),
)
HEADER_ANCHOR = "// kAK: A(m, k) at a[m*lda + k] (rows along K)"
HEADER = """constexpr unsigned kMaxCtas = 1024;
__device__ unsigned long long g_phases[kMaxCtas * 8];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
READER = """
extern "C" int ptbxl_phases_read(void* host, int ctas) {
  return (int)cudaMemcpyFromSymbol(host, g_phases, (size_t)ctas * 8 * 8);
}
"""


def instrumented_source(src: str) -> str:
    """``probes.cu`` with the timestamps; raises if an anchor is missing (the
    kernel changed and the patches must follow it)."""
    for anchor, text in ((HEADER_ANCHOR, None),) + PATCHES:
        if src.count(anchor) != 1:
            raise ValueError(f"probe_dot_phases: anchor not found once in probes.cu: {anchor!r}")
    src = src.replace(HEADER_ANCHOR, HEADER + HEADER_ANCHOR)
    for anchor, text in PATCHES:
        src = src.replace(anchor, anchor + text)
    return src + READER


def build():
    """The instrumented probes library and its ``ptbxl_phases_read``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT_DIR / "probes_phases.cu", OUT_DIR / "libprobes_phases.so"
    cu.write_text(instrumented_source((_build.CSRC / "probes.cu").read_text()))
    proc = subprocess.run(_build.nvcc_command(cu, lib), capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {cu}:\n{proc.stdout}{proc.stderr}")
    read = ctypes.CDLL(str(lib)).ptbxl_phases_read
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    return _build.Library("probes_phases", kp.LIB.signatures, lib), read


def phases(so: _build.Library, read, form: str, reps: int) -> Dict[str, object]:
    from ptbxl_torch.tools.probe_mosaic import normal

    dev = torch.device("cuda")
    m, n, k = 2048, 128, 256
    if form == "tn":
        a, b, strides = normal((k, m), 0, dev), normal((k, n), 1, dev), (1, m, n, 1)
    else:
        a, b, strides = normal((m, k), 0, dev), normal((n, k), 1, dev), (k, 1, 1, k)
    plan = kp.dot_plan(m, n, k, form == "nt", form == "nt")
    c = torch.empty(m, n, device=dev)
    for _ in range(reps):  # the last run's records are read
        so.launch("ptbxl_probe_dot", a, b, c, m, n, k, *strides, 1, *plan.grid, plan.smem_bytes)
    torch.cuda.synchronize()
    want = kp.tn_dot_plain(a, b) if form == "tn" else kp.nt_dot_plain(a, b)
    buf = (ctypes.c_ulonglong * (plan.ctas * SLOTS))()
    if read(ctypes.cast(buf, ctypes.c_void_p), plan.ctas):
        raise RuntimeError("reading the phase records failed")
    rows = [list(buf[i * SLOTS:(i + 1) * SLOTS]) for i in range(plan.ctas)]
    t0 = min(r[0] for r in rows)
    out: Dict[str, object] = {"ctas": plan.ctas, "max_abs_err": float((c - want).abs().max())}
    for name, slot in (("landed", 4), ("products", 5), ("stored", 6)):
        out[f"{name}_cycles"] = {"median": statistics.median(r[slot] for r in rows),
                                 "max": max(r[slot] for r in rows)}
    out["start_ns_spread"] = max(r[0] for r in rows) - t0
    out["last_end_ns"] = max(r[7] for r in rows) - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_dot_phases: needs a CUDA GPU", file=sys.stderr)
        return 2
    so, read = build()
    result = {"device": torch.cuda.get_device_name(0),
              "p1": phases(so, read, "tn", args.reps), "p2": phases(so, read, "nt", args.reps)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
