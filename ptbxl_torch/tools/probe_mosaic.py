"""Capability probes on the card (port of ``tools/probe_mosaic.py``, P1).

    python -m ptbxl_torch.tools.probe_mosaic [--iters 20] [--device cpu]

Each probe runs one of the JAX tool's operations (at its shapes, on its
inputs: ``default_rng(0)`` / ``default_rng(1)`` normals) through its kernel
in ``ptbxl_torch/ops/kernels/probes.py`` and prints the JAX tool's line,
``[PASS]/[FAIL] name: err=...`` (the max |diff| against a float64 numpy
reference, as the JAX tool computes it), then the gate against the kernel's
plain version and the device microseconds a call.  A probe passes when the
kernel agrees with its plain version within the probe's tolerance: 0.0 for
data movement, the summation-order bound for sums and dots (``tol``).  With
``--device cpu`` the plain versions run on the host (host clocks: no device
measurement).

``PROBES`` is P1's table (p1-p8); ``tools/probe_mosaic2.py`` (P2) reuses
``run_probe`` and ``main``.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ptbxl_torch.bench import Clock
from ptbxl_torch.ops.kernels import probes as kp
from ptbxl_torch.utils.device import resolve_device

# H100 SXM (data sheet): TF32 and FP32 (no tensor cores) dense rates, HBM3
PEAK_TF32, PEAK_FP32, PEAK_BYTES = 495e12, 67e12, 3.35e12
U32 = 2.0 ** -24  # unit roundoff of f32


@dataclass
class Probe:
    """One probe: ``inputs(device)`` makes its tensors; ``kernel`` / ``plain``
    / ``library`` compute its outputs (a tensor or a tuple); ``reference``
    maps float64 numpy inputs to the JAX tool's numpy reference; ``tol`` is
    the gate of kernel against plain; ``flops`` / ``peak`` its operations."""

    name: str
    label: str
    inputs: Callable[[torch.device], Tuple[torch.Tensor, ...]]
    kernel: Callable
    plain: Callable
    library: Callable
    reference: Callable
    library_name: str
    tol: Callable[..., float] = lambda *xs: 0.0
    flops: Callable[..., float] = lambda *xs: 0.0
    peak: float = PEAK_FP32
    tol_note: str = "exact: data movement"


def normal(shape: Sequence[int], seed: int, device: torch.device) -> torch.Tensor:
    """The JAX tool's input: ``default_rng(seed).standard_normal(shape)`` as f32."""
    x = np.random.default_rng(seed).standard_normal(tuple(shape)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def dot_tol(a_km: torch.Tensor, b_kn: torch.Tensor) -> float:
    """Gate of a dot against its plain version: the two take the same products
    (TF32 products are exact in f32) and differ in the order of the K f32 sums,
    so |diff| <= 2*K*u * max(|A|^T |B|) (u = 2^-24; 2u an addition covers a
    truncating accumulator)."""
    k = a_km.shape[0]
    mag = (a_km.double().abs().t() @ b_kn.double().abs()).max()
    return float(2 * k * U32 * mag)


def _as_tuple(v) -> tuple:
    return v if isinstance(v, tuple) else (v,)


def _np64(xs) -> list:
    return [x.detach().double().cpu().numpy() for x in xs]


def dot_probe(name: str, label: str, form: str, precision: str) -> Probe:
    """p1 (TN, TF32), p2 (NT, TF32), p9 (TN, FP32): K=256, M=2048, N=128."""
    K, M, N = 256, 2048, 128
    if form == "tn":
        def inputs(dev):
            return normal((K, M), 0, dev), normal((K, N), 1, dev)
        kernel = lambda a, b: kp.tn_dot(a, b, precision)  # noqa: E731
        plain = lambda a, b: kp.tn_dot_plain(a, b, precision)  # noqa: E731
        library = lambda a, b: torch.matmul(a.t(), b)  # noqa: E731
        reference = lambda a, b: a.T @ b  # noqa: E731
        tol = dot_tol
    else:
        def inputs(dev):
            return normal((M, K), 0, dev), normal((N, K), 1, dev)
        kernel = lambda a, b: kp.nt_dot(a, b, precision)  # noqa: E731
        plain = lambda a, b: kp.nt_dot_plain(a, b, precision)  # noqa: E731
        library = lambda a, b: torch.matmul(a, b.t())  # noqa: E731
        reference = lambda a, b: a @ b.T  # noqa: E731
        tol = lambda a, b: dot_tol(a.t(), b.t())  # noqa: E731
    return Probe(name, label, inputs, kernel, plain, library, reference,
                 library_name=f"torch.matmul ({precision.upper()})", tol=tol,
                 flops=lambda a, b: 2.0 * K * M * N,
                 peak=PEAK_TF32 if precision == "tf32" else PEAK_FP32,
                 tol_note=f"2*K*u*max(|A|^T|B|), K={K}: f32 sum order, products exact")


def _np_pool(x, axis):
    return np.maximum(x[0::2], x[1::2]) if axis == 0 else np.maximum(x[:, 0::2], x[:, 1::2])


PROBES: List[Probe] = [
    dot_probe("p1", "P1 TN dot_general (contract dim0 x dim0)", "tn", "tf32"),
    dot_probe("p2", "P2 NT dot_general (contract dim1 x dim1)", "nt", "tf32"),
    Probe("p3", "P3 roll lanes+sublanes", lambda d: (normal((64, 2560), 0, d),),
          lambda x: kp.roll_add(x, -5, 3), lambda x: kp.roll_add_plain(x, -5, 3),
          lambda x: torch.roll(x, -5, 1) + torch.roll(x, 3, 0),
          lambda x: np.roll(x, -5, axis=1) + np.roll(x, 3, axis=0), "torch.roll x2 + add"),
    Probe("p4", "P4 sublane-offset block writes (im2col build)",
          lambda d: (normal((16, 1024), 0, d),),
          kp.subblock_rolls, kp.subblock_rolls_plain,
          lambda x: torch.cat([torch.roll(x, -k, 1) for k in range(15)], 0),
          lambda x: np.concatenate([np.roll(x, -k, axis=1) for k in range(15)], axis=0),
          "torch.cat of 15 torch.roll"),
    Probe("p5", "P5 strided slices (pool)", lambda d: (normal((64, 2048), 0, d),),
          lambda x: (kp.pool_slices(x, 0), kp.pool_slices(x, 1)),
          lambda x: (kp.pool_slices_plain(x, 0), kp.pool_slices_plain(x, 1)),
          lambda x: (torch.maximum(x[0::2], x[1::2]), torch.maximum(x[:, 0::2], x[:, 1::2])),
          lambda x: (_np_pool(x, 0), _np_pool(x, 1)), "torch.maximum of strided slices x2"),
    Probe("p6", "P6 unaligned static lane slices", lambda d: (normal((32, 2048), 0, d),),
          lambda x: kp.window_sum(x, 1024), lambda x: kp.window_sum_plain(x, 1024),
          lambda x: kp.window_sum_plain(x, 1024),
          lambda x: sum(x[:, k:k + 1024] for k in range(15)), "15 torch adds of slices",
          tol=lambda x: 1e-5, tol_note="1e-5: 15 f32 additions (the kernel keeps their order)"),
    Probe("p7", "P7 unaligned lane concat (round-1 blocker)",
          lambda d: (normal((512 + 14, 12), 0, d),),
          kp.shifted_concat, kp.shifted_concat_plain,
          lambda x: torch.cat([x[k:k + 512] for k in range(15)], 1),
          lambda x: np.concatenate([x[k:k + 512] for k in range(15)], axis=1),
          "torch.cat of 15 slices"),
    Probe("p8", "P8 in-kernel transpose", lambda d: (normal((2048, 64), 0, d),),
          kp.transpose, kp.transpose_plain, lambda x: x.t().contiguous(), lambda x: x.T,
          ".t().contiguous()"),
]


def bytes_moved(xs, outs) -> int:
    """Each input read once and each output written once."""
    return sum(v.numel() * v.element_size() for v in list(xs) + list(outs))


def run_probe(p: Probe, device: torch.device, iters: int = 20, clock: Optional[Clock] = None
              ) -> dict:
    """One probe: outputs, errors, gate and times (ms a call) on ``device``."""
    clock = clock or Clock(device)
    xs = p.inputs(device)
    got = _as_tuple(p.kernel(*xs))
    want = _as_tuple(p.plain(*xs))
    ref = _as_tuple(p.reference(*_np64(xs)))
    err64 = max(float(np.abs(g.double().cpu().numpy() - r).max()) for g, r in zip(got, ref))
    gate_err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    shapes_ok = all(g.shape == w.shape for g, w in zip(got, want))
    tol = p.tol(*xs)
    row = {"probe": p.name, "label": p.label, "err": err64, "max_abs_err": gate_err,
           "tol": tol, "tol_note": p.tol_note, "ok": shapes_ok and gate_err <= tol,
           "shapes": [list(g.shape) for g in got]}
    nbytes = bytes_moved(xs, got)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = p.flops(*xs) / p.peak * 1e3
    row["bound"] = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
    with torch.no_grad():
        row["ms"] = clock.ms(lambda: p.kernel(*xs), iters)
        row["plain_ms"] = clock.ms(lambda: p.plain(*xs), max(1, iters // 4))
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = p.peak == PEAK_TF32  # the library dot's TF32
        try:
            row["library_ms"] = clock.ms(lambda: p.library(*xs), iters)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    row["library"] = p.library_name
    return row


def line(row: dict, cuda: bool) -> str:
    tag = "PASS" if row["ok"] else "FAIL"
    unit = "device us" if cuda else "host us"
    return (f"[{tag}] {row['label']}: err={row['err']:.2e} | vs plain "
            f"{row['max_abs_err']:.2e} <= {row['tol']:.1e} | {row['ms'] * 1e3:.1f} {unit} "
            f"(plain {row['plain_ms'] * 1e3:.1f}, {row['library']} {row['library_ms'] * 1e3:.1f}, "
            f"bound {row['bound'][0] * 1e3:.2f} by {row['bound'][1]})")


def run(probes: Sequence[Probe], device: torch.device, iters: int = 20) -> List[dict]:
    """Every probe of the table; a probe that raises is a row with ``error``."""
    clock = Clock(device)
    rows = []
    for p in probes:
        try:
            rows.append(run_probe(p, device, iters, clock))
        except Exception as e:  # noqa: BLE001 -- printed as the JAX tool's [FAIL] line
            rows.append({"probe": p.name, "label": p.label, "ok": False,
                         "error": f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"})
    return rows


def main(argv=None, probes: Sequence[Probe] = PROBES) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="'cpu' for a host run; default the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    print("device:", torch.cuda.get_device_name(device) if cuda else "cpu")
    rows = run(probes, device, args.iters)
    for r in rows:
        print(line(r, cuda) if "error" not in r else f"[FAIL] {r['label']}: {r['error']}")
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
