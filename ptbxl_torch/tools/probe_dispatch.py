"""Where a capability probe's time goes on the card: the host or the device.

    python -m ptbxl_torch.tools.probe_dispatch [--iters 20] [--reps 2000] [--out PATH]

For every probe of P1's and P2's tables (``probe_mosaic.PROBES``,
``probe_mosaic2.PROBES``) and for its PyTorch call, three times a call:

* ``loop_ms``: ``iters`` calls back to back between CUDA events, as the
  tables time them (``Clock.ms``); when the host cannot keep the card fed
  this is the host's launch rate;
* ``graph_ms``: the same ``iters`` calls captured once in a
  ``torch.cuda.CUDAGraph`` and replayed between CUDA events: the device time
  alone, with no Python, ``ctypes`` or driver call on the way;
* ``host_us``: the host's own time a call (``time.perf_counter_ns`` over
  ``reps`` calls without a synchronise, after a warm-up).

Then the kernel wrapper's host work split into its parts on one probe
(p5b, one input and one output), each timed alone over ``reps`` calls:
``checks`` (splitting the arguments into tensors and ints and checking each
tensor), ``empty`` (``torch.empty`` of the output), ``stream``
(``torch.cuda.current_stream(dev).cuda_stream``) beside ``raw_stream`` (the
raw handle, ``torch._C._cuda_getCurrentRawStream``), ``data_ptr``,
``ctypes_noop`` (the C entry's ``ctypes`` call with a shape it refuses:
marshalling and the entry's device check, no launch), ``ctypes_launch`` (the
whole C entry with its launch) and ``wrapper`` (the public ``pool_reshape``).
The parts are the same calls for any version of the launch path, so the
tool times the parent of a change as well (``PYTHONPATH=<checkout> python
ptbxl_torch/tools/probe_dispatch.py``).

Prints one JSON object; ``--out`` writes it to a file as well.  Needs the
card: the numbers are device and host times of one H100 run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import torch

from ptbxl_torch.bench import Clock
from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.kernels import probes as kp


def graph_ms(fn: Callable[[], object], iters: int, device: torch.device,
             trials: int = 3) -> Optional[float]:
    """Device ms a call with no host work in the way: ``iters`` calls of ``fn``
    captured once in a CUDA graph and replayed between CUDA events, median of
    ``trials``.  None on the CPU, which has no device time."""
    if device.type != "cuda":
        return None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_us(fn: Callable[[], object], reps: int) -> float:
    """Host microseconds a call, no synchronise inside the timed calls."""
    for _ in range(min(reps, 50)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def probe_rows(iters: int, reps: int) -> list:
    from ptbxl_torch.tools import probe_mosaic, probe_mosaic2

    dev = torch.device("cuda")
    clock = Clock(dev)
    rows = []
    for table, probes in (("probe_mosaic", probe_mosaic.PROBES),
                          ("probe_mosaic2", probe_mosaic2.PROBES)):
        for p in probes:
            xs = p.inputs(dev)
            saved = torch.backends.cuda.matmul.allow_tf32
            row = {"table": table, "probe": p.name, "library": p.library_name}
            with torch.no_grad():
                for side, fn in (("kernel", lambda: p.kernel(*xs)),
                                 ("library", lambda: p.library(*xs))):
                    if side == "library":  # the library dot's own precision
                        torch.backends.cuda.matmul.allow_tf32 = p.peak == probe_mosaic.PEAK_TF32
                    try:
                        row[side] = {"loop_ms": clock.ms(fn, iters),
                                     "graph_ms": graph_ms(fn, iters, dev),
                                     "host_us": host_us(fn, reps)}
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = saved
            rows.append(row)
    return rows


def _time_parts(parts: Dict[str, Callable[[], object]], reps: int) -> dict:
    return {name: host_us(fn, reps) for name, fn in parts.items()}


def wrapper_parts(reps: int) -> dict:
    """The host parts of one probe launch (p5b: x [2048, 64] -> [1024, 64])."""
    dev = torch.device("cuda")
    x = torch.randn(2048, 64, device=dev)
    out = torch.empty(1024, 64, device=dev)
    lib = _build.load_library("probes", kp._SIGNATURES)
    entry = lib.ptbxl_probe_pool_rows_reshape
    idx = x.get_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (x, 2048, 64)

    def checks():
        tensors = [v for v in args if isinstance(v, torch.Tensor)]
        for v in tensors:
            if v.device != x.device or v.dtype != torch.float32 or not v.is_contiguous():
                raise TypeError("bad probe input")

    parts = {
        "checks": checks,
        "empty": lambda: torch.empty((1024, 64), dtype=torch.float32, device=dev),
        "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(idx),
        "data_ptr": lambda: (x.get_device(), x.data_ptr(), out.data_ptr()),
        # R=0 is refused after the entry's device check: marshalling, no launch
        "ctypes_noop": lambda: entry(idx, x.data_ptr(), out.data_ptr(), 0, 64, stream),
        "ctypes_launch": lambda: entry(idx, x.data_ptr(), out.data_ptr(), 2048, 64, stream),
        "wrapper": lambda: kp.pool_reshape(x, 0),
    }
    res = _time_parts(parts, reps)
    torch.cuda.synchronize()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_dispatch: needs a CUDA GPU", file=sys.stderr)
        return 2
    _build.build_all()
    result = {"device": torch.cuda.get_device_name(0), "iters": args.iters, "reps": args.reps,
              "probes": probe_rows(args.iters, args.reps), "parts_us": wrapper_parts(args.reps)}
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
