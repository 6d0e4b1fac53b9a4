"""The benchmark of the PyTorch / CUDA port (``ptbxl_torch``): one cell, one run.

    python3 -m benchmark.run --workload ecgcnn.bulk --seed 1 --seconds 20 --trace 0

Run from the root of a checkout on a machine with an NVIDIA GPU.  The run
makes its inputs and weights from ``--seed``, builds the program's object for
the cell, warms up the cell's own shapes, measures for ``--seconds``, checks
what the window produced against the plain reference
(``benchmark/reference/``), and prints one JSON line last on stdout:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit,
which also end standard error.

Everything is found by name from data: the cell in ``BENCHMARK.json``, its
configuration file, ``benchmark/traffic/<traffic>.json`` (the kind of load,
its parameters, the program's settings, the check's limits and control), the
kind's load generator ``benchmark/kinds/<kind>.py``, a reader
``benchmark/metrics/<family>.py`` for each metric, and the kernel engine's
kernel names in ``benchmark/kernels/*.json``.  Without a CUDA
device (or with fewer than the cell asks for) it prints no result and exits
2; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter_ns()  # set-up is counted from here, the process's first work

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Mapping, NamedTuple, Optional, Tuple  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ptbxl_tpu")
CACHE_ENV = {  # every build and kernel cache at a fixed path inside the checkout
    "TORCH_EXTENSIONS_DIR": "build/benchmark/torch_extensions",
    "TRITON_CACHE_DIR": "build/benchmark/triton",
    "CUDA_CACHE_PATH": "build/benchmark/cuda_cache",
}


class Context(NamedTuple):
    """What a metric reader reads."""

    cfg: Mapping
    traffic: Mapping
    window: object  # drive.Window
    trace: Optional[object]  # trace.Reduced, with --trace 1
    engine_kernels: frozenset
    chunk_end: frozenset
    setup_s: float


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: Mapping, name: str) -> Tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the workload ``name``."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mix = HERE / "traffic" / f"{cell['traffic']}.json"
    return cell, load_json(ROOT / conf["file"]), load_json(mix) if mix.exists() else {}


def engine_kernels() -> Tuple[frozenset, frozenset]:
    kernels, ends = set(), set()
    for f in sorted((HERE / "kernels").glob("*.json")):
        d = load_json(f)
        if d.get("engine") == "kernel":
            kernels.update(d["kernels"])
            ends.update(d["chunk_end"])
    return frozenset(kernels), frozenset(ends)


def cell_metrics(bench: Mapping, cell: Mapping, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end ones, or with ``trace``
    the per-layer ones that list it (or that list no cells and move a metric
    it reports)."""
    def applies(m):
        return cell["name"] in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def read_metrics(specs: list, ctx: Context) -> Dict[str, dict]:
    out = {}
    for m in specs:
        v = importlib.import_module(f"benchmark.metrics.{m['name'].split('.')[0]}").read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None


def run_cell(bench: Mapping, name: str, seed: int, seconds: float, trace: bool, device,
             overrides: Optional[Mapping] = None, control: bool = False
             ) -> Tuple[dict, Dict[str, Tuple[float, float]]]:
    """One run of the cell ``name`` on ``device``: (result line, checks).

    ``overrides`` (``{"config": {...}, "traffic": {...}}``) replaces
    top-level keys of the two files; the tests use it to run a cell small on
    the host.  ``control`` adds the control's readings to the result under
    ``control`` (``benchmark/control.py``; the benchmark's runs never do)."""
    import torch

    from benchmark import drive
    from benchmark.trace import Profiler, Spans, breakdown, reduce

    cell, cfg, traffic = cell_files(bench, name)
    cfg.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    on_card = torch.device(device).type == "cuda"
    drv = drive.kind(traffic["kind"])(cfg, traffic, seed, device)
    prof = Profiler() if trace else None
    if prof:
        prof.start()
    drv.setup()
    w = drive.Window(Spans())

    def on_start():
        if on_card:
            torch.cuda.synchronize(device)
        if prof:
            prof.window_start()

    drv.window(seconds, w, on_start)
    setup_s = (w.t0 - T_START) / 1e9
    events = prof.stop() if prof else None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    red = reduce(events, w.spans, w.t0, w.t1) if prof else None
    drv.finish()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = drv.check()
    check_s = time.perf_counter() - t
    limits = traffic["limits"]
    checks = {k: (v, limits[k]) for k, v in numbers.items() if k in limits}
    kernels, ends = engine_kernels()
    ctx = Context(cfg, traffic, w, red, kernels, ends, setup_s)
    metrics = read_metrics(cell_metrics(bench, cell, trace), ctx)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if red is not None:
        dev.update(busy_s=red.busy_s, window_s=w.seconds)
    if on_card:
        dev["nvidia_smi"] = power_limit()
    result = {"correct": w.failed == 0 and all(v <= lim for v, lim in checks.values()),
              "attempted": w.attempted, "failed": w.failed, "metrics": metrics, "device": dev}
    if red is not None:
        result["breakdown"] = breakdown(red)
    if control:
        result["control"] = drv.control()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    notes = [f"setup_s {setup_s:.3f}, window {w.seconds:.3f} s, check {check_s:.3f} s"]
    for span in ("call", "step"):
        d = sorted(w.spans.durations_s(span))
        if d:
            notes.append(f"{span} ms: min {1e3 * d[0]:.3f}, median {1e3 * d[len(d) // 2]:.3f}, "
                         f"max {1e3 * d[-1]:.3f} over {len(d)}")
    if prof:
        notes.append(f"trace: {len(events)} device events, read in {prof.process_s:.3f} s")
    for line in notes:
        print(line, file=sys.stderr)
    return result, checks


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHE_ENV.items():
        os.environ[k] = str(ROOT / v)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_files(bench, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA device(s), "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        import ptbxl_torch  # noqa: F401
    except ImportError as e:
        print(f"no result: the program is not in this checkout ({e})", file=sys.stderr)
        return 2
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"no result: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
