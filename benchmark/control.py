"""The two readings that each limit of the check is set from, on the card.

    python3 -m benchmark.control --workload ecgcnn.bulk --seconds 3 \\
        --seeds 11 12 13 ... --control-seeds 3

For each seed, one run of the cell (a short window at the cell's own sizes
and load, then the check) prints its numbers; for the first
``--control-seeds`` seeds it also prints the control's: the same numbers with
the plain reference run in TF32 in the program's place (the f32 cells), or
the program's int8 path switched on (the bf16 cell); for the train cell also
the reference trained on half of each batch.  All seeds run in one process,
so set-up's one-time costs are paid once.  The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for i, seed in enumerate(args.seeds):
        result, checks = run.run_cell(bench, args.workload, seed, args.seconds, False, "cuda",
                                      control=i < args.control_seeds)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "program": {k: v for k, (v, _) in checks.items()},
                          "control": result.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
