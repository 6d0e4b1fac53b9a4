"""Tile variants and fusions of K4's ``wgmma`` conv block, timed on the card.

    python -m ptbxl_torch.tools.tune_wgmma [--batch 8192] [--iters 5] [--out PATH]

The tile of each block (output channels a tile BN, m64 tiles a consumer
warpgroup RM, CTAs an SM, k16 steps a weight stage) is one row of
``PTBXL_WG_TILES`` in ``ptbxl_torch/csrc/hybrid_wgmma.cu``.  Each variant
below is a copy of that source with one row changed, built by the port's
``nvcc`` command (``_build.nvcc_command``) under ``build/ptbxl_torch/tune/``,
all variants in parallel
(only its conv block is timed).
For each block of the baseline checkpoint, on B raw-like records (block 0:
the raw f32 record with ``zscore_stats``; blocks 1-3: random bf16 inputs of
the block's shape; block 3 writing its per-tile sums), the device ms of one
launch of the shipped tile (the package's own build) and of each variant,
and each variant's largest difference from the shipped tile's output (bf16
outputs; block 3's sums added over the tiles of a record, since another BM
cuts other tiles).  Then the two fusions of ``wgmma_fusions.cu`` (beside
this file; blocks 0 and 1 in one launch, blocks 2 and 3 with block 3's sums
in one launch) against the same blocks launched one at a time, at B and at
512:
the median device ms of each over ten timings taken in turns, how many of
the ten pairs the fusion won, and the largest difference; and so K4's whole
forward with blocks 2 and 3 fused against the route's
(``hybrid_ecgcnn_logits``, one launch a block).  Prints one JSON line a row and then one object with every row and the fastest tile of each block;
``--out`` writes that object to a file as well.  The shipped rows are the
fastest of these on an NVIDIA H100 80GB HBM3, and the route takes neither
fusion (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4

# CinP -> tiles (Cout, BN, RM, CTAs an SM, k16 steps a stage) tried beside the shipped one
VARIANTS = {
    16: [(32, 32, 2, 2, 3), (32, 32, 2, 2, 5), (32, 32, 1, 2, 15), (32, 32, 2, 1, 15),
         (32, 32, 1, 3, 3), (32, 32, 1, 3, 5), (32, 32, 2, 3, 3)],
    32: [(64, 64, 1, 2, 6), (64, 64, 1, 2, 3), (64, 64, 1, 2, 10), (64, 64, 2, 1, 10),
         (64, 64, 1, 3, 3), (64, 64, 1, 3, 6)],
    64: [(128, 128, 2, 1, 2), (128, 128, 2, 1, 3), (128, 128, 1, 2, 4), (128, 64, 2, 2, 4)],
    128: [(256, 256, 1, 1, 3), (256, 256, 1, 1, 2), (256, 256, 1, 1, 4), (256, 128, 2, 1, 3),
          (256, 128, 2, 1, 2), (256, 128, 1, 2, 2)],
}
T_IN = {16: 5000, 32: 2500, 64: 1250, 128: 625}  # each block's input length at T=5000
PAIRS = 10  # fused / launches timings in turns, for each fusion and batch
TUNE_DIR = _build.BUILD_DIR / "tune"
FUSIONS = Path(__file__).resolve().with_name("wgmma_fusions.cu")
_FUSION_SIGNATURES = {
    # x, stats, w0, b0, w1, b1, y, B, T, Cin
    "ptbxl_wgmma_front": [_build.VOIDP] * 7 + [_build.INT] * 3,
    # x2, w2, b2, w3, b3, y, B, T2
    "ptbxl_wgmma_deep": [_build.VOIDP] * 6 + [_build.INT] * 2,
}


def variant_source(text: str, cin_p: int, row: tuple) -> str:
    """``text`` with the ``PTBXL_WG_TILES`` row of CinP ``cin_p`` replaced by
    ``row`` = (Cout, BN, RM, CTAs an SM, k16 steps a stage)."""
    pat = re.compile(rf"^(\s*)X\({cin_p},[^)]*\)", re.M)
    out, n = pat.subn(lambda m: f"{m.group(1)}X({cin_p}, {', '.join(map(str, row))})", text)
    if n != 1:
        raise ValueError(f"expected one PTBXL_WG_TILES row for CinP {cin_p}, found {n}")
    return out


def variant_name(cin_p: int, row: tuple) -> str:
    return f"c{cin_p}_bn{row[1]}_rm{row[2]}_mb{row[3]}_st{row[4]}"


def ptxas(log: str, key: str) -> dict:
    """Registers and spill stores (the largest of the kernels whose mangled name
    holds ``key``) from a build's ``-Xptxas -v`` report."""
    regs, spills = [], []
    for chunk in log.split("Compiling entry function '")[1:]:
        if key in chunk.split("'", 1)[0]:
            regs += [int(v) for v in re.findall(r"Used (\d+) registers", chunk)]
            spills += [int(v) for v in re.findall(r"(\d+) bytes spill stores", chunk)]
    return {"registers": max(regs, default=None), "spill_bytes": max(spills, default=None)}


def tile_key(cin_p: int, row: tuple) -> str:
    """The template arguments of a tile's K4 kernels, as they are mangled: the
    tile, then K4's input policy (raw f32 for CinP 16, else bf16), so that the
    same tile's P3/P4 layer kernels are left out."""
    return "wgmma_conv_block_kernelILi{}ELi{}ELi{}ELi{}ELi{}ELi{}E".format(
        cin_p, *row[1:], int(cin_p == 16))


def start_builds(text: str) -> dict:
    """One ``nvcc`` a variant that differs from the shipped tile, and one for
    the fusions, all started at once."""
    TUNE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {"fusions": subprocess.Popen(
        _build.nvcc_command(FUSIONS, TUNE_DIR / "libfusions.so"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for cin_p, rows in VARIANTS.items():
        for row in rows:
            if row == k4.WG_TILES[cin_p]:
                continue
            name = variant_name(cin_p, row)
            src = TUNE_DIR / f"{name}.cu"
            src.write_text(variant_source(text, cin_p, row))
            procs[name] = subprocess.Popen(
                _build.nvcc_command(src, TUNE_DIR / f"lib{name}.so"),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def _compare(got: torch.Tensor, want: torch.Tensor, sums: bool) -> float:
    if sums:  # another BM cuts other tiles: compare each record's total
        got, want = got.sum(1), want.sum(1)
    return float((got.float() - want.float()).abs().max())


def run(batch: int, iters: int) -> dict:
    from ptbxl_torch import bench
    from ptbxl_torch.models.params_io import load_checkpoint
    from ptbxl_torch.ops.kernels import fused_ecgcnn as k2
    from ptbxl_torch.ops.kernels.zscore import zscore_stats

    procs = start_builds(k4.WG_SOURCE.read_text())
    # the shipped tiles, while the variants compile
    shipped_log = _build.build_all()["hybrid_wgmma"].with_suffix(".log").read_text()
    built = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        built[name] = (p.returncode, log)
    dev = torch.device("cuda")
    clock = bench.Clock(dev)
    state, _ = load_checkpoint(bench.CKPT)
    folded = k2.fold_bn_into_conv({k: v.to(dev) for k, v in state.items()})
    rows, best = [], {}
    with torch.no_grad():
        x = bench._random_batch(batch, torch.float32, dev)
        stats = zscore_stats(x)
        for i, cin_p in enumerate(VARIANTS):
            w, b = folded[f"w{i}"], folded[f"b{i}"]
            t, cout, sums = T_IN[cin_p], w.shape[2], i == len(VARIANTS) - 1
            h = x if i == 0 else torch.randn(batch, t, cin_p, device=dev).to(torch.bfloat16)
            st = stats if i == 0 else None
            wp = k4.wg_weight(w)
            ref = k4.wgmma_conv_block(h, wp, b, st, sums)
            shipped = k4.WG_TILES[cin_p]
            row = {"block": i, "tile": list(shipped), "shipped": True,
                   **ptxas(shipped_log, tile_key(cin_p, shipped)), "max_abs_diff": 0.0,
                   "ms": clock.ms(lambda: k4.wgmma_conv_block(h, wp, b, st, sums), iters)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            for tile in VARIANTS[cin_p]:
                if tile == shipped:
                    continue
                name = variant_name(cin_p, tile)
                rc, log = built[name]
                row = {"block": i, "tile": list(tile), "shipped": False,
                       **ptxas(log, tile_key(cin_p, tile))}
                if rc:
                    row["build_error"] = log[-2000:]
                else:
                    lib = _build.Library(name, k4.LIB.signatures, TUNE_DIR / f"lib{name}.so")
                    bm = 128 * tile[2]
                    wv = k4.wg_weight(w, bn=tile[1])
                    y = (torch.empty((batch, -(-2 * (t // 2) // bm), cout), dtype=torch.float32,
                                     device=dev) if sums else torch.empty_like(ref))

                    def launch():
                        lib.launch("ptbxl_wgmma_conv_block", h, st, wv, b, y, batch, t,
                                   h.shape[2], cin_p, cout, int(i == 0), int(sums))
                    launch()
                    row["max_abs_diff"] = _compare(y, ref, sums)
                    row["ms"] = clock.ms(launch, iters)
                rows.append(row)
                print(json.dumps(row), flush=True)
            del h, ref
            timed = [r for r in rows if r["block"] == i and "ms" in r]
            best[i] = min(timed, key=lambda r: r["ms"])["tile"]
        del x, stats
        rc, log = built["fusions"]
        if rc:
            raise RuntimeError(f"nvcc failed for {FUSIONS.name}:\n{log}")
        fused = _build.Library("fusions", _FUSION_SIGNATURES, TUNE_DIR / "libfusions.so")
        regs = {"blocks 0+1": ptxas(log, "wgmma_front_kernel"),
                "blocks 2+3": ptxas(log, "wgmma_deep_kernel")}
        for bsz in dict.fromkeys((batch, 512)):
            for row in fusion_rows(fused, folded, bsz, clock, iters):
                row.update(regs.get(row["fusion"], {}))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return {"batch": batch, "iters": iters, "rows": rows, "fastest": best}


def paired(fused, launches, clock, iters: int, pairs: int = PAIRS) -> dict:
    """``pairs`` timings of each, in turns (the fused first in even pairs, the
    launches first in odd ones): the medians and how many pairs the fused won."""
    a, b = [], []
    for k in range(pairs):
        for fn, out in ((fused, a), (launches, b))[::1 if k % 2 == 0 else -1]:
            out.append(clock.ms(fn, iters))
    return {"fused_ms": statistics.median(a), "launches_ms": statistics.median(b),
            "fused_wins": sum(x < y for x, y in zip(a, b)), "pairs": pairs}


def fusion_rows(lib, folded, bsz: int, clock, iters: int) -> list:
    """Each fusion at ``bsz`` records against the route's launches of the same
    blocks: device ms of both, and the largest difference of the outputs."""
    from ptbxl_torch import bench
    from ptbxl_torch.ops.kernels.zscore import zscore_stats

    dev = torch.device("cuda")
    wp = [k4.wg_weight(folded[f"w{i}"]) for i in range(4)]
    b = [folded[f"b{i}"] for i in range(4)]
    x = bench._random_batch(bsz, torch.float32, dev)
    st = zscore_stats(x)
    y01 = torch.empty((bsz, 1250, 64), dtype=torch.bfloat16, device=dev)

    def front():
        lib.launch("ptbxl_wgmma_front", x, st, wp[0], b[0], wp[1], b[1], y01, bsz, x.shape[1],
                   x.shape[2])

    def front_launches():
        return k4.wgmma_conv_block(k4.wgmma_conv_block(x, wp[0], b[0], st), wp[1], b[1])

    front()
    out = [{"fusion": "blocks 0+1", "batch": bsz, **paired(front, front_launches, clock, iters),
            "max_abs_diff": _compare(y01, front_launches(), False)}]
    del x, st
    def fused_deep(h2):  # blocks 2 and 3 in one launch -> block 3's per-tile sums
        y = torch.empty((bsz, -(-2 * (h2.shape[1] // 4) // 128), 256), dtype=torch.float32,
                        device=dev)
        lib.launch("ptbxl_wgmma_deep", h2, wp[2], b[2], wp[3], b[3], y, bsz, h2.shape[1])
        return y

    x2 = torch.randn(bsz, 1250, 64, device=dev).to(torch.bfloat16)

    def deep():
        return fused_deep(x2)

    def deep_launches():
        return k4.wgmma_conv_block(k4.wgmma_conv_block(x2, wp[2], b[2]), wp[3], b[3], None, True)

    want = deep_launches()
    out.append({"fusion": "blocks 2+3", "batch": bsz,
                **paired(deep, deep_launches, clock, iters),
                "max_abs_diff": _compare(deep(), want, True),
                "max_abs": float(want.abs().max())})
    del x2
    x = bench._random_batch(bsz, torch.float32, dev)
    weights = k4.prepare_weights(folded, compute_dtype=torch.bfloat16)

    def forward_fused():  # K4's forward with blocks 2 and 3 in one launch
        h, stats = x, zscore_stats(x)
        for i in range(2):
            h = k4.wgmma_conv_block(h, wp[i], b[i], stats if i == 0 else None)
        return k4.sums_tail(fused_deep(h), (h.shape[1] // 2) // 2, folded)

    def forward():  # K4's route: one launch a block
        return k4.hybrid_ecgcnn_logits(x, folded, 2, torch.bfloat16, True, weights)

    out.append({"fusion": "blocks 2+3 in K4's forward", "batch": bsz,
                **paired(forward_fused, forward, clock, iters),
                "max_abs_diff": _compare(forward_fused(), forward(), False)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_wgmma: needs a CUDA GPU", file=sys.stderr)
        return 2
    result = {"device": torch.cuda.get_device_name(0), **run(args.batch, args.iters)}
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
