"""Randomized fuzz of the port's WFDB codec (port of ``tools/fuzz_wfdb.py``).

    python -m ptbxl_torch.tools.fuzz_wfdb [--n 500] [--seed 0]

Every trial writes a random record: a random format (all ten), signal count,
sample count (odd and packed-tail counts among them), gains and baselines,
samples per frame, skew, byte offset, missing-value sentinels, and now and
then a multi-segment record with null segments.  The bytes come from the
independent scalar packers below (one sample at a time, from the spec,
sharing nothing with the vectorised encoders of ``ptbxl_torch/io/wfdb_io.py``)
and the header text is written here too.  ``read_adc`` and ``rdsamp`` of the
port's codec are then held against an oracle computed from the generated
sample arrays.  The draws from the seed are those of ``tools/fuzz_wfdb.py``,
so one seed gives both tools the same records.

The JAX tool's second mode, a comparison with the ``wfdb`` package, is left
out: neither machine has the package, and ``run_trial`` raises if asked.

A failing trial's files are copied to ``tests/fixtures/fuzz_torch/`` with an
``.error.json`` beside them, so that a fault becomes a permanent regression
fixture (``tests/test_torch_fuzz_wfdb.py`` replays them); the directory is
made only when a trial fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ptbxl_torch.io.wfdb_io import _MISSING, rdsamp, read_adc

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "fuzz_torch")

# Legal amplitude range per format (one LSB inside the sentinel where one
# exists; fmt 8 is bounded by what int8 differences can reach, handled apart).
RANGES = {
    16: (-32767, 32767),
    61: (-32767, 32767),
    160: (-32767, 32767),
    32: (-(2**31) + 1, 2**31 - 1),
    80: (-127, 127),
    212: (-2047, 2047),
    24: (-(2**23) + 1, 2**23 - 1),
    310: (-511, 511),
    311: (-511, 511),
}

ALL_FMTS = (8, 16, 24, 32, 61, 80, 160, 212, 310, 311)


# ---------------------------------------------------------------------------
# Independent scalar packers, from the WFDB spec (signal(5)), one sample at a
# time, sharing nothing with the codec's vectorised encoders.  Slow on
# purpose; clarity is the point.
# ---------------------------------------------------------------------------

def _p8(vals):  # first differences already provided by the caller
    return bytes((int(v) & 0xFF) for v in vals)


def _p16(vals):
    out = bytearray()
    for v in vals:
        u = int(v) & 0xFFFF
        out += bytes((u & 0xFF, u >> 8))
    return bytes(out)


def _p61(vals):
    out = bytearray()
    for v in vals:
        u = int(v) & 0xFFFF
        out += bytes((u >> 8, u & 0xFF))  # MSB first
    return bytes(out)


def _p160(vals):
    out = bytearray()
    for v in vals:
        u = (int(v) + 32768) & 0xFFFF
        out += bytes((u & 0xFF, u >> 8))
    return bytes(out)


def _p32(vals):
    out = bytearray()
    for v in vals:
        u = int(v) & 0xFFFFFFFF
        out += bytes((u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF, u >> 24))
    return bytes(out)


def _p80(vals):
    return bytes(((int(v) + 128) & 0xFF) for v in vals)


def _p24(vals):
    out = bytearray()
    for v in vals:
        u = int(v) & 0xFFFFFF
        out += bytes((u & 0xFF, (u >> 8) & 0xFF, u >> 16))
    return bytes(out)


def _p212(vals):
    out = bytearray()
    for i in range(0, len(vals) - 1, 2):
        a, b = int(vals[i]) & 0xFFF, int(vals[i + 1]) & 0xFFF
        out += bytes((a & 0xFF, ((a >> 8) & 0x0F) | (((b >> 8) & 0x0F) << 4),
                      b & 0xFF))
    if len(vals) % 2:
        a = int(vals[-1]) & 0xFFF
        out += bytes((a & 0xFF, (a >> 8) & 0x0F))  # truncated final triplet
    return bytes(out)


def _p310(vals):
    out = bytearray()
    for i in range(0, len(vals), 3):
        trip = [int(vals[i + j]) & 0x3FF if i + j < len(vals) else 0
                for j in range(3)]
        w1 = (trip[0] << 1) | ((trip[2] & 0x1F) << 11)
        w2 = (trip[1] << 1) | (((trip[2] >> 5) & 0x1F) << 11)
        out += bytes((w1 & 0xFF, w1 >> 8, w2 & 0xFF, w2 >> 8))
    return bytes(out)


def _p311(vals):
    out = bytearray()
    for i in range(0, len(vals), 3):
        trip = [int(vals[i + j]) & 0x3FF if i + j < len(vals) else 0
                for j in range(3)]
        w = trip[0] | (trip[1] << 10) | (trip[2] << 20)
        out += bytes((w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, w >> 24))
    return bytes(out)


PACKERS = {8: _p8, 16: _p16, 24: _p24, 32: _p32, 61: _p61, 80: _p80,
           160: _p160, 212: _p212, 310: _p310, 311: _p311}


# ---------------------------------------------------------------------------
# Random records and their oracle
# ---------------------------------------------------------------------------

def gen_single_segment(rng, rec_dir, name, force_plain=False,
                       n_sig=None, n_frames=None):
    """Write one random single-segment record; return its oracle.

    Returns a dict with: path, general (bool), expected_adc [frames, n_sig]
    (int64 plain / float64 general), expected_phys [frames, n_sig] float64,
    meta (for reproduction logs).
    """
    fmt = int(rng.choice(ALL_FMTS))
    if n_frames is None:
        # odd counts and counts around packed-group boundaries are the point
        n_frames = int(rng.integers(1, 48))
    if n_sig is None:
        n_sig = int(rng.integers(1, 6))
    general = (not force_plain) and bool(rng.random() < 0.5)
    spf = [int(rng.integers(1, 4)) if general and rng.random() < 0.6 else 1
           for _ in range(n_sig)]
    skew = [int(rng.integers(0, min(4, n_frames + 1)))
            if general and rng.random() < 0.4 else 0 for _ in range(n_sig)]
    if general and all(s == 1 for s in spf) and all(k == 0 for k in skew):
        spf[int(rng.integers(0, n_sig))] = 2  # keep the general path honest
    byte_offset = int(rng.integers(0, 16)) if rng.random() < 0.3 else 0

    gains = [float(rng.choice([200.0, 500.0, 1000.0, 2000.0, 123.5]))
             for _ in range(n_sig)]
    baselines = [int(rng.integers(-50, 50)) for _ in range(n_sig)]

    lo, hi = RANGES.get(fmt, (0, 0))
    sentinel = _MISSING.get(fmt)

    # Per-signal amplitude streams at spf resolution (length n_frames*spf).
    amps, init_vals = [], []
    for c in range(n_sig):
        n = n_frames * spf[c]
        if fmt == 8:
            # int8 differences, the first stored one 0; the amplitude stream
            # is init_value + cumsum(diffs) per signal(5)
            diffs = rng.integers(-128, 128, size=n, dtype=np.int64)
            if n:
                diffs[0] = 0
            init = int(rng.integers(-500, 500))
            a = init + np.cumsum(diffs)
            init_vals.append(init)
            amps.append((a, diffs))
        else:
            a = rng.integers(lo, hi + 1, size=n, dtype=np.int64)
            if sentinel is not None and rng.random() < 0.5 and n:
                k = rng.integers(1, max(2, n // 4))
                a[rng.choice(n, size=min(k, n), replace=False)] = sentinel
            init_vals.append(int(a[0]) if n else 0)
            amps.append((a, a))

    # Frame-interleave each signal's spf samples in signal order -> .dat
    frame_len = sum(spf)
    stored = np.zeros((n_frames, frame_len), dtype=np.int64)
    pos = 0
    for c in range(n_sig):
        stored[:, pos:pos + spf[c]] = amps[c][1].reshape(n_frames, spf[c])
        pos += spf[c]
    payload = PACKERS[fmt](stored.reshape(-1).tolist())
    junk = bytes(rng.integers(0, 256, size=byte_offset, dtype=np.uint8))
    dat_name = f"{name}.dat"
    with open(os.path.join(rec_dir, dat_name), "wb") as f:
        f.write(junk + payload)

    lines = [f"{name} {n_sig} 500 {n_frames}"]
    for c in range(n_sig):
        fmt_field = str(fmt)
        if spf[c] != 1:
            fmt_field += f"x{spf[c]}"
        if skew[c]:
            fmt_field += f":{skew[c]}"
        if byte_offset:
            fmt_field += f"+{byte_offset}"
        lines.append(
            f"{dat_name} {fmt_field} {gains[c]:g}({baselines[c]})/mV 16 0 "
            f"{init_vals[c]} 0 0 fz{c}")
    with open(os.path.join(rec_dir, name + ".hea"), "w") as f:
        f.write("\n".join(lines) + "\n")

    # ---- oracle --------------------------------------------------------
    exp_adc = np.empty((n_frames, n_sig),
                       dtype=np.float64 if general else np.int64)
    exp_phys = np.empty((n_frames, n_sig), dtype=np.float64)
    for c in range(n_sig):
        a = amps[c][0].astype(np.float64)
        if general:
            av = a.copy()
            if sentinel is not None:
                av[amps[c][0] == sentinel] = np.nan
            col = av.reshape(n_frames, spf[c]).mean(axis=1)
            if skew[c]:
                k = min(skew[c], n_frames)
                col = np.concatenate([col[k:], np.full(k, np.nan)])
            exp_adc[:, c] = col
            exp_phys[:, c] = (col - baselines[c]) / gains[c]
        else:
            exp_adc[:, c] = amps[c][0]
            col = (a - baselines[c]) / gains[c]
            if sentinel is not None:
                col[amps[c][0] == sentinel] = np.nan
            exp_phys[:, c] = col
    meta = dict(fmt=fmt, n_frames=n_frames, n_sig=n_sig, spf=spf, skew=skew,
                byte_offset=byte_offset, gains=gains, baselines=baselines,
                general=general)
    return dict(path=os.path.join(rec_dir, name), general=general,
                expected_adc=exp_adc, expected_phys=exp_phys, meta=meta)


def gen_multi_segment(rng, rec_dir, name):
    """Fixed-layout multi-segment record with optional '~' gaps; per-segment
    formats and gains differ.  Oracle = concatenation of per-segment physical."""
    n_sig = int(rng.integers(1, 4))
    n_seg = int(rng.integers(2, 5))
    parts, seg_lines, metas = [], [], []
    total = 0
    for s in range(n_seg):
        if rng.random() < 0.25:
            gap = int(rng.integers(1, 20))
            seg_lines.append(("~", gap))
            parts.append(np.full((gap, n_sig), np.nan))
            total += gap
            continue
        sub = gen_single_segment(rng, rec_dir, f"{name}_s{s}",
                                 force_plain=True, n_sig=n_sig)
        seg_lines.append((f"{name}_s{s}", sub["meta"]["n_frames"]))
        parts.append(sub["expected_phys"])
        metas.append(sub["meta"])
        total += sub["meta"]["n_frames"]
    lines = [f"{name}/{len(seg_lines)} {n_sig} 500 {total}"]
    lines += [f"{s} {n}" for s, n in seg_lines]
    with open(os.path.join(rec_dir, name + ".hea"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return dict(path=os.path.join(rec_dir, name),
                expected_phys=np.concatenate(parts, axis=0),
                meta=dict(multi=True, n_sig=n_sig, segments=seg_lines,
                          sub=metas))


def _mismatch(got, want, kind, atol=0.0):
    if got.shape != want.shape:
        return f"{kind}: shape {got.shape} != {want.shape}"
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    both_nan = np.isnan(g) & np.isnan(w)
    close = np.isclose(g, w, rtol=1e-12, atol=atol)
    bad = ~(both_nan | close)
    if bad.any():
        idx = tuple(int(i) for i in np.argwhere(bad)[0])
        return (f"{kind}: {int(bad.sum())}/{g.size} mismatched; first at "
                f"{idx}: got {g[idx]!r} want {w[idx]!r}")
    return None


def run_trial(rng, workdir, trial, use_wfdb=False):
    """One random record through ``read_adc`` / ``rdsamp``; a list of
    ``(record, error)`` pairs, empty when the codec agrees with the oracle."""
    if use_wfdb:
        raise NotImplementedError(
            "the wfdb-python comparison is not ported: the package is on neither "
            "machine; run tools/fuzz_wfdb.py --wfdb where it is installed")
    errs = []
    if rng.random() < 0.15:
        rec = gen_multi_segment(rng, workdir, f"t{trial}")
        phys, _ = rdsamp(rec["path"])
        e = _mismatch(phys, rec["expected_phys"], "rdsamp[multi]")
        if e:
            errs.append((rec, e))
    else:
        rec = gen_single_segment(rng, workdir, f"t{trial}")
        adc, _ = read_adc(rec["path"])
        e = _mismatch(adc, rec["expected_adc"], "read_adc")
        if e:
            errs.append((rec, e))
        phys, _ = rdsamp(rec["path"])
        e = _mismatch(phys, rec["expected_phys"], "rdsamp")
        if e:
            errs.append((rec, e))
    return errs


def save_fixture(rec, err, tag):
    """Copy the failing record's files into ``FIXTURE_DIR`` (made here) with
    its error and metadata beside them; return the fixture's record path."""
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    base = os.path.basename(rec["path"])
    dst = os.path.join(FIXTURE_DIR, f"{tag}_{base}")
    src_dir = os.path.dirname(rec["path"])
    for f in os.listdir(src_dir):
        if f.startswith(base):
            shutil.copy2(os.path.join(src_dir, f),
                         os.path.join(FIXTURE_DIR, f"{tag}_{f}"))
    with open(dst + ".error.json", "w") as f:
        json.dump({"error": err, "meta": rec["meta"]}, f, indent=1,
                  default=str)
    return dst


def fuzz(n, seed):
    """``n`` trials from ``default_rng(seed)``; a list of ``(error, fixture)``."""
    rng = np.random.default_rng(seed)
    failures = []
    with tempfile.TemporaryDirectory() as workdir:
        for t in range(n):
            for rec, e in run_trial(rng, workdir, t):
                failures.append((e, save_fixture(rec, e, f"seed{seed}")))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(f"[fuzz_wfdb] {args.n} trials, seed {args.seed}: independent oracle, "
          f"ptbxl_torch.io.wfdb_io")
    t0 = time.perf_counter()
    failures = fuzz(args.n, args.seed)
    wall = time.perf_counter() - t0
    if failures:
        for e, dst in failures:
            print(f"[fuzz_wfdb] FAIL {e}\n  fixture: {dst}", file=sys.stderr)
        print(f"[fuzz_wfdb] {len(failures)} failure(s); fixtures saved under "
              f"{FIXTURE_DIR}", file=sys.stderr)
        return 1
    print(f"[fuzz_wfdb] all {args.n} trials matched ({args.n / wall:.0f} trials/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
