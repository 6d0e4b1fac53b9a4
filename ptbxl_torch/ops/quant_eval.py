"""The int8 accuracy battery (port of ``ptbxl_tpu/ops/quant_eval.py``).

A deterministic battery of synthetic 12-lead ECGs (512 by default, plus the
7 bundled demo records) sweeping amplitude, noise, beat rate and width,
ST-like deflections and ripple, with flatlined leads, spike artifacts and
heavy baseline wander mixed in; ``quant_accuracy_report`` gives the
quantiles of |dprob| of the int8 path against the f32 ``highest`` framework
path on it and the decision-flip rate at the reference's 0.5 threshold.

The generator is numpy, seeded, and draws in the JAX module's order, so
``make_battery`` returns the JAX package's array bit for bit.  The demo pack
comes from the port's own ``ops.quant.demo_pack_signals``.  Consumed by
``Predictor``'s default calibration (``robust_calibration_signals``), the
bench's int8 rows, ``chip_smoke.py``'s ``int8`` phase and
``tools/tune_int8.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ptbxl_torch.utils.device import DeviceLike


def make_battery(n: int = 512, T: int = 5000, fs: float = 500.0,
                 seed: int = 1234, include_demo_pack: bool = True) -> np.ndarray:
    """Deterministic battery of varied raw ECG-like signals ``[N, 12, T]`` f32.

    Sweeps (cycled across records so every combination appears): global
    amplitude x0.1 .. x10, additive noise sigma 0.05 .. 1.0, beat rate
    0.7 .. 3.5 Hz and beat width, ST deflection and ripple on/off; every 16th
    record one flatlined lead, every 23rd spike artifacts, every 31st heavy
    baseline wander.  With ``include_demo_pack`` and ``T`` equal to the demo
    records' length, the 7 demo records are appended last.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    amps = np.geomspace(0.1, 10.0, 8)
    noises = np.geomspace(0.05, 1.0, 6)
    out = np.empty((n, 12, T), np.float32)
    for i in range(n):
        amp = amps[i % len(amps)]
        noise = noises[(i // len(amps)) % len(noises)]
        hr = rng.uniform(0.7, 3.5)
        width = rng.uniform(3.0, 9.0)
        phase = rng.uniform(0, 2 * np.pi)
        carrier = np.sin(2 * np.pi * hr * t + phase)
        beat = np.sign(carrier) * np.abs(carrier) ** width
        env = np.abs(carrier) ** 6
        x = beat
        if i % 3 == 0:  # ST-like deflection
            x = x - rng.uniform(0.2, 0.6) * np.roll(env, int(0.15 * fs))
        if i % 4 == 0:  # beat-gated ripple
            x = x + rng.uniform(0.1, 0.5) * env * np.sin(2 * np.pi * 9.0 * t)
        rec = np.empty((12, T), np.float32)
        for lead in range(12):
            g = rng.uniform(0.5, 1.5)
            rec[lead] = amp * (g * x + noise * rng.standard_normal(T))
        if i % 16 == 5:
            rec[rng.integers(0, 12)] = 0.0  # flatline lead
        if i % 23 == 7:  # electrode spike artifacts
            for _ in range(rng.integers(1, 5)):
                p = rng.integers(0, T)
                rec[:, p:p + 3] += amp * rng.uniform(5, 20)
        if i % 31 == 11:  # heavy baseline wander
            rec += amp * 2.0 * np.sin(2 * np.pi * 0.15 * t + rng.uniform(0, 6))[None, :]
        out[i] = rec

    if include_demo_pack:
        from ptbxl_torch.ops.quant import demo_pack_signals

        try:
            demo = demo_pack_signals()  # [7, T, 12]
        except (FileNotFoundError, OSError):
            demo = None
        if demo is not None and demo.shape[1] == T:
            out = np.concatenate([out, demo.transpose(0, 2, 1)], axis=0)
    return out


def battery_artifact_mask(n: int = 512, include_demo_pack: bool = True,
                          total: Optional[int] = None) -> np.ndarray:
    """Boolean mask over ``make_battery(n)`` rows marking the artifact records
    (flatline, spike, wander); the demo rows, appended last, are not."""
    m = np.zeros(total if total is not None else n, bool)
    for i in range(n):
        if i % 16 == 5 or i % 23 == 7 or i % 31 == 11:
            m[i] = True
    return m


def robust_calibration_signals(n: int = 64, T: int = 5000, seed: int = 999) -> np.ndarray:
    """The diverse synthetic calibration set ``[n + 7, 12, T]``: the default
    int8 calibration (``ops.quant.default_calib_signals``).  Calibrating on the
    demo pack alone tightens in-distribution parity but leaves unusual inputs
    (fast rhythms, heavy noise, electrode artifacts) outside the calibrated
    activation range; this set bounds the whole battery (``BATTERY_GATE``)."""
    return make_battery(n=n, T=T, seed=seed, include_demo_pack=True)


def battery_demo_vectors(n: int, seed: int = 1234) -> np.ndarray:
    """Plausible demographic vectors ``[n, 5]`` for the multimodal battery
    (age/100, sex 0/0.5/1, height/250, weight/200, pacemaker always 0.0)."""
    rng = np.random.default_rng(seed + 77)
    age = rng.uniform(0.18, 0.95, n)
    sex = rng.choice([0.0, 0.5, 1.0], n, p=[0.48, 0.04, 0.48])
    height = rng.uniform(0.55, 0.82, n)
    weight = rng.uniform(0.2, 0.75, n)
    return np.stack([age, sex, height, weight, np.zeros(n)], 1).astype(np.float32)


def quant_accuracy_report(
    state: Dict[str, torch.Tensor],
    arch: str = "ecgcnn",
    int8_layers: Optional[Sequence[int]] = None,
    signals: Optional[np.ndarray] = None,
    num_labels: int = 5,
    batch: int = 128,
    threshold: float = 0.5,
    calib_signals: Optional[np.ndarray] = None,
    bias_correct: bool = False,
    q: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Quantized-vs-f32 probability error distribution on the battery.

    ``state`` is a reference-layout state dict (``params_io.load_checkpoint``).
    Errors are per-(record, class) |dprob| of the int8 forward against the
    f32 ``highest`` framework ``Predictor`` (two-pass z-score, TF32 off);
    ``flip_rate`` is the share of decisions at ``threshold`` that disagree.
    Pass ``q`` (a ``quantize_model`` result) to skip quantizing.  Returns
    ``{n, num_decisions, int8_layers, bias_correct, max, p99, p50, mean,
    flips, flip_rate, flip_margin}`` plus ``subsets`` on the default battery.
    """
    from ptbxl_torch.inference import Predictor
    from ptbxl_torch.ops.quant import default_int8_layers, quantize_model

    if int8_layers is None:
        int8_layers = default_int8_layers(arch)
    default_battery = signals is None
    if default_battery:
        signals = make_battery()
    x = np.asarray(signals, np.float32)
    if x.shape[1] != 12 and x.shape[2] == 12:
        x = x.transpose(0, 2, 1)  # -> [N, 12, T]
    n = len(x)
    if q is None:
        q = quantize_model(state, arch=arch, int8_layers=int8_layers,
                           calib_signals=calib_signals, bias_correct=bias_correct,
                           device=device)
    kw = dict(arch=arch, num_labels=num_labels, chunk_size=batch, device=device)
    ref = Predictor(state, engine="framework", precision="highest", **kw)
    quant = Predictor(state, precision="int8", qparams=q, **kw)
    demo = battery_demo_vectors(n) if arch == "multimodal" else None

    errs = []
    flips = 0
    flip_margin = 0.0  # worst |p_ref - threshold| among flipped decisions
    for s in range(0, n, batch):
        xb = x[s:s + batch]
        extra = {} if demo is None else {"demo": demo[s:s + batch]}
        p_ref = ref(xb, **extra)
        p_q = quant(xb, **extra)
        errs.append(np.abs(p_q - p_ref).reshape(-1))
        fl = (p_q >= threshold) != (p_ref >= threshold)
        flips += int(fl.sum())
        if fl.any():
            flip_margin = max(flip_margin, float(np.abs(p_ref[fl] - threshold).max()))

    e = np.concatenate(errs)
    report = {
        "n": n,
        "num_decisions": int(e.size),
        "int8_layers": tuple(int(i) for i in q["int8_layers"]),
        "bias_correct": bool(bias_correct),
        "max": float(e.max()),
        "p99": float(np.percentile(e, 99)),
        "p50": float(np.percentile(e, 50)),
        "mean": float(e.mean()),
        "flips": int(flips),
        "flip_rate": float(flips / e.size),
        # a decision can flip only where the f32 prob lies within max-err of the
        # threshold: how deep into the confident zone a flip reached
        "flip_margin": float(flip_margin),
    }
    if default_battery:  # the subset breakdown of the default battery
        per_rec = e.reshape(n, -1).max(axis=1)
        art = battery_artifact_mask(512, total=n)
        demo_rows = np.zeros(n, bool)
        demo_rows[512:] = True  # the demo pack, appended after the synthetic 512
        plain = ~art & ~demo_rows
        report["subsets"] = {
            "plain": {"n": int(plain.sum()), "max": float(per_rec[plain].max())},
            "artifact": {"n": int(art.sum()), "max": float(per_rec[art].max())},
            "demo": {"n": int(demo_rows.sum()),
                     "max": float(per_rec[demo_rows].max()) if demo_rows.any() else None},
        }
    return report


# The robust-preset gate (the JAX package's constant): max, p99 and flip rate
# of the 519-signal battery on the ecgcnn default layer set.
BATTERY_GATE = {"max": 4e-2, "p99": 3e-2, "flip_rate": 6e-3}


def passes_battery_gate(report: Dict[str, Any],
                        gate: Optional[Dict[str, float]] = None) -> bool:
    g = dict(BATTERY_GATE, **(gate or {}))
    return (report["max"] <= g["max"] and report["p99"] <= g["p99"]
            and report["flip_rate"] <= g["flip_rate"])
