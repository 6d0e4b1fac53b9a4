"""Training showdown: the port trained to completion against JAX's recorded runs
(port of ``tools/showdown.py``).

    python -m ptbxl_torch.tools.showdown run --from_jax outputs/showdown/jax_hard.json
    python -m ptbxl_torch.tools.showdown run --all           # every jax*.json, by family
    python -m ptbxl_torch.tools.showdown gen|port|compare|summary|calib [--hard] [--arch ...]
    python -m ptbxl_torch.tools.showdown port --device cpu --n_train 24 --n_val 16 --n_test 16 --epochs 1

The task is a synthetic mini-PTB-XL: full-size ``[12, 5000]`` records whose
five superclass labels live in the waveform morphology (1200 / 400 / 600
records by default; ``--hard`` halves the cues, doubles the noise and flips 4%
of the labels), trained with the reference's recipe (AdamW lr 1.5e-3, wd
1e-4, batch 64, the best epoch by validation AUPRC).  The dataset is made from
its seed with numpy alone and is bit for bit the JAX tool's.

The JAX arm is not run here: its artifacts (``jax*.json``, read from
``--jax_dir``, by default ``outputs/showdown/``, which this tool never
writes) are the reference.  ``run_port`` trains the port on the JAX arm's
batches (raw channels-last records, the order shuffled by
``default_rng(train_seed + epoch)``, the last batch padded from the epoch
order and masked, the z-score inside the step) and writes ``port{tag}.json``
in the JAX artifact's schema.  ``compare`` gates the port against JAX per
metric: ``deficit_vs_jax = max(0, jax - port)`` within 0.005 AUROC, 0.02
AUPRC and 0.10 F1@0.5, on paired seed means when a family has more than one
paired seed, where a deficit over budget with Welch t < 2 is marked
insignificant and passes.  The dataset ``.npz`` (~530 MB at full size), the
port's artifacts and the reports go to ``build/showdown/``.

``run --from_jax FILE`` trains the port with that artifact's stored config
(epochs differ across seeds) and compares its family; ``run --all`` does so
for every JAX artifact, one report per family.  Artifacts written before the
configs carried ``arch``, ``hard`` and ``jax_torch_init`` store them as
``null``: they read as baseline, False, False.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ptbxl_torch.models.factory import build_ecgcnn, build_multimodal
from ptbxl_torch.training.loop import (
    eval_one_epoch,
    make_eval_step,
    make_train_step,
    predict_all,
    train_one_epoch,
)
from ptbxl_torch.training.metrics import compute_metrics, f1_macro
from ptbxl_torch.training.thresholds import (
    apply_thresholds,
    quantile_candidates,
    search_thresholds_per_class,
)
from ptbxl_torch.training.train_state import create_train_state
from ptbxl_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]
OUT_DIR = os.path.join(ROOT, "build", "showdown")
JAX_DIR = os.path.join(ROOT, "outputs", "showdown")


# ---------------------------------------------------------------- dataset

def synth_record(rng, t, labels, T, fs, hard=False):
    """One [12, T] record whose morphology encodes the 5 superclass labels.

    Cues (each with per-record strength, so some examples are hard):
      MI   - ST-depression-like negative deflection trailing each beat
      STTC - beat-gated high-frequency ripple
      HYP  - enlarged beat amplitude
      CD   - widened beats (lower sharpening power)
      NORM - none of the above (label = absence, like PTB-XL's NORM)

    ``hard`` scales the cue strengths by 0.45 and the noise from 0.35 to 0.75,
    so the task plateaus mid-range instead of saturating.
    """
    mi, sttc, hyp, cd, _norm = labels
    cue = 0.45 if hard else 1.0  # cue-strength multiplier
    noise = 0.75 if hard else 0.35
    hr = rng.uniform(0.9, 1.4)  # beats/s
    phase = rng.uniform(0, 2 * np.pi)
    width_pow = 9.0 - 5.0 * cd * cue * rng.uniform(0.6, 1.0)  # CD: wider QRS
    carrier = np.sin(2 * np.pi * hr * t + phase)
    beat = np.sign(carrier) * np.abs(carrier) ** width_pow
    envelope = np.abs(carrier) ** 6

    amp = 1.0 + 0.8 * cue * hyp * rng.uniform(0.5, 1.2)  # HYP: amplitude
    x = amp * beat

    if mi:
        s = cue * rng.uniform(0.4, 1.0)
        shift = int(0.15 * fs)  # deflection ~150 ms after the beat peak
        x = x - 0.45 * s * np.roll(envelope, shift)
    if sttc:
        s = cue * rng.uniform(0.4, 1.0)
        x = x + 0.35 * s * envelope * np.sin(2 * np.pi * 9.0 * t + phase)

    leads = []
    for _ in range(12):
        g = rng.uniform(0.5, 1.5)
        wander = 0.2 * np.sin(2 * np.pi * rng.uniform(0.1, 0.3) * t + rng.uniform(0, 6))
        leads.append(g * x + wander + noise * rng.standard_normal(T))
    return np.stack(leads).astype(np.float32)


def make_split(n, seed, T=5000, fs=500.0, hard=False, label_flip=0.0):
    """``n`` records ``[n, 12, T]`` f32 and their labels ``[n, 5]`` from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    ys, xs = [], []
    for _ in range(n):
        lab = (rng.uniform(size=4) < 0.35).astype(np.float32)
        norm = 1.0 if lab.sum() == 0 else 0.0
        y = np.concatenate([lab, [norm]]).astype(np.float32)
        xs.append(synth_record(rng, t, y, T, fs, hard=hard))
        if label_flip:
            # label noise after the waveform: an irreducible AUROC ceiling
            # (deterministic per seed)
            flip = rng.uniform(size=5) < label_flip
            y = np.where(flip, 1.0 - y, y).astype(np.float32)
        ys.append(y)
    return np.stack(xs), np.stack(ys)


def dataset_path(cfg):
    tag = "_hard" if cfg.get("hard") else ""
    return os.path.join(
        OUT_DIR, f"miniptb_{cfg['n_train']}_{cfg['n_val']}_{cfg['n_test']}"
        f"_T{cfg['T']}_s{cfg['seed']}{tag}.npz"
    )


def make_dataset(cfg):
    """The three splits of ``cfg``'s dataset: ``{x_train, y_train, x_val, ...}``."""
    hard = bool(cfg.get("hard"))
    flip = 0.04 if hard else 0.0
    out = {}
    for k, split in enumerate(("train", "val", "test")):
        out[f"x_{split}"], out[f"y_{split}"] = make_split(
            cfg[f"n_{split}"], cfg["seed"] + k, cfg["T"], hard=hard, label_flip=flip)
    return out


def ensure_dataset(cfg):
    """Write ``cfg``'s dataset to ``dataset_path(cfg)`` unless it is there; the path."""
    path = dataset_path(cfg)
    if os.path.exists(path):
        return path
    os.makedirs(OUT_DIR, exist_ok=True)
    print(f"[showdown] generating dataset -> {path}", flush=True)
    t0 = time.time()
    # uncompressed: white noise does not compress, and every run reloads it
    np.savez(path, **make_dataset(cfg))
    print(f"[showdown] dataset done in {time.time() - t0:.0f}s", flush=True)
    return path


def zscore(x):
    """Per-record per-lead z-score, reference semantics ((x-mean)/(std+1e-6),
    reference: src/datasets/ptbxl.py:122-127)."""
    mean = x.mean(axis=-1, keepdims=True)
    std = x.std(axis=-1, keepdims=True)
    return (x - mean) / (std + 1e-6)


def synth_demo_split(y, seed):
    """Label-correlated synthetic demographics [age, sex, height, weight,
    pacemaker] in the reference demo-vector convention (already-normalized
    floats, reference: src/datasets/ptbxl_ecg_multimodal.py:106-164).

    Derived from the stored (post-label-noise) labels and ``seed`` alone, so
    every arm reads the same demographics without regenerating the waveforms.
    Age and weight rise with HYP, sex skews with MI, pacemaker with CD.
    """
    rng = np.random.default_rng(seed)
    n = len(y)
    mi, sttc, hyp, cd = (y[:, i] for i in range(4))
    age = 0.50 + 0.15 * hyp + 0.10 * cd + 0.08 * rng.standard_normal(n)
    sex = (rng.uniform(size=n) < 0.5 + 0.25 * mi - 0.15 * sttc).astype(np.float32)
    height = 0.85 - 0.03 * hyp + 0.05 * rng.standard_normal(n)
    weight = 0.50 + 0.12 * hyp + 0.07 * rng.standard_normal(n)
    pace = (rng.uniform(size=n) < 0.03 + 0.15 * cd).astype(np.float32)
    return np.stack([age, sex, height, weight, pace], axis=1).astype(np.float32)


def _prob_stats(y, probs, threshold=0.5):
    """Calibration diagnostics around the fixed 0.5 threshold, flattened over
    (sample, class) decisions."""
    y = np.asarray(y).reshape(-1)
    p = np.asarray(probs).reshape(-1)
    pos, neg = p[y > 0.5], p[y <= 0.5]
    qs = (0, 10, 25, 50, 75, 90, 100)

    def qd(a):
        if not a.size:
            return None
        return {str(q): round(float(np.percentile(a, q)), 4) for q in qs}

    return {
        "threshold": threshold,
        "pos_quantiles": qd(pos),
        "neg_quantiles": qd(neg),
        "pos_mean": float(pos.mean()) if pos.size else None,
        "neg_mean": float(neg.mean()) if neg.size else None,
        # recall / false-positive-rate at the fixed threshold
        "pos_above": float((pos >= threshold).mean()) if pos.size else None,
        "neg_above": float((neg >= threshold).mean()) if neg.size else None,
    }


def arch_labels(y, arch):
    """baseline/multimodal: the 5 superclass labels; af: a single-logit binary
    task with the MI morphology cue as the positive class (the AF task's
    shape, reference: scripts/05_train_af_binary.py:121-124)."""
    if arch == "af":
        return y[:, :1].copy()
    return y


# ---------------------------------------------------------------- the port's arm

def normalize_config(cfg):
    """A copy of ``cfg`` with the ``null`` fields of older artifacts read as
    ``arch`` baseline, ``hard`` False, ``jax_torch_init`` False."""
    out = dict(cfg)
    out["arch"] = out.get("arch") or "baseline"
    out["hard"] = bool(out.get("hard"))
    out["jax_torch_init"] = bool(out.get("jax_torch_init"))
    return out


def device_info(dev):
    """The device a run took: ``name`` and, on a GPU, ``nvidia-smi``'s power limit."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    limit = smi.stdout.strip().split(", ")[-1] if smi.returncode == 0 else None
    return {"name": torch.cuda.get_device_name(dev), "power_limit": limit}


def epochs_of(x, y, d, batch_size, shuffle, seed):
    """The JAX arm's batching over tensors already on the device.

    ``x`` [N, T, 12], ``y`` [N, L], ``d`` [N, 5] or None.  ``epoch(e)``
    yields ``{ecg, y, mask[, demo]}`` batches of ``batch_size`` in the order
    ``default_rng(seed + e)`` shuffles (unshuffled: 0..N-1), the last batch
    padded from the epoch order and masked; the epoch's row indices and masks
    go to the device in one copy each.
    """
    n = len(x)

    def epoch(e):
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + e).shuffle(order)
        rows, masks = [], []
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            real = len(idx)
            if real < batch_size:
                idx = np.concatenate([idx, np.resize(order, batch_size - real)])
            rows.append(idx)
            masks.append(np.arange(batch_size) < real)
        rows = torch.from_numpy(np.stack(rows)).to(x.device)
        masks = torch.from_numpy(np.stack(masks).astype(np.float32)).to(x.device)
        for idx, mask in zip(rows, masks):
            batch = {"ecg": x[idx], "y": y[idx], "mask": mask}
            if d is not None:
                batch["demo"] = d[idx]
            yield batch

    return epoch


def _train_seed(cfg):
    """Model-init/shuffle seed: ``train_seed`` when given (0 is a valid seed),
    else ``seed``."""
    ts = cfg.get("train_seed")
    return cfg["seed"] if ts is None else ts


def _build(cfg, dev):
    arch, seed, ti = cfg["arch"], _train_seed(cfg), cfg["jax_torch_init"]
    if arch == "multimodal":
        return build_multimodal(num_labels=5, seed=seed, torch_init=ti, device=dev)
    return build_ecgcnn(num_labels=1 if arch == "af" else 5, seed=seed, torch_init=ti,
                        device=dev)


def run_port(cfg, device=None):
    """Train the port with ``cfg`` (the JAX arm's recipe) and write ``port{tag}.json``.

    f32 at ``precision='highest'``; the best state by validation AUPRC is kept
    as a copy of the state dict and loaded back before predicting test and val.
    Runs on ``cuda`` unless ``device`` says otherwise.
    """
    cfg = normalize_config(cfg)
    dev = resolve_device(device)
    arch = cfg["arch"]
    multimodal = arch == "multimodal"
    data = np.load(ensure_dataset(cfg))
    splits = {}
    for k, split in enumerate(("train", "val", "test")):
        y = data[f"y_{split}"]
        d = synth_demo_split(y, cfg["seed"] + 10 + k) if multimodal else None
        splits[split] = (
            # raw signals, channels-last: the step z-scores them
            torch.from_numpy(data[f"x_{split}"]).to(dev).transpose(1, 2).contiguous(),
            torch.from_numpy(arch_labels(y, arch)).to(dev),
            None if d is None else torch.from_numpy(d).to(dev))
    bs = cfg["batch_size"]
    train_seed = _train_seed(cfg)
    tr = epochs_of(*splits["train"], bs, True, train_seed)
    va = epochs_of(*splits["val"], bs, False, 0)
    te = epochs_of(*splits["test"], bs, False, 0)

    model = _build(cfg, dev)
    state = create_train_state(model, cfg["lr"], cfg["weight_decay"])
    train_step = make_train_step(multimodal=multimodal)
    eval_step = make_eval_step(multimodal=multimodal)

    curves = []
    best = {"val_auprc": -1.0, "state": None, "epoch": -1}
    t_start = time.time()
    for epoch in range(cfg["epochs"]):
        state, train_loss = train_one_epoch(state, train_step, tr(epoch))
        val_m = eval_one_epoch(state, eval_step, va(0))
        curves.append({"epoch": epoch, "train_bce": train_loss,
                       "val_auroc": val_m["auroc_macro"],
                       "val_auprc": val_m["auprc_macro"],
                       "val_f1": val_m["f1_macro"]})
        print(f"[port] epoch {epoch}: train_bce {train_loss:.4f} "
              f"val_auroc {val_m['auroc_macro']:.4f} "
              f"val_auprc {val_m['auprc_macro']:.4f} "
              f"({time.time() - t_start:.1f}s)", flush=True)
        if val_m["auprc_macro"] > best["val_auprc"]:  # reference: scripts/03:164-168
            best = {"val_auprc": val_m["auprc_macro"], "epoch": epoch,
                    "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}

    model.load_state_dict(best["state"])
    y_true, y_prob, _ = predict_all(state, eval_step, te(0))
    test_m = compute_metrics(y_true, y_prob, threshold=0.5)
    vy, vp, _ = predict_all(state, eval_step, va(0))  # the best model's val probs
    out = {
        "framework": "port", "config": cfg, "curves": curves,
        "best_epoch": best["epoch"],
        "test_auroc_macro": test_m["auroc_macro"],
        "test_auprc_macro": test_m["auprc_macro"],
        "test_f1_macro": test_m["f1_macro"],
        "test_prob_stats": _prob_stats(y_true, y_prob),
        "test_probs": np.round(y_prob, 6).tolist() if len(y_true) <= 1000 else None,
        "test_y": y_true.tolist() if len(y_true) <= 1000 else None,
        # a deployable threshold is fit on val (`calib` reads these)
        "val_probs": np.round(vp, 6).tolist() if len(vy) <= 1000 else None,
        "val_y": vy.tolist() if len(vy) <= 1000 else None,
        "wall_s": time.time() - t_start,
        "train_steps": state.step,
        "device": device_info(dev),
    }
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"port{_tag(cfg)}.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(f"[port] FINAL test auroc {test_m['auroc_macro']:.4f} "
          f"auprc {test_m['auprc_macro']:.4f} (best epoch {best['epoch']}, "
          f"{out['wall_s']:.1f}s on {out['device']['name']})", flush=True)
    return out


# ---------------------------------------------------------------- compare

_ARCH_TAG = {"baseline": "", "multimodal": "_mm", "af": "_af"}


def _variant_base(cfg):
    """The arch/variant part of an artifact name: what a seed family shares."""
    cfg = normalize_config(cfg)
    return _ARCH_TAG[cfg["arch"]] + ("_hard" if cfg["hard"] else "")


def _tag(cfg):
    """Artifact-name tag: the variant, ``_tsN`` for an explicit train seed,
    ``_ti`` for the torch-default init (in both arms)."""
    tag = _variant_base(cfg)
    if cfg.get("train_seed") is not None:
        tag += f"_ts{cfg['train_seed']}"
    if cfg.get("jax_torch_init"):
        tag += "_ti"
    return tag


def family_of(cfg):
    """A seed family's name: the variant and ``_ti`` ('' is the baseline)."""
    return _variant_base(cfg) + ("_ti" if cfg.get("jax_torch_init") else "")


# The three reference-visible test metrics (F1 at the fixed 0.5 threshold).
_METRIC_KEYS = {"auroc": "test_auroc_macro", "auprc": "test_auprc_macro",
                "f1": "test_f1_macro"}


def _collect_seed_runs(framework, variant_base, ti=False, directory=None):
    """Per-seed result files of one arm in ``directory`` (default ``OUT_DIR``):
    ``{seed_tag: run}``, each run carrying its file name, stored config and the
    three gated metrics.

    Matches ``{framework}{base}.json`` and ``..._tsNN.json``, or their ``_ti``
    forms with ``ti=True``, so the two inits never pool.  Runs are keyed by the
    effective train seed of the stored config: a base artifact (seed =
    ``seed``) and an explicit ``_tsN`` one with the same number are one seed,
    and the explicitly tagged artifact is kept.
    """
    directory = OUT_DIR if directory is None else directory
    suffix = "_ti" if ti else ""
    pat = re.compile(rf"^{framework}{variant_base}(_ts\d+)?{suffix}\.json$")
    out = {}
    for f in sorted(os.listdir(directory)) if os.path.isdir(directory) else []:
        m = pat.match(f)
        if not m:
            continue
        with open(os.path.join(directory, f)) as fh:
            d = json.load(fh)
        cfg = d.get("config", {})
        eff = cfg.get("train_seed")
        if eff is None:
            eff = cfg.get("seed")
        key = f"_ts{eff}" if eff is not None else (m.group(1) or "")
        run = {"file": f, "config": cfg,
               "metrics": {k: d[v] for k, v in _METRIC_KEYS.items()}}
        if key in out:
            keep_new = bool(m.group(1))
            print(f"[showdown] WARNING: {f} and {out[key]['file']} resolve "
                  f"to the same effective train seed ({key.lstrip('_')}); "
                  f"keeping {'the explicitly tagged' if keep_new else 'the first'} one.",
                  file=sys.stderr)
            if not keep_new:
                continue
        out[key] = run
    return out


# Keys two runs must agree on to be comparable: the task (dataset sizes, seed,
# variant, T), the recipe (batch, lr, wd) and the epoch budget.  train_seed
# differs by design (that is the seed family).
_COMPARABILITY_KEYS = ("n_train", "n_val", "n_test", "T", "batch_size",
                       "epochs", "lr", "weight_decay", "seed", "hard")


def _config_mismatch(a, b):
    """{key: [a_val, b_val]} for comparability keys that differ ({} if
    comparable); ``hard`` is read as a bool (older artifacts store null)."""
    diffs = {}
    for k in _COMPARABILITY_KEYS:
        va, vb = a.get(k), b.get(k)
        if k == "hard":
            va, vb = bool(va), bool(vb)
        if va != vb:
            diffs[k] = [va, vb]
    return diffs


def _welch_t(a, b):
    """Welch t-statistic of mean(a) - mean(b); None when either arm has
    fewer than two values or no spread."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if len(a) < 2 or len(b) < 2:
        return None
    va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
    denom = float(np.sqrt(va + vb))
    if denom == 0.0:
        return None
    return float((a.mean() - b.mean()) / denom)


def compare(cfg, budget=0.005, budget_auprc=0.02, budget_f1=0.10, jax_dir=None):
    """Gate the port's artifacts of ``cfg``'s family against JAX's; the report.

    Per metric, ``deficit_vs_jax = max(0, jax - port)`` within its budget, on
    the paired seed means when more than one seed is paired (both arms ran it
    with comparable configs); an over-budget mean deficit with Welch t < 2 is
    marked ``insignificant_deficit`` and passes.  The report, without the JAX
    arm's ``wall_s``, goes to ``report_port{tag}.json`` in ``OUT_DIR``.
    """
    cfg = normalize_config(cfg)
    jax_dir = JAX_DIR if jax_dir is None else jax_dir
    budgets = {"auroc": budget, "auprc": budget_auprc, "f1": budget_f1}
    tag = _tag(cfg)
    with open(os.path.join(OUT_DIR, f"port{tag}.json")) as f:
        p = json.load(f)
    with open(os.path.join(jax_dir, f"jax{tag}.json")) as f:
        j = json.load(f)
    keys = ("test_auroc_macro", "test_auprc_macro", "test_f1_macro", "best_epoch")
    report = {
        "port": {k: p[k] for k in keys + ("wall_s", "device")},
        "jax": {k: j[k] for k in keys},
        "budget": budget,
        "deficit_vs_jax": max(0.0, j["test_auroc_macro"] - p["test_auroc_macro"]),
        "config": p["config"],
    }
    mism = _config_mismatch(p.get("config", {}), j.get("config", {}))
    if mism:
        report["config_mismatch"] = mism
        print(f"[showdown] WARNING: primary artifacts are not comparable "
              f"(stored configs differ): {mism}", file=sys.stderr, flush=True)

    metrics = {}
    for m, key in _METRIC_KEYS.items():
        metrics[m] = {"port": p[key], "jax": j[key], "delta": abs(p[key] - j[key]),
                      "deficit_vs_jax": max(0.0, j[key] - p[key]), "budget": budgets[m]}

    base, ti = _variant_base(cfg), cfg["jax_torch_init"]
    p_runs = _collect_seed_runs("port", base, ti, OUT_DIR)
    j_runs = _collect_seed_runs("jax", base, ti, jax_dir)
    paired, dropped = {}, []
    for s in sorted(set(p_runs) | set(j_runs)):
        pr, jr = p_runs.get(s), j_runs.get(s)
        if pr is None or jr is None:
            dropped.append({"seed_tag": s or "(base)", "reason": "unpaired",
                            "file": (pr or jr)["file"]})
            continue
        mism = _config_mismatch(pr["config"], jr["config"])
        if mism:
            dropped.append({"seed_tag": s or "(base)",
                            "reason": f"arm config mismatch: {mism}",
                            "file": f"{pr['file']} vs {jr['file']}"})
            continue
        paired[s] = (pr, jr)
    if dropped:
        report["seed_runs_dropped"] = dropped
    means_mode = len(paired) > 1
    if means_mode:
        report["seed_runs"] = {
            "port": {pr["file"]: pr["metrics"] for pr, _ in paired.values()},
            "jax": {jr["file"]: jr["metrics"] for _, jr in paired.values()}}
        for m, e in metrics.items():
            pv = [pr["metrics"][m] for pr, _ in paired.values()]
            jv = [jr["metrics"][m] for _, jr in paired.values()]
            e["mean"] = {"port": float(np.mean(pv)), "jax": float(np.mean(jv))}
            e["sd"] = {"port": float(np.std(pv, ddof=1)), "jax": float(np.std(jv, ddof=1))}
            e["n"] = len(paired)
            e["delta_means"] = abs(e["mean"]["port"] - e["mean"]["jax"])
            e["deficit_vs_jax_means"] = max(0.0, e["mean"]["jax"] - e["mean"]["port"])
            e["welch_t"] = _welch_t(jv, pv)  # positive: JAX ahead

    gates = {}
    for m, e in metrics.items():
        gates[m] = bool(e.get("deficit_vs_jax_means", e["deficit_vs_jax"]) <= e["budget"])
        # a deficit over budget that seed noise explains at ~95% confidence
        # (Welch t < 2) is no evidence of a regression: marked, not failed
        t_stat = e.get("welch_t")
        if not gates[m] and t_stat is not None and t_stat < 2.0:
            gates[m] = True
            e["insignificant_deficit"] = True
        e["within_budget"] = gates[m]
    report["metrics"] = metrics
    report["within_budget_per_metric"] = gates
    report["within_budget"] = all(gates.values())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"report_port{tag}.json"), "w") as f:
        json.dump(report, f, indent=2)

    def mark(m):
        if metrics[m].get("insignificant_deficit"):
            return f" (ns, t={metrics[m]['welch_t']:.2f})"
        return "" if gates[m] else " FAIL"

    line = " | ".join(
        f"{m} {metrics[m].get('deficit_vs_jax_means', metrics[m]['deficit_vs_jax']):.4f}"
        f"/{metrics[m]['budget']}{mark(m)}" for m in _METRIC_KEYS)
    kind = f"mean deficit, {len(paired)} seeds" if means_mode else "deficit"
    verdict = "OK" if report["within_budget"] else "FAIL"
    print(f"[showdown] family '{family_of(cfg) or 'baseline'}' {verdict} ({kind} per "
          f"metric): {line}", flush=True)
    return report


def calibration_analysis(cfg=None, jax_dir=None):
    """Threshold and calibration analysis over both arms' artifacts that carry
    test probabilities: F1 at 0.5, at the best single global threshold on test
    (an oracle upper bound) and at the threshold fit on the best model's
    validation probabilities (per class for 5 labels; the deployable estimate),
    and the positive / negative probability medians.
    """
    jax_dir = JAX_DIR if jax_dir is None else jax_dir
    base = _variant_base(cfg or {})
    pat = re.compile(rf"^(port|jax){base}(_ts\d+)?(_ti)?\.json$")
    files = []
    for directory in (OUT_DIR, jax_dir):
        if os.path.isdir(directory):
            files += [(directory, f) for f in sorted(os.listdir(directory)) if pat.match(f)]

    def search(probs, labels):
        # one global threshold over quantiles, 0.5 and every positive's probability
        cand = quantile_candidates(probs.reshape(-1), positives=probs[labels > 0.5].reshape(-1))
        bt, bf = 0.5, -1.0
        for t in cand:
            f1 = f1_macro(labels, probs >= t)
            if f1 > bf:
                bt, bf = float(t), f1
        return bt, bf

    rows = []
    for directory, f in files:
        with open(os.path.join(directory, f)) as fh:
            d = json.load(fh)
        if not d.get("test_probs"):
            continue
        p = np.asarray(d["test_probs"], np.float32)
        y = np.asarray(d["test_y"], np.float32)
        best_t, best_f1 = search(p, y)
        pos, neg = p[y > 0.5], p[y <= 0.5]
        row = {"file": f, "framework": pat.match(f).group(1),
               "f1_at_0.5": float(d["test_f1_macro"]),
               "best_threshold": best_t, "f1_at_best": best_f1,
               "pos_median": float(np.median(pos)) if pos.size else None,
               "neg_median": float(np.median(neg)) if neg.size else None}
        if d.get("val_probs"):
            vp = np.asarray(d["val_probs"], np.float32)
            vy = np.asarray(d["val_y"], np.float32)
            if p.ndim == 2 and p.shape[1] > 1:
                vt = search_thresholds_per_class(vy, vp)
                row["val_threshold"] = [round(float(x), 6) for x in vt]
                row["f1_at_val_threshold"] = f1_macro(y, apply_thresholds(p, vt))
            else:
                vt, _ = search(vp, vy)
                row["val_threshold"] = vt
                row["f1_at_val_threshold"] = f1_macro(y, p >= vt)
        rows.append(row)
        med = lambda v: "n/a" if v is None else f"{v:.4f}"  # noqa: E731
        vcell = ""
        if "val_threshold" in row:
            vth = row["val_threshold"]
            vts = (f"{vth:.3g}" if np.isscalar(vth)
                   else "[" + ",".join(f"{x:.3g}" for x in vth) + "]")
            vcell = f"val-fit t={vts} f1 {row['f1_at_val_threshold']:.4f} | "
        print(f"{f:34s} f1@0.5 {row['f1_at_0.5']:.4f} | "
              f"oracle t={best_t:.3g} f1 {best_f1:.4f} | {vcell}"
              f"pos med {med(row['pos_median'])} neg med {med(row['neg_median'])}",
              flush=True)
    if not rows:
        print("[showdown] no artifacts with stored test_probs for this variant")
        return rows
    for fw in ("port", "jax"):
        sel = [r for r in rows if r["framework"] == fw]
        if sel:
            withval = [r["f1_at_val_threshold"] for r in sel if "f1_at_val_threshold" in r]
            vcell = (f" -> mean f1@val-fit {np.mean(withval):.4f} (n={len(withval)})"
                     if withval else "")
            print(f"[{fw}] mean f1@0.5 {np.mean([r['f1_at_0.5'] for r in sel]):.4f} "
                  f"-> mean f1@oracle {np.mean([r['f1_at_best'] for r in sel]):.4f} "
                  f"(n={len(sel)}){vcell}", flush=True)
    return rows


def summary(jax_dir=None):
    """Print every recorded run of both arms, grouped by arch, variant and arm."""
    jax_dir = JAX_DIR if jax_dir is None else jax_dir
    pat = re.compile(r"^(port|jax)(_mm|_af)?(_hard)?(_ts\d+)?(_ti)?\.json$")
    rows = {}
    for directory in (OUT_DIR, jax_dir):
        for f in sorted(os.listdir(directory)) if os.path.isdir(directory) else []:
            m = pat.match(f)
            if not m:
                continue
            fw, arch, hard, _, ti = m.groups()
            arch = {None: "baseline", "_mm": "multimodal", "_af": "af"}[arch]
            arm = fw + (" (torch-init)" if ti else "")
            with open(os.path.join(directory, f)) as fh:
                d = json.load(fh)
            where = d["device"]["name"] if "device" in d else d.get("backend", "cpu")
            rows.setdefault((arch, "hard" if hard else "standard", arm), []).append(
                (d["test_auroc_macro"], d["test_f1_macro"], where))
    if not rows:
        print("[showdown] no artifacts")
    for (arch, variant, arm), vals in sorted(rows.items()):
        aurocs = [v[0] for v in vals]
        sd = float(np.std(aurocs, ddof=1)) if len(aurocs) > 1 else 0.0
        print(f"{arch:10s} {variant:8s} {arm:18s} n={len(aurocs)} "
              f"auroc {np.mean(aurocs):.4f} sd {sd:.4f} "
              f"f1@0.5 {np.mean([v[1] for v in vals]):.4f}  "
              f"[{', '.join(f'{a:.4f}' for a in sorted(aurocs))}] "
              f"on {sorted({v[2] for v in vals})}")


# ---------------------------------------------------------------- from JAX's artifacts

JAX_ARTIFACT = re.compile(r"^jax(_mm|_af)?(_hard)?(_ts\d+)?(_ti)?\.json$")


def jax_config(path):
    """The normalized config stored in a JAX artifact; raises if the file's
    name is not the one its config gives."""
    with open(path) as f:
        cfg = normalize_config(json.load(f)["config"])
    if os.path.basename(path) != f"jax{_tag(cfg)}.json":
        raise ValueError(f"{path}: its config names it jax{_tag(cfg)}.json")
    return cfg


def jax_families(jax_dir=None):
    """Every JAX artifact in ``jax_dir`` by family: ``{family: [config, ...]}``,
    the base artifact (no explicit train seed) first."""
    jax_dir = JAX_DIR if jax_dir is None else jax_dir
    families = {}
    for f in sorted(os.listdir(jax_dir)):
        if JAX_ARTIFACT.match(f):
            cfg = jax_config(os.path.join(jax_dir, f))
            families.setdefault(family_of(cfg), []).append(cfg)
    for cfgs in families.values():
        cfgs.sort(key=lambda c: c.get("train_seed") is not None)
    return families


def run_families(families, device=None, jax_dir=None, **budgets):
    """Train the port on every config of ``families``, then compare each family
    (its first config as the primary pair); ``{family: report}``."""
    reports = {}
    for fam, cfgs in families.items():
        for cfg in cfgs:
            print(f"[showdown] port run {fam or 'baseline'} -> port{_tag(cfg)}.json "
                  f"(epochs {cfg['epochs']})", flush=True)
            run_port(cfg, device)
        reports[fam] = compare(cfgs[0], jax_dir=jax_dir, **budgets)
    return reports


def make_config(args):
    return {"n_train": args.n_train, "n_val": args.n_val, "n_test": args.n_test,
            "T": 5000, "seed": args.seed, "batch_size": 64, "epochs": args.epochs,
            "lr": 1.5e-3, "weight_decay": 1e-4, "hard": args.hard,
            "train_seed": args.train_seed, "arch": args.arch,
            "jax_torch_init": args.jax_torch_init}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cmd", choices=["run", "gen", "port", "compare", "summary", "calib"])
    p.add_argument("--from_jax", default=None, metavar="FILE",
                   help="run: train the port with this JAX artifact's stored config")
    p.add_argument("--all", action="store_true",
                   help="run: every jax*.json in --jax_dir, one report per family")
    p.add_argument("--jax_dir", default=JAX_DIR, help="the JAX arm's artifacts (read only)")
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    p.add_argument("--hard", action="store_true",
                   help="low-SNR + 4%% label-noise variant")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--arch", default="baseline", choices=["baseline", "multimodal", "af"])
    p.add_argument("--jax_torch_init", action="store_true",
                   help="the reference torch default init (models' torch_init=True)")
    p.add_argument("--train_seed", type=int, default=None,
                   help="model-init/shuffle seed (default: --seed); the dataset "
                        "stays keyed by --seed")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--n_train", type=int, default=1200)
    p.add_argument("--n_val", type=int, default=400)
    p.add_argument("--n_test", type=int, default=600)
    p.add_argument("--budget", type=float, default=0.005, help="AUROC deficit budget")
    p.add_argument("--budget_auprc", type=float, default=0.02)
    p.add_argument("--budget_f1", type=float, default=0.10)
    args = p.parse_args(argv)
    if args.epochs < 1:
        p.error("--epochs must be >= 1 (the best epoch is selected)")
    budgets = {"budget": args.budget, "budget_auprc": args.budget_auprc,
               "budget_f1": args.budget_f1}
    cfg = make_config(args)

    if args.cmd == "summary":
        summary(args.jax_dir)
    elif args.cmd == "calib":
        calibration_analysis(cfg, args.jax_dir)
    elif args.cmd == "gen":
        ensure_dataset(cfg)
    elif args.cmd == "port":
        run_port(cfg, args.device)
    elif args.cmd == "compare":
        return 0 if compare(cfg, jax_dir=args.jax_dir, **budgets)["within_budget"] else 1
    else:  # run
        if args.all == (args.from_jax is not None):
            p.error("run takes exactly one of --from_jax FILE and --all")
        if args.all:
            families = jax_families(args.jax_dir)
        else:
            cfg = jax_config(args.from_jax)
            families = {family_of(cfg): [cfg]}
        reports = run_families(families, args.device, args.jax_dir, **budgets)
        failed = [fam or "baseline" for fam, r in reports.items() if not r["within_budget"]]
        print(f"[showdown] {len(reports) - len(failed)}/{len(reports)} families within "
              f"budget" + (f"; failed: {failed}" if failed else ""), flush=True)
        return 1 if failed else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
