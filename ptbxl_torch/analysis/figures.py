"""Figures and summary metrics of the analysis CLIs 14-17 (port of
``ptbxl_tpu/analysis/figures.py``).

From a merged prediction table: ``metrics_summary.csv``, macro-score bars,
per-class AUROC bars, the MI ROC comparison, the AF ROC/PR panels, per-class
ROC/PR sweeps and KDE probability densities, with the JAX package's geometry,
palettes and file names.  The scores and curves come from
``training/metrics.py`` in numpy (the port has no scikit-learn); tables are
``utils/table.py`` ``Table``s (no pandas).

matplotlib and seaborn are imported when a figure is drawn.  Where either is
missing, the figure is skipped with one ``[INFO] ... skipped`` line naming
its PNG; ``metrics_summary.csv`` is written either way.  Each draw function
returns whether it wrote its figure, each ``render_*`` a ``{png name:
written}`` map.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ptbxl_torch.training.metrics import (
    average_precision,
    precision_recall_curve,
    roc_auc,
    roc_curve,
)
from ptbxl_torch.utils.table import Table, write_csv

BLUE, ORANGE, GREEN, GREY = "#4C72B0", "#DD8452", "#55A868", "#888888"
LABELS_DEFAULT = ["MI", "STTC", "HYP", "CD", "NORM"]


def _pyplot(out_path, seaborn: bool = False):
    """(pyplot, seaborn or None), or None after the skip line where one is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sns = None
        if seaborn:
            import seaborn as sns
    except ImportError as e:
        print(f"[INFO] {e.name or 'matplotlib'} is not installed; skipped the figure {out_path}")
        return None
    return plt, sns


def _savefig(plt, fig, path) -> bool:
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=300)
    plt.close(fig)
    return True


def _values(t: Table, names: Sequence[str]) -> np.ndarray:
    """Columns of ``t`` as a float64 ``[N, len(names)]`` array."""
    return np.array([t[n] for n in names], dtype=np.float64).T


def _nanmean(values: Sequence[float]) -> float:
    """``np.nanmean``: nan where every value is nan (without its warning)."""
    kept = [v for v in values if not math.isnan(v)]
    return float(np.mean(kept)) if kept else float("nan")


def per_class_scores(y_true: np.ndarray, y_prob: np.ndarray) -> Dict:
    """Macro + per-class AUROC/AUPRC; a single-valued class gives nan for both.
    A non-finite score raises ``ValueError``, as scikit-learn's scores do."""
    aurocs, auprcs = [], []
    for k in range(y_true.shape[1]):
        yt, yp = y_true[:, k], y_prob[:, k]
        if np.unique(yt).size < 2:
            aurocs.append(np.nan)
            auprcs.append(np.nan)
        else:
            aurocs.append(roc_auc(yt, yp))
            auprcs.append(average_precision(yt, yp))
    return {
        "auroc_macro": _nanmean(aurocs),
        "auprc_macro": _nanmean(auprcs),
        "auroc_per_class": aurocs,
        "auprc_per_class": auprcs,
    }


def write_metrics_summary(metrics: Dict[str, Dict], labels: Sequence[str], out_path) -> None:
    """metrics_summary.csv in the reference's column layout (nan as an empty cell)."""
    rows = []
    for model_key, m in metrics.items():
        row = {"model": model_key, "auroc_macro": m["auroc_macro"], "auprc_macro": m["auprc_macro"]}
        row.update({f"auroc_{lb}": v for lb, v in zip(labels, m["auroc_per_class"])})
        row.update({f"auprc_{lb}": v for lb, v in zip(labels, m["auprc_per_class"])})
        rows.append(row)
    write_csv(str(out_path), {c: [r[c] for r in rows] for c in rows[0]})
    print(f"[INFO] Saved metrics table: {out_path}")


def grouped_bars(
    groups: Dict[str, List[float]],
    xticklabels: Sequence[str],
    ylabel: str,
    title: str,
    out_path,
    colors=(BLUE, ORANGE),
    figsize=(6, 4),
    annotate: bool = False,
    legend_loc: str = "lower right",
) -> bool:
    """Two-series grouped bar chart (figures 14 and 15)."""
    mods = _pyplot(out_path)
    if mods is None:
        return False
    plt = mods[0]
    keys = list(groups)
    x = np.arange(len(xticklabels))
    width = 0.35
    fig, ax = plt.subplots(figsize=figsize)
    for i, key in enumerate(keys):
        offset = (i - (len(keys) - 1) / 2) * width
        ax.bar(x + offset, groups[key], width, label=key, color=colors[i % len(colors)])
        if annotate:
            for xi, v in zip(x + offset, groups[key]):
                ax.text(xi, v + 0.01, f"{v:.3f}", ha="center", va="bottom", fontsize=8)
    ax.set_xticks(x)
    ax.set_xticklabels(xticklabels)
    ax.set_ylim(0, 1)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend(loc=legend_loc)
    ax.grid(axis="y", alpha=0.3)
    return _savefig(plt, fig, out_path)


def _curve(ax, kind, yt, yp, label, color=None):
    if kind == "roc":
        xs, ys, _ = roc_curve(yt, yp)
        score = roc_auc(yt, yp)
        text = f"{label} (AUROC={score:.3f})"
    else:
        ys, xs, _ = precision_recall_curve(yt, yp)
        score = average_precision(yt, yp)
        text = f"{label} (AUPRC={score:.3f})"
    ax.plot(xs, ys, linewidth=2, label=text, color=color)
    return score


def curve_panel(
    series,  # list of (label, y_true, y_prob, color-or-None)
    kind: str,  # 'roc' | 'pr'
    title: str,
    out_path,
    figsize=(6, 6),
    legend_loc: Optional[str] = None,
    legend_fontsize=8,
) -> bool:
    """A single axes of ROC or PR curves with a diagonal for ROC."""
    mods = _pyplot(out_path)
    if mods is None:
        return False
    plt = mods[0]
    fig, ax = plt.subplots(figsize=figsize)
    for label, yt, yp, color in series:
        if np.unique(yt).size < 2:
            print(f"[WARN] Skipped {kind.upper()} for {label} (y_true has single value).")
            continue
        _curve(ax, kind, yt, yp, label, color)
    if kind == "roc":
        ax.plot([0, 1], [0, 1], "--", color=GREY, linewidth=1)
        ax.set_xlabel("False Positive Rate")
        ax.set_ylabel("True Positive Rate")
        legend_loc = legend_loc or "lower right"
    else:
        ax.set_xlabel("Recall")
        ax.set_ylabel("Precision")
        legend_loc = legend_loc or "upper right"
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    ax.legend(loc=legend_loc, fontsize=legend_fontsize)
    return _savefig(plt, fig, out_path)


def af_roc_pr_panels(y_true, y_prob, out_path) -> bool:
    """Figure 17: AF ROC + PR side by side."""
    mods = _pyplot(out_path)
    if mods is None:
        return False
    plt = mods[0]
    fpr, tpr, _ = roc_curve(y_true, y_prob)
    precision, recall, _ = precision_recall_curve(y_true, y_prob)
    auroc = roc_auc(y_true, y_prob)
    auprc = average_precision(y_true, y_prob)

    fig, (ax_roc, ax_pr) = plt.subplots(1, 2, figsize=(10, 4))
    ax_roc.plot(fpr, tpr, color=GREEN, linewidth=2, label=f"AUROC={auroc:.3f}")
    ax_roc.plot([0, 1], [0, 1], "--", color=GREY, linewidth=1)
    ax_roc.set_title("AF ROC curve")
    ax_roc.set_xlabel("FPR")
    ax_roc.set_ylabel("TPR")
    ax_pr.plot(recall, precision, color=GREEN, linewidth=2, label=f"AUPRC={auprc:.3f}")
    ax_pr.set_title("AF Precision-Recall curve")
    ax_pr.set_xlabel("Recall")
    ax_pr.set_ylabel("Precision")
    for ax in (ax_roc, ax_pr):
        ax.legend()
        ax.grid(alpha=0.3)
    return _savefig(plt, fig, out_path)


def kde_panel(
    series,  # list of (values, label, color, style) — style in {'fill','line','dash'}
    title: str,
    out_path,
    figsize=(8, 5),
) -> bool:
    """Seaborn KDE density figure (CLIs 15-17's distribution plots)."""
    mods = _pyplot(out_path, seaborn=True)
    if mods is None:
        return False
    plt, sns = mods
    plt.figure(figsize=figsize)
    for values, label, color, style in series:
        kwargs = dict(label=label, color=color)
        if style == "fill":
            kwargs["fill"] = True
        elif style == "dash":
            kwargs["linestyle"] = "--"
        sns.kdeplot(np.asarray(values), **kwargs)
    plt.title(title)
    plt.xlabel("Predicted probability")
    plt.ylabel("Density")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(out_path, dpi=300)
    plt.close()
    return True


# ---------------------------------------------------------------------------
# Composite renderers, one per analysis CLI
# ---------------------------------------------------------------------------


def _af_prob_column(t: Table) -> Optional[str]:
    return next((c for c in t.columns if c.startswith("y_prob_AF")), None)


def render_summary_figures(t: Table, out_dir, labels=LABELS_DEFAULT) -> Dict[str, bool]:
    """CLI 14: metrics_summary.csv + figures 14-17."""
    out_dir = str(out_dir)
    y_true = _values(t, [f"y_true_{lb}" for lb in labels])
    prob_cols = {
        "ecg": [f"y_prob_{lb}" for lb in labels],
        "mm": [f"y_prob_{lb}_mm" for lb in labels],
    }
    display = {"ecg": "ECG-only", "mm": "ECG+demographics"}
    probs = {k: _values(t, cols) for k, cols in prob_cols.items()}
    metrics = {k: per_class_scores(y_true, p) for k, p in probs.items()}

    write_metrics_summary(metrics, labels, os.path.join(out_dir, "metrics_summary.csv"))

    drawn = {}
    drawn["figure14_macro_scores.png"] = grouped_bars(
        {"AUROC": [metrics[k]["auroc_macro"] for k in probs],
         "AUPRC": [metrics[k]["auprc_macro"] for k in probs]},
        [display[k] for k in probs],
        ylabel="Score",
        title="Macro AUROC / AUPRC on PTB-XL test set",
        out_path=os.path.join(out_dir, "figure14_macro_scores.png"),
        annotate=True,
    )
    drawn["figure15_per_class_auroc.png"] = grouped_bars(
        {display[k]: metrics[k]["auroc_per_class"] for k in probs},
        labels,
        ylabel="AUROC",
        title="Per-class AUROC comparison",
        out_path=os.path.join(out_dir, "figure15_per_class_auroc.png"),
        figsize=(8, 4),
    )
    drawn["figure16_mi_roc.png"] = curve_panel(
        [(display[k], y_true[:, 0], probs[k][:, 0], c)
         for k, c in zip(probs, (BLUE, ORANGE))],
        kind="roc",
        title="ROC curves for MI",
        out_path=os.path.join(out_dir, "figure16_mi_roc.png"),
        figsize=(5, 5),
        legend_fontsize=None,
    )
    af_col = _af_prob_column(t)
    if "y_true_AF" in t and af_col is not None:
        drawn["figure17_af_curves.png"] = af_roc_pr_panels(
            _values(t, ["y_true_AF"])[:, 0],
            _values(t, [af_col])[:, 0],
            os.path.join(out_dir, "figure17_af_curves.png"),
        )
        if drawn["figure17_af_curves.png"]:
            print("[INFO] AF figure saved.")
    else:
        print("[WARN] AF predictions not found; skip AF plots.")
    return drawn


def render_distribution_figures(t: Table, out_dir, labels=LABELS_DEFAULT) -> Dict[str, bool]:
    """CLI 15: MI, pooled, and AF probability-density figures."""
    out_dir = str(out_dir)
    yt_mi = np.asarray(t["y_true_MI"])
    p_mi, p_mi_mm = np.asarray(t["y_prob_MI"]), np.asarray(t["y_prob_MI_mm"])
    drawn = {"mi_distribution.png": kde_panel(
        [
            (p_mi[yt_mi == 1], "Baseline (MI=1)", BLUE, "fill"),
            (p_mi[yt_mi == 0], "Baseline (MI=0)", BLUE, "dash"),
            (p_mi_mm[yt_mi == 1], "Multimodal (MI=1)", ORANGE, "fill"),
            (p_mi_mm[yt_mi == 0], "Multimodal (MI=0)", ORANGE, "dash"),
        ],
        "MI prediction probability distribution",
        os.path.join(out_dir, "mi_distribution.png"),
    )}

    pooled = {"pos_base": [], "neg_base": [], "pos_mm": [], "neg_mm": []}
    for lb in labels:
        yt = np.asarray(t[f"y_true_{lb}"])
        base, mm = np.asarray(t[f"y_prob_{lb}"]), np.asarray(t[f"y_prob_{lb}_mm"])
        pooled["pos_base"].extend(base[yt == 1])
        pooled["neg_base"].extend(base[yt == 0])
        pooled["pos_mm"].extend(mm[yt == 1])
        pooled["neg_mm"].extend(mm[yt == 0])
    drawn["overall_prediction_distribution.png"] = kde_panel(
        [
            (pooled["pos_base"], "Baseline (Positive)", BLUE, "line"),
            (pooled["neg_base"], "Baseline (Negative)", BLUE, "dash"),
            (pooled["pos_mm"], "Multimodal (Positive)", ORANGE, "line"),
            (pooled["neg_mm"], "Multimodal (Negative)", ORANGE, "dash"),
        ],
        "Prediction probability distribution (all classes combined)",
        os.path.join(out_dir, "overall_prediction_distribution.png"),
    )

    if "y_true_AF" in t:
        yt_af = np.asarray(t["y_true_AF"])
        p = np.asarray(t[_af_prob_column(t)])
        drawn["af_prediction_distribution.png"] = kde_panel(
            [
                (p[yt_af == 1], "AF = 1", GREEN, "fill"),
                (p[yt_af == 0], "AF = 0", GREEN, "dash"),
            ],
            "AF prediction probability distribution",
            os.path.join(out_dir, "af_prediction_distribution.png"),
        )
    return drawn


def render_single_model_figures(
    t: Table,
    out_dir,
    labels=LABELS_DEFAULT,
    suffix: str = "",
    color: str = BLUE,
    file_names: Optional[Dict[str, str]] = None,
    titles: Optional[Dict[str, str]] = None,
    mi_labels=("MI positive", "MI negative"),
) -> Dict[str, bool]:
    """CLIs 16 (baseline, suffix='') and 17 (multimodal, suffix='_mm')."""
    out_dir = str(out_dir)
    names = file_names or {
        "roc": "baseline_per_class_roc.png",
        "pr": "baseline_per_class_pr.png",
        "mi": "baseline_mi_distribution.png",
    }
    titles = titles or {
        "roc": "Baseline model — ROC curves (per class)",
        "pr": "Baseline model — Precision-Recall curves (per class)",
        "mi": "Baseline model — MI probability distribution",
    }
    series = [
        (lb, _values(t, [f"y_true_{lb}"])[:, 0], _values(t, [f"y_prob_{lb}{suffix}"])[:, 0], None)
        for lb in labels
    ]
    drawn = {names[k]: curve_panel(series, k, titles[k], os.path.join(out_dir, names[k]))
             for k in ("roc", "pr")}
    yt = _values(t, ["y_true_MI"])[:, 0]
    yp = _values(t, [f"y_prob_MI{suffix}"])[:, 0]
    drawn[names["mi"]] = kde_panel(
        [(yp[yt == 1], mi_labels[0], color, "fill"), (yp[yt == 0], mi_labels[1], color, "dash")],
        titles["mi"],
        os.path.join(out_dir, names["mi"]),
    )
    return drawn
