"""The port's eval-path library (ptbxl_torch/analysis/, data/demo_export.py,
data/ptb_test.py, the curves of training/metrics.py) against the JAX package
and scikit-learn, on the CPU.

* ``roc_curve`` / ``precision_recall_curve`` equal scikit-learn's arrays
  (values, dtypes, nan), ``roc_auc`` / ``average_precision`` its scores at
  rtol 1e-12 and raise on a non-finite score as they do;
* ``merge_prediction_frames`` written by ``write_csv`` is byte-identical to
  the JAX merge written by pandas, and refuses a row mismatch;
* ``per_class_scores`` and ``metrics_summary.csv`` against JAX's at rtol
  1e-12, degenerate classes included (nan, empty cells);
* the ``render_*`` functions write the JAX package's files where matplotlib
  is present, and skip each figure with a line where it is missing;
* ``pick_demo_indices``, ``write_meta`` (byte-identical) and the
  ``ptb_test`` factories (datasets and first batch) against JAX's.
"""

import os
import warnings

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("sklearn")
pytest.importorskip("jax")
from sklearn import metrics as skm  # noqa: E402

from ptbxl_tpu.analysis import figures as jfig  # noqa: E402
from ptbxl_tpu.analysis.merge import merge_prediction_frames as jax_merge  # noqa: E402
from ptbxl_tpu.data import demo_export as jexport  # noqa: E402
from ptbxl_tpu.data import ptb_test as jptb_test  # noqa: E402

from ptbxl_torch.analysis import figures  # noqa: E402
from ptbxl_torch.analysis.merge import merge_prediction_frames  # noqa: E402
from ptbxl_torch.data import demo_export, ptb_test  # noqa: E402
from ptbxl_torch.training import metrics  # noqa: E402
from ptbxl_torch.utils.table import Table, read_csv, write_csv  # noqa: E402
from tests.torch_port_common import CLASSES, block_module, write_pred_csvs  # noqa: E402

RTOL = 1e-12  # the same rational numbers, summed in another order


def _binary_case(name, n=50):
    rng = np.random.default_rng(sum(map(ord, name)))
    y = (rng.uniform(size=n) < 0.4).astype(np.float64)
    s = rng.uniform(size=n)
    if name == "tied":  # a coarse grid: many ties
        s = np.round(s * 4) / 4
    elif name == "tied_float32":
        s = (np.round(s * 8) / 8).astype(np.float32)
    elif name == "float32":
        s = s.astype(np.float32)
    elif name == "constant":
        s = np.full(n, 0.3)
    elif name == "single_positive":
        y = np.zeros(n)
        y[n // 3] = 1.0
    elif name == "all_negative":
        y = np.zeros(n)
    elif name == "all_positive":
        y = np.ones(n)
    elif name == "two":
        y, s = np.array([0.0, 1.0]), np.array([0.2, 0.7])
    elif name == "perfect":
        s = np.where(y > 0, 0.9, 0.1)
    return y, s


CURVE_CASES = ["random", "tied", "tied_float32", "float32", "constant", "single_positive",
               "all_negative", "all_positive", "two", "perfect"]


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g, w)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", CURVE_CASES)
def test_curves_equal_sklearn(name):
    y, s = _binary_case(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _assert_same_arrays(metrics.roc_curve(y, s), skm.roc_curve(y, s))
        _assert_same_arrays(metrics.precision_recall_curve(y, s),
                            skm.precision_recall_curve(y, s))
        want_auc = skm.roc_auc_score(y, s)
        want_ap = skm.average_precision_score(y, s)
        got_auc, got_ap = metrics.roc_auc(y, s), metrics.average_precision(y, s)
    if np.isnan(want_auc):
        assert np.isnan(got_auc)
    else:
        np.testing.assert_allclose(got_auc, want_auc, rtol=RTOL)
    np.testing.assert_allclose(got_ap, want_ap, rtol=RTOL)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("fn", ["roc_auc", "average_precision", "roc_curve",
                                "precision_recall_curve"])
def test_per_label_helpers_raise_on_non_finite(fn, bad):
    """As scikit-learn's ``roc_auc_score`` etc. raise (and JAX's
    ``per_class_scores``, which does not catch it)."""
    y, s = _binary_case("random")
    s[7] = bad
    sk_fn = {"roc_auc": skm.roc_auc_score, "average_precision": skm.average_precision_score,
             "roc_curve": skm.roc_curve,
             "precision_recall_curve": skm.precision_recall_curve}[fn]
    with pytest.raises(ValueError, match="Input contains"):
        sk_fn(y, s)
    with pytest.raises(ValueError, match="Input contains"):
        getattr(metrics, fn)(y, s)


def test_per_class_scores_raise_on_non_finite_as_jax():
    y, p = _multilabel("random")
    p[3, 2] = np.nan
    with pytest.raises(ValueError, match="Input contains NaN"):
        jfig.per_class_scores(y, p)
    with pytest.raises(ValueError, match="Input contains NaN"):
        figures.per_class_scores(y, p)


# -- per-class scores, metrics_summary.csv ---------------------------------------------

def _multilabel(name, n=60):
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    y = (rng.uniform(size=(n, 5)) < 0.35).astype(np.float64)
    p = rng.uniform(size=(n, 5))
    if name == "tied":
        p = np.round(p * 5) / 5
    elif name == "degenerate":  # one all-negative and one all-positive class
        y[:, 1], y[:, 3] = 0.0, 1.0
    elif name == "all_degenerate":  # every class single-valued: nan macros
        y[:] = 0.0
    return y, p


@pytest.mark.parametrize("name", ["random", "tied", "degenerate", "all_degenerate"])
def test_per_class_scores_match_jax(name):
    y, p = _multilabel(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's nanmean over all-nan classes warns
        want = jfig.per_class_scores(y, p)
    got = figures.per_class_scores(y, p)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(want[k], float),
                                   rtol=RTOL, equal_nan=True, err_msg=k)


def test_per_class_scores_all_degenerate_warns_nothing():
    y, p = _multilabel("all_degenerate")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = figures.per_class_scores(y, p)
    assert np.isnan(got["auroc_macro"]) and np.isnan(got["auprc_macro"])


def test_metrics_summary_matches_jax(tmp_path):
    y, p = _multilabel("degenerate")
    _, q = _multilabel("tied")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = {"ecg": jfig.per_class_scores(y, p), "mm": jfig.per_class_scores(y, q)}
    jfig.write_metrics_summary(jm, CLASSES, tmp_path / "jax.csv")
    pm = {"ecg": figures.per_class_scores(y, p), "mm": figures.per_class_scores(y, q)}
    figures.write_metrics_summary(pm, CLASSES, tmp_path / "port.csv")
    want, got = pd.read_csv(tmp_path / "jax.csv"), pd.read_csv(tmp_path / "port.csv")
    assert list(got.columns) == list(want.columns)
    assert list(got.columns)[:3] == ["model", "auroc_macro", "auprc_macro"]
    assert list(got["model"]) == list(want["model"]) == ["ecg", "mm"]
    num = list(want.columns[1:])
    np.testing.assert_allclose(got[num].values, want[num].values, rtol=RTOL, equal_nan=True)
    # the degenerate classes' empty cells sit where JAX's are
    jrows = (tmp_path / "jax.csv").read_text().splitlines()
    prows = (tmp_path / "port.csv").read_text().splitlines()
    assert [[c == "" for c in r.split(",")] for r in prows] == \
        [[c == "" for c in r.split(",")] for r in jrows]
    assert sum(c == "" for c in prows[1].split(",")) == 4


# -- merging ---------------------------------------------------------------------------

def test_merge_byte_identical_to_jax(tmp_path):
    paths = write_pred_csvs(str(tmp_path))
    jax_merge(*[pd.read_csv(p) for p in paths]).to_csv(tmp_path / "jax.csv", index=False)
    merged = merge_prediction_frames(*[read_csv(p) for p in paths])
    write_csv(str(tmp_path / "port.csv"), {c: merged[c] for c in merged.columns})
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert len(merged.columns) == 15 + 10 + 3
    assert [c for c in merged.columns if c.startswith("y_true_")] == \
        [f"y_true_{c}" for c in CLASSES] + ["y_true_AF"]


def test_merge_rejects_row_mismatch(tmp_path):
    base, mm, af = [read_csv(p) for p in write_pred_csvs(str(tmp_path))]
    with pytest.raises(ValueError, match="Row count mismatch: baseline=12, multimodal=11, AF=12"):
        merge_prediction_frames(base, mm.take(range(11)), af)
    with pytest.raises(ValueError, match="Row count mismatch"):
        jax_merge(pd.DataFrame(base.row(0), index=[0]), pd.DataFrame(), pd.DataFrame())


# -- figures ---------------------------------------------------------------------------

def _merged(tmp_path, n=40):
    paths = write_pred_csvs(str(tmp_path), n=n, seed=3)
    merged = merge_prediction_frames(*[read_csv(p) for p in paths])
    path = str(tmp_path / "merged.csv")
    write_csv(path, {c: merged[c] for c in merged.columns})
    return path


RENDERS = {
    "summary": ("render_summary_figures", {}),
    "distributions": ("render_distribution_figures", {}),
    "baseline_only": ("render_single_model_figures", {}),
    "mm_only": ("render_single_model_figures", {
        "suffix": "_mm", "file_names": {"roc": "mm_m1_per_class_roc.png",
                                        "pr": "mm_m2_per_class_pr.png",
                                        "mi": "mm_m3_mi_distribution.png"}}),
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_writes_jax_files(name, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    pytest.importorskip("seaborn")
    fn, kw = RENDERS[name]
    path = _merged(tmp_path)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()  # the CLIs make their out dir
    getattr(jfig, fn)(pd.read_csv(path), tmp_path / "jax", **kw)
    jax_text = capsys.readouterr().out
    drawn = getattr(figures, fn)(read_csv(path), tmp_path / "port", **kw)
    port_text = capsys.readouterr().out
    want = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == want
    assert all(drawn.values()) and sorted(drawn) == [f for f in want if f.endswith(".png")]
    for f in want:
        assert os.path.getsize(tmp_path / "port" / f) > 0
    assert port_text == jax_text.replace(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("blocked", ["matplotlib", "seaborn"])
def test_render_skips_figures_without_matplotlib(blocked, tmp_path, monkeypatch, capsys):
    block_module(monkeypatch, blocked)
    t = read_csv(_merged(tmp_path))
    out = tmp_path / "figs"
    out.mkdir()
    drawn = {}
    for fn, kw in RENDERS.values():
        drawn.update(getattr(figures, fn)(t, str(out), **kw))
    text = capsys.readouterr().out
    assert len(drawn) == 13
    kde = {f for f in drawn if "distribution" in f}
    skipped = set(drawn) if blocked == "matplotlib" else kde
    assert {f for f, ok in drawn.items() if not ok} == skipped
    assert sorted(os.listdir(out)) == sorted({"metrics_summary.csv"} | set(drawn) - skipped)
    for f in skipped:
        assert text.count(f"[INFO] {blocked} is not installed; skipped the figure "
                          f"{os.path.join(str(out), f)}\n") == 1, f


# -- demo pack, test loaders -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("extra", [0, 1, 3])
def test_pick_demo_indices_match_jax(seed, extra):
    y = (np.random.default_rng(seed).uniform(size=(80, 5)) > 0.8).astype(np.float32)
    y[5] = 1.0  # one index positive in every class: chosen once
    for per_class in (1, 2):
        assert demo_export.pick_demo_indices(y, per_class, extra, seed) == \
            jexport.pick_demo_indices(y, per_class, extra, seed)


def test_write_meta_byte_identical_to_jax(tmp_path):
    rows = [{"file": "single/single_sample_00.npz", "modality": "single", "index_in_split": 3,
             "chosen_for": "pos_MI", "y_true": "MI=1;STTC=0;HYP=0;CD=0;NORM=0", "y_sum": 1,
             "ecg_shape": "(12, 5000)"},
            {"file": "multimodal/mm_sample_00.npz", "modality": "multimodal",
             "index_in_split": 0, "chosen_for": "all_zero",
             "y_true": "MI=0;STTC=0;HYP=0;CD=0;NORM=0", "y_sum": 0, "ecg_shape": "(12, 5000)",
             "demo_shape": "(5,)"}]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jexport.write_meta(rows, str(tmp_path / "jax"))
    demo_export.write_meta(rows, str(tmp_path / "port"))
    text = (tmp_path / "port" / "meta.csv").read_bytes()
    assert text == (tmp_path / "jax" / "meta.csv").read_bytes()
    assert b',"(12, 5000)",\n' in text  # the single row's demo_shape is an empty cell


def _cfg(ptbxl_dir):
    return {"data": {"base_dir": ptbxl_dir, "labels": CLASSES, "normalize": "per_lead"},
            "train": {"batch_size": 3}}


@pytest.mark.parametrize("kind", ["baseline", "multimodal", "af"])
def test_ptb_test_factories_match_jax(kind, ptbxl_dir):
    name = f"make_{kind}_test_loader"
    ds, src = getattr(ptb_test, name)(_cfg(ptbxl_dir))
    jds, jsrc = getattr(jptb_test, name)(_cfg(ptbxl_dir))
    assert type(ds).__name__ == type(jds).__name__ and ds.split == "test"
    assert len(ds) == len(jds) and src.batch_size == jsrc.batch_size == 3
    assert src.shuffle is False and jsrc.shuffle is False
    np.testing.assert_array_equal(ds.y, jds.y)
    got, want = next(src.epoch(0)), next(jsrc.epoch(0))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_table_round_trip_keeps_text(tmp_path):
    """The merge CLI reads cells as numbers and writes them back: each cell's text stays."""
    path = write_pred_csvs(str(tmp_path))[0]
    t = read_csv(path)
    write_csv(str(tmp_path / "again.csv"), {c: t[c] for c in t.columns})
    assert (tmp_path / "again.csv").read_bytes() == open(path, "rb").read()
    assert isinstance(t, Table) and len(t) == 12
