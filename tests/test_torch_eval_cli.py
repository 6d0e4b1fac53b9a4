"""The port's eval-path CLIs (ptbxl_torch/cli/: 00 pack and save, 02, 09, 10,
11, 13, 14-17, printsize) and the demo CLI in-process, against the JAX
package's library functions on the same inputs, on the CPU.

* 09 writes the bytes that JAX's merge written by pandas writes, and refuses a
  row mismatch; 10 prints JAX ``compute_metrics`` of the merged columns in
  alphabetical label order (rtol 1e-12);
* 14-17 write the files JAX's ``render_*`` write as the scripts call them,
  and only ``metrics_summary.csv`` with a skip line a figure where
  matplotlib is missing;
* 11 and 13 write a CAM within 2e-3 of JAX's ``GradCAM`` with the scripts'
  settings, 11 its ``info.txt`` line for line;
* 00: the chosen indices equal, ``meta.csv`` byte-identical, the ``.npz`` and
  ``.npy`` arrays within 1e-6 (tests/test_torch_data_layer.py's tolerance);
* 02's and printsize's counts equal pandas' and JAX's datasets';
* the demo CLI with matplotlib blocked prints the probabilities and ends.
"""

import os
import re

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.analysis import figures as jfig  # noqa: E402
from ptbxl_tpu.analysis.merge import merge_prediction_frames as jax_merge  # noqa: E402
from ptbxl_tpu.data import PTBXLAFDataset as JAF  # noqa: E402
from ptbxl_tpu.data import PTBXLDataset as JDS  # noqa: E402
from ptbxl_tpu.data import PTBXLECGMultimodalDataset as JMM  # noqa: E402
from ptbxl_tpu.data import demo_export as jexport  # noqa: E402
from ptbxl_tpu.interpret.grad_cam import GradCAM as JGradCAM  # noqa: E402
from ptbxl_tpu.models.factory import load_ecgcnn as jax_load_ecgcnn  # noqa: E402
from ptbxl_tpu.training.metrics import compute_metrics as jax_metrics  # noqa: E402
from ptbxl_tpu.utils.label_maps import load_metadata as jax_load_metadata  # noqa: E402

from ptbxl_torch import demo_inference  # noqa: E402
from ptbxl_torch.cli import (  # noqa: E402
    analyse_merged_test,
    grad_cam_af,
    grad_cam_ecg_baseline,
    make_demo_pack,
    merge_all_test,
    plot_baseline_only,
    plot_distributions,
    plot_mm_only,
    plot_results,
    prepare_data,
    printsize,
    save_demo_ecg,
    save_demo_multimodal,
)
from tests.torch_port_common import (  # noqa: E402
    CKPT,
    CKPT_AF,
    CLASSES,
    HERE,
    block_module,
    golden,
    write_pred_csvs,
)

CAM_TOL = 2e-3  # CAMs amplify conv rounding through min-max normalization
ARRAY_TOL = 1e-6
ALPHABETICAL = ["CD", "HYP", "MI", "NORM", "STTC"]


def _cfg(path, ptbxl_dir):
    path.write_text(f"""seed: 42
data:
  base_dir: {ptbxl_dir}
  normalize: per_lead
  labels: ["MI", "STTC", "HYP", "CD", "NORM"]
train:
  batch_size: 8
""")
    return str(path)


def _merge_argv(paths, out_csv):
    return ["--baseline_csv", paths[0], "--multimodal_csv", paths[1], "--af_csv", paths[2],
            "--out_csv", out_csv]


@pytest.fixture
def merged_csv(tmp_path):
    """A merged CSV written by CLI 09 from three eval-CLI-shaped CSVs of 40 rows."""
    paths = write_pred_csvs(str(tmp_path), n=40, seed=5)
    out = str(tmp_path / "merged" / "merged.csv")
    merge_all_test.main(_merge_argv(paths, out))
    return out


# -- 09, 10 ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(12, 0), (40, 5)])
def test_merge_cli_byte_identical_to_jax(n, seed, tmp_path, capsys):
    paths = write_pred_csvs(str(tmp_path), n=n, seed=seed)
    out = str(tmp_path / "out" / "merged.csv")
    merged = merge_all_test.main(_merge_argv(paths, out))
    text = capsys.readouterr().out
    jax_merge(*[pd.read_csv(p) for p in paths]).to_csv(tmp_path / "jax.csv", index=False)
    with open(out, "rb") as f:
        assert f.read() == (tmp_path / "jax.csv").read_bytes()
    assert f"[INFO] merged shape: ({n}, 28)\n" in text
    assert "[INFO] Saved merged CSV to: " + out in text
    assert len(merged) == n


def test_merge_cli_rejects_row_mismatch(tmp_path):
    paths = write_pred_csvs(str(tmp_path))
    (tmp_path / "short").mkdir()
    short = write_pred_csvs(str(tmp_path / "short"), n=11, seed=1)[1]
    with pytest.raises(ValueError, match="Row count mismatch: baseline=12, multimodal=11, AF=12"):
        merge_all_test.main(_merge_argv([paths[0], short, paths[2]],
                                        str(tmp_path / "m.csv")))
    assert not os.path.exists(tmp_path / "m.csv")


def _printed_metrics(text):
    """{header: {metric: float}} from CLI 10's output."""
    out, header = {}, None
    for line in text.splitlines():
        if line.startswith("[") and line.endswith("metrics:"):
            header = line
            out[header] = {}
        elif header and re.match(r"^  \w+: ", line):
            k, v = line.strip().split(": ")
            out[header][k] = float(v)
    return out


@pytest.mark.parametrize("columns", ["all", "baseline_only"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_analyse_cli_prints_jax_metrics(columns, threshold, merged_csv, tmp_path, capsys):
    path = merged_csv
    df = pd.read_csv(path)
    if columns == "baseline_only":  # both [WARN] branches
        df = df[[c for c in df.columns if not c.endswith("_mm") and "AF" not in c]]
        path = str(tmp_path / "base_only.csv")
        df.to_csv(path, index=False)
    capsys.readouterr()
    analyse_merged_test.main(["--merged_csv", path, "--threshold", str(threshold)])
    text = capsys.readouterr().out
    assert "[INFO] ECG labels: ['CD', 'HYP', 'MI', 'NORM', 'STTC']" in text
    got = _printed_metrics(text)
    truth = df[[f"y_true_{lb}" for lb in ALPHABETICAL]].values.astype(np.float32)
    want = {"[Baseline ECG][TEST] metrics:": jax_metrics(
        truth, df[[f"y_prob_{lb}" for lb in ALPHABETICAL]].values.astype(np.float32),
        threshold=threshold)}
    if columns == "all":
        want["[ECG + demographics][TEST] metrics:"] = jax_metrics(
            truth, df[[f"y_prob_{lb}_mm" for lb in ALPHABETICAL]].values.astype(np.float32),
            threshold=threshold)
        want["[AF binary][TEST] metrics:"] = jax_metrics(
            df["y_true_AF"].values.astype(np.float32).reshape(-1, 1),
            df["y_prob_AF"].values.astype(np.float32).reshape(-1, 1), threshold=threshold)
    else:
        assert "[WARN] Multimodal columns not found; skip ECG+demographics metrics." in text
        assert "[WARN] AF columns not found in merged CSV." in text
    assert list(got) == list(want)
    for header, metrics in want.items():
        assert list(got[header]) == list(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(got[header][k], v, rtol=1e-12, err_msg=f"{header} {k}")


# -- 14-17 -----------------------------------------------------------------------------

_MM_NAMES = {"roc": "mm_m1_per_class_roc.png", "pr": "mm_m2_per_class_pr.png",
             "mi": "mm_m3_mi_distribution.png"}
PLOT_CLIS = {  # port CLI, the JAX renderer and its arguments as scripts 14-17 call it
    "plot_results": (plot_results, "render_summary_figures", {}),
    "plot_distributions": (plot_distributions, "render_distribution_figures", {}),
    "plot_baseline_only": (plot_baseline_only, "render_single_model_figures", {}),
    "plot_mm_only": (plot_mm_only, "render_single_model_figures",
                     {"suffix": "_mm", "color": jfig.ORANGE, "file_names": _MM_NAMES,
                      "mi_labels": ("MI = 1", "MI = 0")}),
}


@pytest.mark.parametrize("name", sorted(PLOT_CLIS))
def test_plot_cli_writes_jax_files(name, merged_csv, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    pytest.importorskip("seaborn")
    cli, render, kw = PLOT_CLIS[name]
    (tmp_path / "jax").mkdir()
    getattr(jfig, render)(pd.read_csv(merged_csv), tmp_path / "jax", **kw)
    drawn = cli.main(["--merged_csv", merged_csv, "--out_dir", str(tmp_path / "port")])
    want = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == want
    assert all(drawn.values()) and sorted(drawn) == [f for f in want if f.endswith(".png")]
    if name == "plot_results":
        got = pd.read_csv(tmp_path / "port" / "metrics_summary.csv")
        ref = pd.read_csv(tmp_path / "jax" / "metrics_summary.csv")
        assert list(got.columns) == list(ref.columns) and list(got["model"]) == ["ecg", "mm"]
        np.testing.assert_allclose(got.values[:, 1:].astype(float),
                                   ref.values[:, 1:].astype(float), rtol=1e-12)


@pytest.mark.parametrize("name", sorted(PLOT_CLIS))
def test_plot_cli_skips_figures_without_matplotlib(name, merged_csv, tmp_path, monkeypatch,
                                                   capsys):
    block_module(monkeypatch, "matplotlib")
    out = tmp_path / "figs"
    drawn = PLOT_CLIS[name][0].main(["--merged_csv", merged_csv, "--out_dir", str(out)])
    text = capsys.readouterr().out
    assert drawn and not any(drawn.values())
    want = ["metrics_summary.csv"] if name == "plot_results" else []
    assert sorted(os.listdir(out)) == want
    for f in drawn:
        line = f"[INFO] matplotlib is not installed; skipped the figure {out / f}\n"
        assert text.count(line) == 1, f


# -- 11, 13 ----------------------------------------------------------------------------

@pytest.mark.parametrize("class_name", [None, "NORM"])
def test_grad_cam_baseline_cli_matches_jax(class_name, ptbxl_dir, tmp_path, monkeypatch,
                                           capsys):
    cfg = _cfg(tmp_path / "c.yaml", ptbxl_dir)
    monkeypatch.chdir(tmp_path)
    argv = ["--config", cfg, "--ckpt", CKPT, "--index", "1", "--class_idx", "2",
            "--device", "cpu"] + (["--class_name", class_name] if class_name else [])
    cam_path, info_path, plot_path = grad_cam_ecg_baseline.main(argv)
    name = class_name or "HYP"
    k = CLASSES.index(name)
    assert cam_path == f"outputs/gradcam/sample_1_{name}_cam.npy"
    assert plot_path == f"outputs/gradcam/sample_1_{name}_plot.png"
    assert os.path.getsize(plot_path) > 0
    text = capsys.readouterr().out
    assert f"[INFO] Running Grad-CAM on sample 1, class {name}" in text
    x, _ = JDS(ptbxl_dir, "test", CLASSES)[1]
    model, variables, _ = jax_load_ecgcnn(CKPT, num_labels=5, strict=False)
    _, want = JGradCAM(model, variables, signal_length=x.shape[-1], norm_first=True)(
        jnp.asarray(x.T[None]), class_idx=k)
    cam = np.load(cam_path)
    assert cam.shape == (x.shape[-1],)
    np.testing.assert_allclose(cam, np.asarray(want)[0], atol=CAM_TOL, rtol=0)
    with open(info_path) as f:
        assert f.read() == (f"Sample index: 1\nClass: {name}\nClass idx: {k}\n"
                            f"ECG shape: (12, {x.shape[-1]})\nCAM shape: ({x.shape[-1]},)\n")


def test_grad_cam_af_cli_matches_jax(ptbxl_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    npy_path, fig_path = grad_cam_af.main(["--base_dir", ptbxl_dir, "--ckpt", CKPT_AF,
                                           "--index", "1", "--device", "cpu"])
    assert npy_path == "outputs/gradcam_af/sample_1_AF_cam.npy"
    assert fig_path == "outputs/gradcam_af/sample_1_AF_plot.png" and os.path.getsize(fig_path)
    x, y = JAF(ptbxl_dir, "test")[1]
    assert f"[INFO] Running AF Grad-CAM on sample 1 (y={float(y[0])})" in capsys.readouterr().out
    model, variables, _ = jax_load_ecgcnn(CKPT_AF, num_labels=1, strict=True)
    _, want = JGradCAM(model, variables, signal_length=x.shape[-1], norm_first=False,
                       eps=1e-9)(jnp.asarray(x.T[None]), class_idx=0)
    np.testing.assert_allclose(np.load(npy_path), np.asarray(want)[0], atol=CAM_TOL, rtol=0)


@pytest.mark.parametrize("cli", ["grad_cam_ecg_baseline", "grad_cam_af"])
def test_grad_cam_clis_without_matplotlib(cli, ptbxl_dir, tmp_path, monkeypatch, capsys):
    """No PNG and one skip line; the CAM (and 11's info.txt) are still written."""
    block_module(monkeypatch, "matplotlib")
    monkeypatch.chdir(tmp_path)
    if cli == "grad_cam_af":
        paths = grad_cam_af.main(["--base_dir", ptbxl_dir, "--ckpt", CKPT_AF, "--index", "0",
                                  "--device", "cpu"])
    else:
        paths = grad_cam_ecg_baseline.main(["--config", _cfg(tmp_path / "c.yaml", ptbxl_dir),
                                            "--ckpt", CKPT, "--device", "cpu"])
    assert paths[-1] is None and all(os.path.getsize(p) > 0 for p in paths[:-1])
    text = capsys.readouterr().out
    assert text.count("[INFO] matplotlib is not installed; skipped the figure outputs/") == 1
    assert not [f for _, _, fs in os.walk(tmp_path / "outputs") for f in fs
                if f.endswith(".png")]


@pytest.mark.parametrize("cli", ["grad_cam_ecg_baseline", "grad_cam_af"])
def test_grad_cam_clis_default_to_the_gpu(cli, ptbxl_dir, tmp_path, monkeypatch):
    """Without --device they ask for cuda, and raise on a machine without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = (["--base_dir", ptbxl_dir, "--ckpt", CKPT_AF] if cli == "grad_cam_af"
            else ["--config", _cfg(tmp_path / "c.yaml", ptbxl_dir), "--ckpt", CKPT])
    mod = grad_cam_af if cli == "grad_cam_af" else grad_cam_ecg_baseline
    with pytest.raises(RuntimeError, match="CUDA GPU by default"):
        mod.main(argv)
    assert not os.path.exists(tmp_path / "outputs")


# -- 00: demo pack and raw samples -----------------------------------------------------

def _jax_pack(ptbxl_dir, out_root, per_class, extra, seed=42):
    """scripts/00_make_demo_pack.py's main, through the JAX library."""
    ds_single = JDS(ptbxl_dir, split="test", classes=jexport.CLASSES, normalize="per_lead")
    ds_mm = JMM(ptbxl_dir, split="test", classes=jexport.CLASSES, normalize="per_lead")
    idx_single, why_single = jexport.pick_demo_indices(ds_single.y, per_class, extra, seed)
    idx_mm, why_mm = jexport.pick_demo_indices(ds_mm.y, per_class, extra, seed)
    rows = []
    jexport.export_npz_samples(ds_single, os.path.join(out_root, "single"), idx_single,
                               why_single, rows, prefix="single", multimodal=False)
    jexport.export_npz_samples(ds_mm, os.path.join(out_root, "multimodal"), idx_mm, why_mm,
                               rows, prefix="mm", multimodal=True)
    jexport.write_meta(rows, out_root)
    return idx_single, idx_mm


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("per_class,extra", [(1, 2), (2, 0)])
def test_make_demo_pack_matches_jax(per_class, extra, ptbxl_dir, tmp_path, capsys):
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    idx_single, idx_mm, meta = make_demo_pack.main([
        "--base_dir", ptbxl_dir, "--out_root", str(port_root), "--per_class", str(per_class),
        "--extra_all_zero", str(extra)])
    assert (idx_single, idx_mm) == _jax_pack(ptbxl_dir, str(jax_root), per_class, extra)
    assert idx_single and idx_mm
    assert "[DONE] Demo pack created." in capsys.readouterr().out
    assert open(meta, "rb").read() == (jax_root / "meta.csv").read_bytes()
    assert _files(port_root) == _files(jax_root)
    for f in _files(jax_root):
        if not f.endswith(".npz"):
            continue
        got, want = np.load(port_root / f), np.load(jax_root / f)
        assert got.files == want.files
        for k in want.files:
            if want[k].dtype.kind == "U":
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_allclose(got[k], want[k], atol=ARRAY_TOL, rtol=0,
                                           err_msg=f"{f}:{k}")


@pytest.mark.parametrize("multimodal", [False, True])
def test_save_demo_samples_match_jax(multimodal, ptbxl_dir, tmp_path, capsys):
    cli = save_demo_multimodal if multimodal else save_demo_ecg
    cli.main(["--base_dir", ptbxl_dir, "--out_dir", str(tmp_path / "port"),
              "--num_samples", "2"])
    done = ("[DONE] Multimodal demo samples exported." if multimodal
            else "[DONE] All demo ECG saved.")
    assert done in capsys.readouterr().out
    ds = (JMM if multimodal else JDS)(ptbxl_dir, split="test", classes=CLASSES,
                                      normalize="per_lead")
    jexport.export_npy_samples(ds, str(tmp_path / "jax"), 2, multimodal=multimodal)
    files = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == files and len(files) == (4 if multimodal else 2)
    for f in files:
        got, want = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ARRAY_TOL, rtol=0, err_msg=f)


# -- 02, printsize ---------------------------------------------------------------------

def test_prepare_data_counts_match_pandas(ptbxl_dir, capsys):
    got = prepare_data.main(["--base_dir", ptbxl_dir])
    text = capsys.readouterr().out
    df, scp = jax_load_metadata(ptbxl_dir)
    assert got["rows"] == len(df) and got["scp_rows"] == len(scp)
    folds = df["strat_fold"].value_counts().sort_index()
    assert got["strat_fold"] == {int(k): int(v) for k, v in folds.items()}
    assert list(got["strat_fold"]) == sorted(got["strat_fold"])
    classes = scp["diagnostic_class"].value_counts()
    assert got["diagnostic_class"] == {str(k): int(v) for k, v in classes.items()}
    assert list(got["diagnostic_class"].values()) == sorted(classes.values, reverse=True)
    assert f"Loaded ptbxl_database.csv: {len(df)} rows" in text
    assert "Columns: " + str(list(df.columns)) in text
    for fold, n in got["strat_fold"].items():
        assert f"  {fold}: {n}\n" in text


def test_printsize_matches_jax_datasets(ptbxl_dir, capsys):
    got = printsize.main(["--base_dir", ptbxl_dir])
    text = capsys.readouterr().out
    for kind, cls in (("baseline", JDS), ("multimodal", JMM)):
        for split in ("train", "val", "test"):
            assert got[kind][split] == len(cls(base_dir=ptbxl_dir, split=split,
                                               classes=CLASSES)), (kind, split)
    assert f"Baseline test size:  {got['baseline']['test']}\n" in text
    assert f"ECG+Demo train size: {got['multimodal']['train']}\n" in text


# -- the demo CLI ----------------------------------------------------------------------

def test_demo_cli_without_matplotlib(tmp_path, monkeypatch, capsys):
    """It prints the probabilities, skips the PNG with a line and returns normally."""
    block_module(monkeypatch, "matplotlib")
    probs, path = demo_inference.main(demo_inference.parse_args([
        "--demo_path", os.path.join(HERE, "data/demo/single/single_sample_00.npz"),
        "--ckpt", CKPT, "--out_dir", str(tmp_path), "--device", "cpu"]))
    text = capsys.readouterr().out
    assert path is None and os.listdir(tmp_path) == []
    png = tmp_path / "single_sample_00_gradcam_MI.png"
    assert f"[INFO] matplotlib is not installed; skipped the figure {png}\n" in text
    p_mi = golden("baseline")["probs"][0, 0]
    assert f"MI: {p_mi:.3f}" in text and abs(float(probs[0]) - p_mi) < 5e-4
    assert text.index("[INFO] Predicted probabilities:") < text.index("skipped the figure")
