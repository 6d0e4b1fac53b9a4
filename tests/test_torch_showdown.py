"""The port's training showdown (ptbxl_torch/tools/showdown.py) against the
JAX tool (tools/showdown.py).

The dataset and demographics bit for bit; the comparison's mechanics on
fabricated artifacts (the gate, the seed means and their Welch escape, the
effective-seed dedup, the null fields of older artifacts, the committed
artifacts' families, several JAX directories read as one); and the slice
itself: ``run_jax`` and ``run_port`` from JAX's own init on a tiny config,
epoch by epoch.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from ptbxl_tpu.models import factory as jax_factory
from ptbxl_torch.models import factory as port_factory
from ptbxl_torch.models.params_io import from_flax_variables
from ptbxl_torch.tools import showdown as sd

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS_DIR = os.path.join(HERE, "outputs", "showdown_seeds")
TINY = {"n_train": 24, "n_val": 16, "n_test": 16, "T": 256, "seed": 0,
        "batch_size": 8, "epochs": 2, "lr": 1.5e-3, "weight_decay": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The runs here are tiny: one intra-op thread keeps them from thrashing
    when the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_sd():
    spec = importlib.util.spec_from_file_location(
        "jax_showdown", os.path.join(HERE, "tools", "showdown.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- (a) the dataset

@pytest.mark.parametrize("kw", [{}, {"hard": True}, {"hard": True, "label_flip": 0.5},
                                {"T": 5000}], ids=["standard", "hard", "hard_flip", "T5000"])
def test_make_split_equals_the_jax_tools(jax_sd, kw):
    kw = dict({"T": 256}, **kw)
    x, y = sd.make_split(6, seed=7, **kw)
    xj, yj = jax_sd.make_split(6, seed=7, **kw)
    assert x.dtype == xj.dtype == np.float32 and x.shape == (6, 12, kw["T"])
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(sd.zscore(x), jax_sd.zscore(xj))
    if "label_flip" not in kw:  # NORM is the absence of the other four
        assert all((r[4] == 1.0) == (r[:4].sum() == 0) for r in y)


def test_synth_demo_split_equals_the_jax_tools(jax_sd):
    y = (np.random.default_rng(0).uniform(size=(400, 5)) < 0.4).astype(np.float32)
    d = sd.synth_demo_split(y, seed=3)
    np.testing.assert_array_equal(d, jax_sd.synth_demo_split(y, seed=3))
    assert d.shape == (400, 5) and d.dtype == np.float32
    hyp = y[:, 2].astype(bool)  # age rises with HYP
    assert d[hyp, 0].mean() > d[~hyp, 0].mean() + 0.05


@pytest.mark.parametrize("hard", [False, True])
def test_dataset_file_equals_the_jax_tools(jax_sd, tmp_path, monkeypatch, hard):
    cfg = dict(TINY, hard=hard)
    monkeypatch.setattr(jax_sd, "OUT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(sd, "OUT_DIR", str(tmp_path / "port"))
    a, b = np.load(sd.ensure_dataset(cfg)), np.load(jax_sd.ensure_dataset(cfg))
    assert os.path.basename(sd.dataset_path(cfg)) == os.path.basename(jax_sd.dataset_path(cfg))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- (b) the mechanics

def test_arch_labels_af_single_logit(jax_sd):
    y = np.arange(10, dtype=np.float32).reshape(2, 5)
    ya = sd.arch_labels(y, "af")
    assert ya.shape == (2, 1)
    np.testing.assert_array_equal(ya, jax_sd.arch_labels(y, "af"))
    assert sd.arch_labels(y, "baseline") is y


def _artifact(directory, name, auroc, train_seed=None, **metrics):
    cfg = dict(TINY, train_seed=train_seed, arch="baseline", hard=False,
               jax_torch_init=False)
    blob = {"framework": name.split("_")[0], "config": cfg, "curves": [], "best_epoch": 0,
            "test_auroc_macro": auroc, "test_auprc_macro": metrics.get("auprc", auroc),
            "test_f1_macro": metrics.get("f1", auroc), "wall_s": 1.0,
            "device": {"name": "cpu", "power_limit": None}}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"{name}.json"), "w") as f:
        json.dump(blob, f)


def test_compare_deficit_gating(tmp_path, monkeypatch):
    """The budget bounds the port's deficit: the port above JAX passes at any
    gap, behind by more than the budget it fails; with several paired seeds the
    means decide."""
    out, jd = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setattr(sd, "OUT_DIR", str(out))
    _artifact(jd, "jax", 0.80)
    _artifact(out, "port", 0.90)
    rep = sd.compare(TINY, jax_dirs=[str(jd)])
    assert rep["within_budget"] and rep["deficit_vs_jax"] == 0.0
    assert "wall_s" not in rep["jax"] and rep["port"]["wall_s"] == 1.0
    assert json.load(open(out / "report_port.json"))["within_budget"]

    _artifact(out, "port", 0.79)  # behind beyond the budget
    rep = sd.compare(TINY, jax_dirs=[str(jd)])
    assert not rep["within_budget"] and not rep["within_budget_per_metric"]["auroc"]
    assert rep["metrics"]["auroc"]["deficit_vs_jax"] == pytest.approx(0.01)

    _artifact(jd, "jax_ts43", 0.80, train_seed=43)  # means: the second seed pulls back
    _artifact(out, "port_ts43", 0.84, train_seed=43)
    rep = sd.compare(TINY, jax_dirs=[str(jd)])
    assert rep["within_budget"] and rep["metrics"]["auroc"]["n"] == 2
    assert rep["metrics"]["auroc"]["deficit_vs_jax_means"] == 0.0


def test_compare_welch_escape(tmp_path, monkeypatch):
    """A mean deficit over budget that the seeds' spread explains (t < 2) is
    marked insignificant and passes; a tight one fails."""
    out, jd = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setattr(sd, "OUT_DIR", str(out))
    jf1, pf1 = [0.40, 0.70, 0.20], [0.10, 0.60, 0.30]  # F1 mean deficit 0.15, wide spread
    for i, ts in enumerate((None, 43, 44)):
        suffix = "" if ts is None else f"_ts{ts}"
        _artifact(jd, f"jax{suffix}", 0.9, ts, f1=jf1[i] + 0.05)
        _artifact(out, f"port{suffix}", 0.9, ts, f1=pf1[i])
    rep = sd.compare(TINY, jax_dirs=[str(jd)])
    f1 = rep["metrics"]["f1"]
    assert f1["deficit_vs_jax_means"] > f1["budget"]
    assert f1["insignificant_deficit"] and 0 < f1["welch_t"] < 2 and rep["within_budget"]
    for i, ts in enumerate((None, 43, 44)):  # the same deficit with no spread: fails
        suffix = "" if ts is None else f"_ts{ts}"
        _artifact(jd, f"jax{suffix}", 0.9, ts, f1=0.5 + 0.001 * i)
        _artifact(out, f"port{suffix}", 0.9, ts, f1=0.3 - 0.001 * i)
    rep = sd.compare(TINY, jax_dirs=[str(jd)])
    assert not rep["within_budget"] and rep["metrics"]["f1"]["welch_t"] > 2


def test_collect_seed_runs_dedups_effective_seed(tmp_path):
    """A base artifact (effective seed = seed) and an explicit _tsN one with the
    same number are one seed; the explicitly tagged artifact wins."""
    cfg = dict(TINY, seed=42)
    for name, auroc, ts in (("jax", 0.80, None), ("jax_ts42", 0.90, 42),
                            ("jax_ts43", 0.85, 43)):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump({"config": dict(cfg, train_seed=ts), "test_auroc_macro": auroc,
                       "test_auprc_macro": auroc, "test_f1_macro": auroc}, f)
    runs = sd._collect_seed_runs("jax", "", False, [str(tmp_path)])
    assert set(runs) == {"_ts42", "_ts43"}
    assert runs["_ts42"]["file"] == "jax_ts42.json"


def test_null_fields_of_old_artifacts(tmp_path, monkeypatch):
    """arch / hard / jax_torch_init stored as null read as baseline / False /
    False: the name, the family and the comparison."""
    old = dict(TINY, arch=None, hard=None, jax_torch_init=None, train_seed=None)
    cfg = sd.normalize_config(old)
    assert (cfg["arch"], cfg["hard"], cfg["jax_torch_init"]) == ("baseline", False, False)
    assert sd._tag(old) == "" and sd.family_of(old) == ""
    assert sd._tag(dict(old, hard=True, train_seed=43, jax_torch_init=True)) == "_hard_ts43_ti"
    assert sd._config_mismatch(old, cfg) == {}
    jd, out = tmp_path / "jax", tmp_path / "port"
    os.makedirs(jd)
    with open(jd / "jax.json", "w") as f:
        json.dump({"config": old, "test_auroc_macro": 0.9, "test_auprc_macro": 0.9,
                   "test_f1_macro": 0.9, "best_epoch": 1, "wall_s": 5.0}, f)
    assert sd.jax_config(str(jd / "jax.json")) == cfg
    monkeypatch.setattr(sd, "OUT_DIR", str(out))
    _artifact(out, "port", 0.9)
    rep = sd.compare(old, jax_dirs=[str(jd)])
    assert rep["within_budget"] and "config_mismatch" not in rep


def test_committed_jax_artifacts_form_eight_families():
    """outputs/showdown: 32 JAX artifacts in 8 families, each named as its
    stored config says, the base artifact first."""
    fams = sd.jax_families()
    assert sorted(fams) == ["", "_af", "_af_hard", "_hard", "_hard_ti", "_mm",
                            "_mm_hard", "_mm_hard_ti"]
    assert sum(len(v) for v in fams.values()) == 32
    assert {k: len(v) for k, v in fams.items()}["_hard"] == 6
    assert all(v[0].get("train_seed") is None for v in fams.values())
    assert [c["epochs"] for c in fams["_hard"]] == [14, 14, 14, 10, 10, 10]


# ---------------------------------------------------------------- (c) the slice against JAX

def _from_jax_init(arch):
    """A port builder with the signature of the factory's that starts from
    JAX's init at the same seed."""
    jax_build = jax_factory.build_multimodal if arch == "multimodal" else jax_factory.build_ecgcnn
    port_build = (port_factory.build_multimodal if arch == "multimodal"
                  else port_factory.build_ecgcnn)

    def build(num_labels=5, seed=42, torch_init=False, device=None):
        assert not torch_init
        _, variables = jax_build(num_labels=num_labels, seed=seed)
        model = port_build(num_labels=num_labels, seed=seed, device=device)
        state = from_flax_variables(jax.device_get(variables),
                                    "multimodal" if arch == "multimodal" else "ecgcnn")
        port_factory.merge_state(model, state, strict=True)
        return model

    return build


@pytest.mark.parametrize("arch", ["baseline", "multimodal"])
def test_port_arm_matches_run_jax(jax_sd, tmp_path, monkeypatch, arch):
    cfg = dict(TINY, arch=arch)
    monkeypatch.setattr(jax_sd, "OUT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(sd, "OUT_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(sd, "build_multimodal" if arch == "multimodal" else "build_ecgcnn",
                        _from_jax_init(arch))
    j = jax_sd.run_jax(cfg)
    p = sd.run_port(cfg, device="cpu")
    tag = "_mm" if arch == "multimodal" else ""
    assert os.path.exists(tmp_path / "port" / f"port{tag}.json")
    p_bce = [c["train_bce"] for c in p["curves"]]
    j_bce = [c["train_bce"] for c in j["curves"]]
    # the first epoch's batches and first updates: the same arithmetic
    np.testing.assert_allclose(p_bce[0], j_bce[0], rtol=1e-4)
    # later, AdamW's sign-like early steps (m/sqrt(v) ~ +-1 an element) carry
    # each package's f32 rounding of near-zero gradients into O(lr) moves:
    # the multi-step AdamW tolerances of tests/test_torch_trainer.py (loss
    # rtol 5e-3) and test_torch_train_step.py::test_fifty_steps_match_jax
    # (probs atol 4e-2, mean 2e-2), and the showdown's own AUROC budget
    np.testing.assert_allclose(p_bce, j_bce, rtol=5e-3)
    assert p["best_epoch"] == j["best_epoch"]
    np.testing.assert_array_equal(p["test_y"], j["test_y"])
    np.testing.assert_array_equal(p["val_y"], j["val_y"])
    for split in ("test_probs", "val_probs"):
        diff = np.abs(np.asarray(p[split]) - np.asarray(j[split]))
        assert diff.max() < 4e-2 and diff.mean() < 2e-2, (split, diff.max(), diff.mean())
    assert abs(p["test_auroc_macro"] - j["test_auroc_macro"]) < 0.005
    assert p["train_steps"] == cfg["epochs"] * 3  # 24 records, batch 8
    rep = sd.compare(cfg, jax_dirs=[str(tmp_path / "jax")])
    assert rep["metrics"]["auroc"]["delta"] < 0.005 and "config_mismatch" not in rep


def test_port_arm_af_artifact(tmp_path, monkeypatch):
    """The 1-logit task: the artifact's schema, [N, 1] probabilities and labels."""
    monkeypatch.setattr(sd, "OUT_DIR", str(tmp_path))
    cfg = dict(TINY, arch="af", epochs=1, train_seed=3)
    out = sd.run_port(cfg, device="cpu")
    on_disk = json.load(open(tmp_path / "port_af_ts3.json"))
    assert on_disk["framework"] == "port" and on_disk["config"]["arch"] == "af"
    for k in ("config", "curves", "best_epoch", "test_auroc_macro", "test_auprc_macro",
              "test_f1_macro", "test_prob_stats", "test_probs", "test_y", "val_probs",
              "val_y", "wall_s", "device"):
        assert k in on_disk, k
    assert np.asarray(on_disk["test_probs"]).shape == (16, 1)
    assert np.asarray(on_disk["val_y"]).shape == (16, 1)
    assert on_disk["device"] == {"name": "cpu", "power_limit": None}
    assert len(out["curves"]) == 1 and out["train_steps"] == 3
    assert 0.0 <= out["test_auroc_macro"] <= 1.0


# ---------------------------------------------------------------- (d) several JAX directories

def _family(jd_of, out, aurocs):
    """A baseline family: JAX seeds 0 (the base artifact) and 43-45
    (``jd_of(seed)`` says where each goes) and the port's, ``aurocs[i]`` apart."""
    for i, seed in enumerate((0, 43, 44, 45)):
        suffix = "" if seed == 0 else f"_ts{seed}"
        ts = None if seed == 0 else seed
        _artifact(jd_of(seed), f"jax{suffix}", 0.85 + 0.01 * i, ts, f1=0.5 + 0.02 * i)
        _artifact(out, f"port{suffix}", 0.85 + 0.01 * i + aurocs[i], ts, f1=0.5 + 0.03 * i)


def test_compare_over_two_dirs_equals_one(tmp_path, monkeypatch):
    """A family split over two JAX directories gives the report one directory
    holding all of it gives: the same pairs, means and verdicts."""
    out = tmp_path / "port"
    monkeypatch.setattr(sd, "OUT_DIR", str(out))
    one, a, b = tmp_path / "one", tmp_path / "a", tmp_path / "b"
    deltas = (0.0, 0.004, 0.03, -0.002)
    _family(lambda seed: one, out, deltas)
    _family(lambda seed: a if seed < 44 else b, out, deltas)
    want = sd.compare(TINY, jax_dirs=[str(one)])
    got = sd.compare(TINY, jax_dirs=[str(a), str(b)])
    assert got == want
    assert got["metrics"]["auroc"]["n"] == 4 and "seed_runs_dropped" not in got
    assert sd.compare(TINY, jax_dirs=[str(b), str(a)]) == want  # the primary found in either
    fams = sd.jax_families([str(a), str(b)])
    assert [c.get("train_seed") for c in fams[""]] == [None, 43, 44, 45]


def test_seed_in_two_dirs_is_deduped_and_warned(tmp_path, monkeypatch, capsys):
    """A seed in both directories counts once, the first directory's copy,
    with a warning; ``jax_families`` lists every file (the repeated seed is
    trained twice and compared once)."""
    out, a, b = tmp_path / "port", tmp_path / "a", tmp_path / "b"
    monkeypatch.setattr(sd, "OUT_DIR", str(out))
    _family(lambda seed: a, out, (0.0, 0.0, 0.0, 0.0))
    _artifact(b, "jax_ts43", 0.10, 43)  # the same seed again, far off
    _artifact(b, "jax_ts46", 0.88, 46)
    _artifact(out, "port_ts46", 0.88, 46)
    capsys.readouterr()
    runs = sd._collect_seed_runs("jax", "", False, [str(a), str(b)])
    assert set(runs) == {"_ts0", "_ts43", "_ts44", "_ts45", "_ts46"}
    assert runs["_ts43"]["dir"] == str(a) and runs["_ts43"]["metrics"]["auroc"] == 0.86
    err = capsys.readouterr().err
    assert "same effective train seed (ts43)" in err and str(b) in err
    rep = sd.compare(TINY, jax_dirs=[str(a), str(b)])
    assert rep["metrics"]["auroc"]["n"] == 5
    assert rep["metrics"]["auroc"]["mean"]["jax"] == pytest.approx(
        np.mean([0.85, 0.86, 0.87, 0.88, 0.88]))
    assert "same effective train seed (ts43)" in capsys.readouterr().err
    fams = sd.jax_families([str(a), str(b)])
    assert [c.get("train_seed") for c in fams[""]] == [None, 43, 44, 45, 43, 46]


def test_main_reads_every_jax_dir(tmp_path, monkeypatch):
    """``--jax_dir`` repeated: ``compare`` reads the union, ``run --from_jax``
    compares over the directories given."""
    out, a, b = tmp_path / "port", tmp_path / "a", tmp_path / "b"
    monkeypatch.setattr(sd, "OUT_DIR", str(out))
    _family(lambda seed: a if seed < 44 else b, out, (0.0, 0.0, 0.0, 0.0))
    monkeypatch.setattr(sd, "make_config", lambda args: TINY)
    assert sd.main(["compare", "--jax_dir", str(a), "--jax_dir", str(b)]) == 0
    rep = json.load(open(out / "report_port.json"))
    assert rep["metrics"]["auroc"]["n"] == 4
    seen = _run_from_jax(monkeypatch, b / "jax_ts44.json", "--jax_dir", str(a), "--jax_dir", str(b))
    assert seen == [str(a), str(b)]


def _run_from_jax(monkeypatch, path, *argv):
    """The directories ``main(["run", "--from_jax", path, *argv])`` hands to
    ``run_families`` (which is not run)."""
    seen = []
    monkeypatch.setattr(sd, "jax_config", lambda p: dict(TINY, train_seed=44))
    monkeypatch.setattr(sd, "run_families",
                        lambda fams, device, dirs, **kw: seen.extend(dirs) or {})
    sd.main(["run", "--from_jax", str(path), *argv])
    return seen


def test_main_defaults_to_the_committed_jax_dir(tmp_path, monkeypatch):
    """With no ``--jax_dir`` every command reads ``outputs/showdown/`` alone:
    ``run --from_jax`` adds no directory of its own."""
    monkeypatch.setattr(sd, "JAX_DIR", str(tmp_path / "default"))
    assert _run_from_jax(monkeypatch, tmp_path / "b" / "jax_ts44.json") == [str(tmp_path / "default")]


@pytest.fixture(scope="module")
def seed_artifacts():
    names = sorted(f for f in os.listdir(SEEDS_DIR) if f.endswith(".json"))
    return {f: json.load(open(os.path.join(SEEDS_DIR, f))) for f in names}


def test_committed_seed_artifacts(seed_artifacts):
    """outputs/showdown_seeds: JAX's mm-hard ``_ti`` seeds 44-47, made on the CPU
    with the stored family's recipe, each named as its config says; with
    outputs/showdown they make a family of six."""
    assert sorted(seed_artifacts) == [f"jax_mm_hard_ts{s}_ti.json" for s in (44, 45, 46, 47)]
    ref = sd.jax_config(os.path.join(sd.JAX_DIR, "jax_mm_hard_ti.json"))
    for f, blob in seed_artifacts.items():
        cfg = sd.jax_config(os.path.join(SEEDS_DIR, f))
        assert (cfg["arch"], cfg["hard"], cfg["jax_torch_init"]) == ("multimodal", True, True)
        assert cfg["train_seed"] == int(f[len("jax_mm_hard_ts"):][:2])
        assert sd._config_mismatch(cfg, ref) == {}
        assert blob["framework"] == "jax" and blob["backend"] == "cpu"
        assert len(blob["curves"]) == cfg["epochs"] == 10
        assert 0.5 < blob["test_auroc_macro"] <= 1.0
    fams = sd.jax_families([sd.JAX_DIR, SEEDS_DIR])
    assert [c.get("train_seed") for c in fams["_mm_hard_ti"]] == [None, 43, 44, 45, 46, 47]
    runs = sd._collect_seed_runs("jax", "_mm_hard", True, [sd.JAX_DIR, SEEDS_DIR])
    assert sorted(runs) == [f"_ts{s}" for s in range(42, 48)]


def test_seed_artifacts_labels_equal_the_regenerated(seed_artifacts):
    """Each new artifact's stored ``test_y`` / ``val_y`` equal the port's labels
    regenerated from the dataset seed (val: seed + 1, test: seed + 2)."""
    cfg = sd.jax_config(os.path.join(SEEDS_DIR, "jax_mm_hard_ts44_ti.json"))
    want = {}
    for k, split in ((1, "val"), (2, "test")):
        _, y = sd.make_split(cfg[f"n_{split}"], cfg["seed"] + k, cfg["T"], hard=True,
                             label_flip=0.04)
        want[split] = sd.arch_labels(y, cfg["arch"])
    for f, blob in seed_artifacts.items():
        assert sd.jax_config(os.path.join(SEEDS_DIR, f))["seed"] == cfg["seed"]
        for split in ("val", "test"):
            np.testing.assert_array_equal(np.asarray(blob[f"{split}_y"], np.float32),
                                          want[split], err_msg=f"{f} {split}_y")
