"""The port's PTB-XL data layer against ptbxl_tpu's, on the hermetic fixture
(``ptbxl_dir``: 40 records, T=512, with its edge cases).

Label maps and row order, the CSV reader against pandas, the YAML config
reader against ``yaml.safe_load``, the validity manifest, the ADC cache, the
three datasets (masks, ``y``, ``demo``, ``get_raw``, normalized items at
1e-6), ``BatchSource`` in every mode for two epochs, ``device_prefetch``'s
int16 path against its f32 path, the threshold search against scikit-learn's,
and the port's synthetic tree against the fixture's.
"""

import glob
import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from ptbxl_tpu.data import PTBXLAFDataset as JAF
from ptbxl_tpu.data import PTBXLDataset as JDS
from ptbxl_tpu.data import PTBXLECGMultimodalDataset as JMM
from ptbxl_tpu.data.cache import ADCCache as JCache
from ptbxl_tpu.data.manifest import ValidityManifest as JManifest
from ptbxl_tpu.data.pipeline import BatchSource as JBatchSource
from ptbxl_tpu.training import thresholds as jax_thresholds
from ptbxl_tpu.utils import label_maps as jax_labels

from ptbxl_torch import config as C
from ptbxl_torch.data import PTBXLAFDataset, PTBXLDataset, PTBXLECGMultimodalDataset
from ptbxl_torch.data.cache import ADCCache
from ptbxl_torch.data.manifest import CACHE_DIRNAME, ValidityManifest, check_record
from ptbxl_torch.data.pipeline import BatchSource, device_prefetch
from ptbxl_torch.training import thresholds
from ptbxl_torch.utils import label_maps
from ptbxl_torch.utils.table import read_csv, write_csv
from tests.fixtures.synthetic_ptbxl import make_synthetic_ptbxl as fixture_make
from tests.torch_port_common import HERE, InMemoryECG

CLASSES = ["MI", "STTC", "HYP", "CD", "NORM"]
SPLITS = ["train", "val", "test"]


# -- metadata, labels, CSV ---------------------------------------------------------

def test_csv_reader_types_like_pandas(ptbxl_dir):
    for name in ("ptbxl_database.csv", "scp_statements.csv"):
        path = os.path.join(ptbxl_dir, name)
        got, want = read_csv(path), pd.read_csv(path)
        assert got.columns == list(want.columns)
        for c in want.columns:
            for a, b in zip(got[c], want[c].tolist()):
                assert (pd.isna(a) and pd.isna(b)) or (a == b and type(a) is type(b)), (c, a, b)


def test_csv_quoted_fields_and_writer(tmp_path):
    df = pd.DataFrame({"report": ["sinus, normal\nsecond line", 'a "q"', ""], "n": [1, 2, 3],
                       "x": [0.5, np.nan, 2.0], "flag": ["True", "False", "True"]})
    df.to_csv(tmp_path / "a.csv", index=False)
    t = read_csv(str(tmp_path / "a.csv"))
    assert t["report"][0] == "sinus, normal\nsecond line" and pd.isna(t["report"][2])
    assert t["n"] == [1, 2, 3] and pd.isna(t["x"][1]) and t["flag"] == [True, False, True]
    cols = {"y_true": np.array([1, 0]), "y_prob": np.array([0.123456789, 1e-7], np.float32),
            "z": [0.1, np.nan]}
    write_csv(str(tmp_path / "p.csv"), cols)
    pd.DataFrame(cols).to_csv(tmp_path / "q.csv", index=False)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "q.csv").read_bytes()


def test_label_maps_match_jax(ptbxl_dir):
    df, scp = label_maps.load_metadata(ptbxl_dir)
    jdf, jscp = jax_labels.load_metadata(ptbxl_dir)
    assert list(df["filename_hr"]) == jdf["filename_hr"].tolist()
    np.testing.assert_array_equal(label_maps.build_label_matrix(df, scp, CLASSES),
                                  jax_labels.build_label_matrix(jdf, jscp, CLASSES))
    assert label_maps.find_af_codes(scp) == jax_labels.find_af_codes(jscp) == ["AFIB"]
    assert label_maps.find_af_codes(scp, ["flutter", "fib"]) == \
        jax_labels.find_af_codes(jscp, ["flutter", "fib"])
    np.testing.assert_array_equal(label_maps.build_af_binary_labels(df, scp),
                                  jax_labels.build_af_binary_labels(jdf, jscp))
    y = label_maps.build_label_matrix(df, scp, CLASSES)
    assert not y[7].any() and not y[8].any()  # malformed / list scp_codes


# -- the YAML config reader ----------------------------------------------------------

def _test_configs():
    """The configs of tests/test_train_scripts_e2e.py and tests/test_cli_edge_cases.py."""
    base = ('seed: 42\ndata:\n  base_dir: /data/ptb\n  normalize: per_lead\n'
            '  labels: ["MI", "STTC", "HYP", "CD", "NORM"]\ntrain:\n  batch_size: 8\n'
            '  epochs: 2\n  lr: 1e-3\n  weight_decay: 1e-4\n')
    return {
        "e2e_baseline": base + 'model:\n  ecg:\n    in_leads: 12\n    feat_dim: 256\n'
                               'log:\n  out_dir: "outputs"\n',
        "e2e_multimodal": base + "  early_stop_patience: 8\nmodel:\n  ecg_multimodal:\n"
                                 "    in_leads: 12\n    ecg_feat_dim: 256\n    demo_hidden_dim: 64\n"
                                 "    pretrained_ecg_ckpt: /tmp/x/ecg_baseline_best.npz\n"
                                 'log:\n  out_dir: "outputs/ecg_multimodal"\n',
        "e2e_af": base + "model:\n  ecg:\n    in_leads: 12\n    feat_dim: 256\n"
                         "log:\n  out_dir: outputs/af_binary\n  run_name: af_binary_ecg\n",
        "cli_edge": 'seed: 42\ndata:\n  base_dir: /d\n  labels: ["MI", "STTC", "HYP", "CD", "NORM"]\n'
                    "train:\n  batch_size: 4\n",
        "scalars": "a: yes\nb: 'it''s # no comment'\nc: \"q\\\"x\" # c\n"
                   "d: [1, 2.5, '3', x y, 1e3, 1.0e+3, .5, ~, null, on, 0x1F, 010]\n"
                   "e:\n  k: v\nf: -.inf\ng: 1:30\nh:\ni: C:\\data\\x\n",
    }


CONFIG_CASES = sorted(glob.glob(os.path.join(HERE, "configs", "*.yaml"))) + sorted(_test_configs())


@pytest.mark.parametrize("case", CONFIG_CASES, ids=os.path.basename)
def test_config_reader_matches_safe_load(case, tmp_path):
    if os.path.isabs(case):
        text = open(case).read()
    else:
        text = _test_configs()[case]
    path = tmp_path / "c.yaml"
    path.write_text(text)
    got, want = C.parse_yaml(text), yaml.safe_load(text)
    assert repr(got) == repr(want)  # types too: 1e-4 is a str, 1.5e-3 a float
    if isinstance(want, dict) and "train" in want:
        assert C.load_config(str(path)) == want
        lr = want["train"].get("lr", 1e-3)
        assert C.get_float(C.train_cfg(want), "lr", 1e-3) == float(lr)


def test_config_quirks_and_env(monkeypatch):
    cfg = C.parse_yaml("data:\n  base_dir: x\nmodel:\n  ecg_demo:\n    demo_feat_dim: 32\n")
    assert C.model_cfg_multimodal(cfg) == {"demo_feat_dim": 32}
    assert C.multimodal_hidden_dim(C.model_cfg_multimodal(cfg)) == 32
    assert C.get_classes(cfg) == C.DEFAULT_CLASSES and C.get_seed(cfg) == 42
    monkeypatch.setenv("PTBXL_BASE_DIR", "/elsewhere")
    assert C.get_base_dir(cfg) == "/elsewhere"
    for text in ("a: {b: 1}\n", "a:\n  - 1\n"):
        with pytest.raises(ValueError):
            C.parse_yaml(text)


# -- manifest, cache, datasets -------------------------------------------------------

def test_manifest_matches_jax(ptbxl_dir):
    df, _ = label_maps.load_metadata(ptbxl_dir)
    rels = list(df["filename_hr"])
    got = ValidityManifest(ptbxl_dir).filter_valid(rels)
    assert got == JManifest(ptbxl_dir, use_cache=False).filter_valid(rels)
    assert got.count(False) == 1 and not check_record(ptbxl_dir, rels[5])
    assert os.path.exists(os.path.join(ptbxl_dir, CACHE_DIRNAME, "validity_manifest.json"))
    assert ValidityManifest(ptbxl_dir).filter_valid(rels) == got  # from the memo


def test_adc_cache_matches_jax(ptbxl_dir, tmp_path):
    ds = PTBXLDataset(ptbxl_dir, "train", CLASSES)
    rels = list(ds.df["filename_hr"])
    cache = ADCCache(ptbxl_dir, rels, cache_dir=str(tmp_path / "p")).ensure_built(verbose=False)
    jcache = JCache(ptbxl_dir, rels, cache_dir=str(tmp_path / "j")).ensure_built(verbose=False)
    assert cache.decoder == "native"
    np.testing.assert_array_equal(np.asarray(cache._adc), np.asarray(jcache._adc))
    idx = [3, 0, 7, 7]
    np.testing.assert_array_equal(cache.get_physical(idx), jcache.get_physical(idx))
    assert os.path.basename(cache._paths()[0]) == os.path.basename(jcache._paths()[0])
    again = ADCCache(ptbxl_dir, rels, cache_dir=str(tmp_path / "p")).ensure_built(verbose=False)
    assert again.decoder == "cached"


def test_adc_cache_python_reader_and_range_checks(ptbxl_dir, tmp_path, monkeypatch):
    from ptbxl_torch.data import cache as cache_mod
    from ptbxl_torch.io import wfdb_io

    monkeypatch.setattr(cache_mod.native, "available", lambda: False)
    ds = PTBXLDataset(ptbxl_dir, "val", CLASSES)
    rels = list(ds.df["filename_hr"])
    c = ADCCache(ptbxl_dir, rels, cache_dir=str(tmp_path / "py")).ensure_built(verbose=False)
    j = JCache(ptbxl_dir, rels, cache_dir=str(tmp_path / "j")).ensure_built(verbose=False)
    assert c.decoder == "python"
    np.testing.assert_array_equal(np.asarray(c._adc), np.asarray(j._adc))
    wide = str(tmp_path / "wide" / "r")
    wfdb_io.write_record(wide, np.full((20, 12), 40.0), fmt=32, gain=1000.0)
    with pytest.raises(ValueError, match="outside int16"):
        ADCCache(str(tmp_path / "wide"), ["r"]).ensure_built(verbose=False)


@pytest.mark.parametrize("split", SPLITS)
def test_datasets_match_jax(ptbxl_dir, split):
    pairs = [(PTBXLDataset(ptbxl_dir, split, CLASSES), JDS(ptbxl_dir, split, CLASSES)),
             (PTBXLECGMultimodalDataset(ptbxl_dir, split, CLASSES), JMM(ptbxl_dir, split, CLASSES)),
             (PTBXLAFDataset(ptbxl_dir, split), JAF(ptbxl_dir, split))]
    for p, j in pairs:
        assert len(p) == len(j) and p._num_total == j._num_total
        assert list(p.df["filename_hr"]) == j.df["filename_hr"].tolist()
        np.testing.assert_array_equal(p.y, j.y)
        assert p.y.dtype == j.y.dtype
        assert p.record_path(0) == j.record_path(0)
        np.testing.assert_array_equal(p.get_raw(len(p) - 1), j.get_raw(len(j) - 1))
        for a, b in zip(p[0], j[0]):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(pairs[1][0].demo, pairs[1][1].demo)
    assert pairs[1][0].demo.dtype == np.float32


def test_multimodal_demo_rules(ptbxl_dir):
    mm = PTBXLECGMultimodalDataset(ptbxl_dir, "train", CLASSES)
    ids = list(mm.df["ecg_id"])
    assert 4 not in ids  # index 3: no age
    row = ids.index(5)  # index 4: age 300 -> 90
    assert mm.demo[row, 0] == np.float32(0.9)
    assert (mm.demo[:, 1] == 0.5).all()  # numeric sex
    assert (mm.demo[:, 4] == 0.0).all()  # string pacemaker


# -- the batch pipeline ----------------------------------------------------------------

MODES = [{}, {"use_adc_cache": False}, {"emit_adc": True}]


@pytest.mark.parametrize("mode", MODES, ids=["cache", "nocache", "emit_adc"])
@pytest.mark.parametrize("kind", ["baseline", "multimodal"])
def test_batch_source_matches_jax(ptbxl_dir, mode, kind):
    make = {"baseline": (PTBXLDataset, JDS), "multimodal": (PTBXLECGMultimodalDataset, JMM)}[kind]
    p_ds, j_ds = make[0](ptbxl_dir, "train", CLASSES), make[1](ptbxl_dir, "train", CLASSES)
    p, j = BatchSource(p_ds, 8, shuffle=True, seed=3, **mode), JBatchSource(
        j_ds, 8, shuffle=True, seed=3, **mode)
    assert p.reader == ("native" if mode.get("use_adc_cache") is False else "adc_cache")
    assert p.emit_adc == bool(mode.get("emit_adc")) and p.steps_per_epoch == j.steps_per_epoch
    for epoch in range(2):
        pb, jb = list(p.epoch(epoch)), list(j.epoch(epoch))
        assert len(pb) == len(jb) == p.steps_per_epoch
        for a, b in zip(pb, jb):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batch_source_in_memory_and_python_reader(ptbxl_dir, monkeypatch):
    """A dataset without ``base_dir``/``df`` reads per record through ``get_raw``
    (emit_adc falls back to f32); without the native library a PTB-XL
    dataset without the cache takes the Python reader."""
    mem = InMemoryECG(n=10, t=64)
    src = BatchSource(mem, 4, shuffle=False, emit_adc=True)
    assert src.reader == "python" and not src.emit_adc
    batches = list(src.epoch(0))
    np.testing.assert_array_equal(batches[0]["ecg"], mem.x[:4].transpose(0, 2, 1))
    from ptbxl_torch.data import pipeline

    monkeypatch.setattr(pipeline.native, "available", lambda: False)
    ds = PTBXLDataset(ptbxl_dir, "val", CLASSES)
    src = BatchSource(ds, 4, shuffle=False, use_adc_cache=False)
    assert src.reader == "python"
    jb = next(JBatchSource(JDS(ptbxl_dir, "val", CLASSES), 4, shuffle=False,
                           use_adc_cache=False).epoch(0))
    np.testing.assert_array_equal(next(src.epoch(0))["ecg"], jb["ecg"])


def test_device_prefetch_int16_path_equals_f32_path(ptbxl_dir):
    ds = PTBXLDataset(ptbxl_dir, "train", CLASSES)
    f32 = BatchSource(ds, 8, shuffle=True, seed=1)
    i16 = BatchSource(ds, 8, shuffle=True, seed=1, emit_adc=True)
    n = 0
    for a, b in zip(device_prefetch(f32.epoch(0), "cpu"), device_prefetch(i16.epoch(0), "cpu")):
        assert a.keys() == b.keys() and "adc_lt" not in b
        for k in a:
            assert torch.equal(a[k], b[k]), k
        n += 1
    assert n == f32.steps_per_epoch
    # the missing-sample sentinel: NaN on both paths at the same positions
    hb = next(i16.epoch(0))
    hb["adc_lt"] = hb["adc_lt"].copy()
    hb["adc_lt"][0, 2, 5] = -32768
    (dev,) = device_prefetch(iter([hb]), "cpu")
    want = (hb["adc_lt"].astype(np.float32) - hb["baseline"][:, :, None]) / hb["gain"][:, :, None]
    want[hb["adc_lt"] == -32768] = np.nan
    np.testing.assert_array_equal(dev["ecg"].numpy(), want.transpose(0, 2, 1))


# -- thresholds, the synthetic tree ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threshold_search_matches_sklearn_version(seed):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=(120, 4)) > [0.5, 0.9, 0.97, 0.3]).astype(np.float32)
    p = np.clip(y * 0.3 + rng.uniform(size=y.shape) * 0.7, 0, 1).astype(np.float32)
    y[:, 3] = 0  # no positives: 0.5
    np.testing.assert_array_equal(thresholds.search_thresholds_per_class(y, p),
                                  jax_thresholds.search_thresholds_per_class(y, p))
    grid = np.arange(0.05, 0.951, 0.05)
    np.testing.assert_array_equal(thresholds.search_thresholds_per_class(y, p, grid),
                                  jax_thresholds.search_thresholds_per_class(y, p, grid))
    thr, fitted = thresholds.fit_on_val_report(y, p, y[:60], p[:60])
    jthr, jfitted = jax_thresholds.fit_on_val_report(y, p, y[:60], p[:60])
    np.testing.assert_array_equal(thr, jthr)
    for k in jfitted:
        np.testing.assert_allclose(fitted[k], jfitted[k], rtol=1e-12, equal_nan=True)
    np.testing.assert_array_equal(thresholds.apply_thresholds(p, thr),
                                  jax_thresholds.apply_thresholds(p, thr))


def test_synthetic_tree_matches_fixture(tmp_path):
    from ptbxl_torch.tools.synthetic_ptbxl import make_synthetic_ptbxl

    fixture_make(str(tmp_path / "a"), n_records=12, n_samples=300, seed=4)
    make_synthetic_ptbxl(str(tmp_path / "b"), n_records=12, n_samples=300, seed=4)
    files = sorted(os.path.relpath(p, tmp_path / "a")
                   for p in glob.glob(str(tmp_path / "a" / "**" / "*.*"), recursive=True))
    assert files == sorted(os.path.relpath(p, tmp_path / "b")
                           for p in glob.glob(str(tmp_path / "b" / "**" / "*.*"), recursive=True))
    for rel in files:
        if rel.endswith(".csv"):
            pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "a" / rel),
                                          pd.read_csv(tmp_path / "b" / rel))
        else:
            assert (tmp_path / "a" / rel).read_bytes() == (tmp_path / "b" / rel).read_bytes(), rel
