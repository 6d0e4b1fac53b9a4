"""The port's WFDB fuzz (ptbxl_torch/tools/fuzz_wfdb.py) against the JAX tool
(tools/fuzz_wfdb.py) and its codec (ptbxl_tpu/io/wfdb_io.py).

A bounded run of the port's trials, its scalar packers against the port
codec's vectorised encoders byte for byte, a replay of any failure fixture,
the same random records decoded by both codecs (ADC and physical arrays
equal, NaN positions included), and the two tools writing the same bytes and
header text from one seed.
"""

import glob
import importlib.util
import os
import tempfile

import numpy as np
import pytest

from ptbxl_tpu.io import wfdb_io as jax_io
from ptbxl_torch.io import wfdb_io as port_io
from ptbxl_torch.tools import fuzz_wfdb

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_wfdb", os.path.join(HERE, "tools", "fuzz_wfdb.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fuzz_bounded():
    rng = np.random.default_rng(1234)
    with tempfile.TemporaryDirectory() as d:
        for t in range(120):
            errs = fuzz_wfdb.run_trial(rng, d, t)
            assert not errs, errs[0][1]


def test_wfdb_branch_is_refused():
    with tempfile.TemporaryDirectory() as d, pytest.raises(NotImplementedError, match="wfdb"):
        fuzz_wfdb.run_trial(np.random.default_rng(0), d, 0, use_wfdb=True)


@pytest.mark.parametrize("fmt", (16, 24, 32, 61, 80, 160, 212, 310, 311))
def test_packers_match_the_port_encoders(fmt):
    """Scalar packers and the codec's vectorised encoders agree byte for byte,
    at an odd count (31: a packed tail in 212, 310 and 311)."""
    lo, hi = fuzz_wfdb.RANGES[fmt]
    vals = np.random.default_rng(7 + fmt).integers(lo, hi + 1, size=31, dtype=np.int64)
    assert fuzz_wfdb.PACKERS[fmt](vals.tolist()) == port_io._ENCODERS[fmt](vals)


def test_fixtures_replay():
    """Any fixture a past fuzz failure left must decode now."""
    heas = glob.glob(os.path.join(fuzz_wfdb.FIXTURE_DIR, "*.hea"))
    if not heas:
        pytest.skip("no fuzz-failure fixtures in tests/fixtures/fuzz_torch (none has failed)")
    for hea in heas:
        phys, hdr = port_io.rdsamp(hea[:-4])
        assert phys.shape[0] == hdr.n_samples


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_both_codecs_decode_the_same_trials(seed):
    """80 random records a seed (multi-segment ones among them) read by the JAX
    codec and by the port's: the same arrays, dtypes and NaN positions."""
    rng = np.random.default_rng(seed)
    kinds = set()
    with tempfile.TemporaryDirectory() as d:
        for t in range(80):
            if rng.random() < 0.15:
                rec = fuzz_wfdb.gen_multi_segment(rng, d, f"t{t}")
                kinds.add("multi")
            else:
                rec = fuzz_wfdb.gen_single_segment(rng, d, f"t{t}")
                kinds.add("general" if rec["general"] else "plain")
                a_jax, h_jax = jax_io.read_adc(rec["path"])
                a_port, h_port = port_io.read_adc(rec["path"])
                assert a_port.dtype == a_jax.dtype
                np.testing.assert_array_equal(a_port, a_jax)
                assert h_port.n_samples == h_jax.n_samples
            p_jax, _ = jax_io.rdsamp(rec["path"])
            p_port, _ = port_io.rdsamp(rec["path"])
            assert p_port.dtype == p_jax.dtype
            np.testing.assert_array_equal(p_port, p_jax)  # NaN where NaN
    assert kinds == {"multi", "general", "plain"}


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("seed", [0, 5])
def test_records_equal_the_jax_tools(jax_tool, seed):
    """From one seed both tools write the same .dat bytes and .hea text and
    draw the same amount, single- and multi-segment."""
    for fmt in fuzz_wfdb.ALL_FMTS:
        vals = np.random.default_rng(fmt).integers(-100, 100, size=13).tolist()
        assert fuzz_wfdb.PACKERS[fmt](vals) == jax_tool.PACKERS[fmt](vals), fmt
    r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as dp, tempfile.TemporaryDirectory() as dj:
        for t in range(40):
            a = fuzz_wfdb.gen_single_segment(r_port, dp, f"t{t}")
            b = jax_tool.gen_single_segment(r_jax, dj, f"t{t}")
            np.testing.assert_array_equal(a["expected_phys"], b["expected_phys"])
            assert a["meta"] == b["meta"]
        fuzz_wfdb.gen_multi_segment(r_port, dp, "m")
        jax_tool.gen_multi_segment(r_jax, dj, "m")
        assert _files(dp) == _files(dj)
    assert r_port.random() == r_jax.random()
