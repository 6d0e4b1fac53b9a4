"""The port's WFDB reader/writer (ptbxl_torch/io/wfdb_io.py) and C++ batch
decoder (ptbxl_torch/io/native.py) against ptbxl_tpu's.

Every format that ``ptbxl_tpu.io.wfdb_io.write_record`` writes, with
missing-sample sentinels where the format has one, multi-sample frames and
skew, and multi-segment records (fixed and variable layout, null segments):
the port reads identical ADC and physical arrays, NaN positions included.
The port's writer writes byte-identical files; the native decoder, gather and
conversion are identical to the port's Python reader and to the JAX
package's own native layer.
"""

import os

import numpy as np
import pytest

from ptbxl_tpu.io import native as jax_native
from ptbxl_tpu.io import wfdb_io as J

from ptbxl_torch.io import native
from ptbxl_torch.io import wfdb_io as P

FORMATS = [8, 16, 24, 32, 61, 80, 160, 212, 310, 311]


def _signal(fmt, t=257, n_sig=3):
    rng = np.random.default_rng(fmt)
    sig = np.cumsum(rng.uniform(-0.05, 0.05, size=(t, n_sig)), axis=0)
    sig /= max(1.0, np.max(np.abs(sig)))
    gain = {80: 100.0, 310: 400.0, 311: 400.0}.get(fmt, 1000.0)
    return sig, gain


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)  # NaN positions must agree


def _files(path):
    return [open(path + ext, "rb").read() for ext in (".hea", ".dat")]


@pytest.mark.parametrize("fmt", FORMATS)
def test_writer_bytes_and_reads_match_jax(tmp_path, fmt):
    sig, gain = _signal(fmt)
    jrec, prec = str(tmp_path / f"j{fmt}"), str(tmp_path / f"p{fmt}")
    J.write_record(jrec, sig, fmt=fmt, gain=gain, baseline=3)
    P.write_record(prec, sig, fmt=fmt, gain=gain, baseline=3)
    assert _files(jrec)[1] == _files(prec)[1]
    assert _files(jrec)[0].replace(b"j%d" % fmt, b"p%d" % fmt) == _files(prec)[0]
    ja, _ = J.read_adc(jrec)
    pa, ph = P.read_adc(jrec)
    _assert_same(pa, ja)
    _assert_same(P.rdsamp(jrec)[0], J.rdsamp(jrec)[0])
    assert [vars(s) for s in ph.signals] == [vars(s) for s in J.read_header(jrec).signals]


@pytest.mark.parametrize("fmt", [16, 61, 160, 212, 310, 311, 24, 32, 80])
def test_missing_sentinels_read_as_nan_like_jax(tmp_path, fmt):
    """The format's most negative code word (WFDB's missing sample) in two
    places: NaN at the same positions in both readers."""
    sig, gain = _signal(fmt, t=31, n_sig=2)
    rec = str(tmp_path / f"s{fmt}")
    J.write_record(rec, sig, fmt=fmt, gain=gain)
    adc, hdr = J.read_adc(rec)
    adc = adc.astype(np.int64)
    adc[[3, 17], [0, 1]] = J._MISSING[fmt]
    flat = adc.reshape(-1)
    with open(rec + ".dat", "wb") as f:
        f.write(J._ENCODERS[fmt](flat))
    _assert_same(P.read_adc(rec)[0], J.read_adc(rec)[0])
    want = J.rdsamp(rec)[0]
    assert np.isnan(want).sum() == 2
    _assert_same(P.rdsamp(rec)[0], want)


def test_frames_and_skew_match_jax(tmp_path):
    """samps_per_frame 2 (frame-averaged, a sentinel in one frame) and skew 2:
    float64 frames with NaN tails in both readers."""
    raw = np.array([[10, 20, 5], [30, -32768, 6], [50, 60, 7], [70, 80, 8]], np.int16)
    (tmp_path / "f.dat").write_bytes(raw.astype("<i2").tobytes())
    (tmp_path / "f.hea").write_text("f 2 500 4\nf.dat 16x2 100(0)/mV 16 0 0 0 0 a\n"
                                    "f.dat 16:2 100(0)/mV 16 0 0 0 0 b\n")
    rec = str(tmp_path / "f")
    _assert_same(P.read_adc(rec)[0], J.read_adc(rec)[0])
    _assert_same(P.rdsamp(rec)[0], J.rdsamp(rec)[0])


def _write_master(path, name, n_sig, fs, segments):
    total = sum(n for _, n in segments)
    lines = [f"{name}/{len(segments)} {n_sig} {fs:g} {total}"] + [f"{s} {n}" for s, n in segments]
    path.write_text("\n".join(lines) + "\n")


def test_multi_segment_records_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    P.write_record_fmt16(str(tmp_path / "seg01"), rng.standard_normal((100, 3)), gain=1000.0)
    P.write_record_fmt16(str(tmp_path / "seg02"), rng.standard_normal((60, 3)), gain=2000.0)
    _write_master(tmp_path / "multi.hea", "multi", 3, 500.0,
                  [("seg01", 100), ("~", 40), ("seg02", 60)])
    layout = ["lay 3 500 0"] + [f"lay.dat 16 1000(0)/mV 16 0 0 0 0 {d}" for d in "ABC"]
    (tmp_path / "lay.hea").write_text("\n".join(layout) + "\n")
    (tmp_path / "lay.dat").write_bytes(b"")
    P.write_record_fmt16(str(tmp_path / "sa"), rng.standard_normal((50, 3)), gain=1000.0,
                         descriptions=["A", "B", "C"])
    P.write_record_fmt16(str(tmp_path / "sb"), rng.standard_normal((30, 2)), gain=1000.0,
                         descriptions=["C", "A"])
    _write_master(tmp_path / "vmulti.hea", "vmulti", 3, 500.0,
                  [("lay", 0), ("sa", 50), ("sb", 30)])
    for name in ("multi", "vmulti"):
        got, ph = P.rdsamp(str(tmp_path / name))
        want, jh = J.rdsamp(str(tmp_path / name))
        _assert_same(got, want)
        assert np.isnan(got).any()
        assert [s.description for s in ph.signals] == [s.description for s in jh.signals]
    with pytest.raises(NotImplementedError, match="multi-segment"):
        P.read_adc(str(tmp_path / "multi"))


def test_write_record_fmt16_bytes_match_jax(tmp_path):
    sig = np.random.default_rng(0).standard_normal((512, 12))
    J.write_record_fmt16(str(tmp_path / "a" / "r"), sig, gain=1000.0)
    P.write_record_fmt16(str(tmp_path / "b" / "r"), sig, gain=1000.0)
    assert _files(str(tmp_path / "a" / "r")) == _files(str(tmp_path / "b" / "r"))


def test_min_bytes_and_errors_match_jax(tmp_path):
    assert {f: P._MIN_BYTES[f](7) for f in FORMATS} == {f: J._MIN_BYTES[f](7) for f in FORMATS}
    rec = str(tmp_path / "t")
    P.write_record_fmt16(rec, np.zeros((10, 2)))
    with open(rec + ".dat", "r+b") as f:
        f.truncate(10)
    with pytest.raises(ValueError, match="truncated"):
        P.read_adc(rec)
    with pytest.raises(NotImplementedError):
        P.write_record(rec, np.zeros((4, 1)), fmt=999)


# -- the native decoder ---------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(1)
    paths = []
    for i in range(5):
        rec = str(root / f"r{i}")
        P.write_record_fmt16(rec, rng.standard_normal((300, 12)), gain=1000.0, baseline=i)
        paths.append(rec)
    # a sentinel in record 2
    adc, _ = P.read_adc(paths[2])
    adc[7, 4] = -32768
    with open(paths[2] + ".dat", "wb") as f:
        f.write(adc.astype("<i2").tobytes())
    return paths


def test_native_builds_here():
    assert native.available(), native.build_error()


def test_native_decode_matches_python_and_jax(records):
    adc, ok = native.decode_batch_fmt16([p + ".dat" for p in records], 300, 12, n_threads=3)
    assert ok.all() and adc.dtype == np.int16 and adc.shape == (5, 12, 300)
    jadc, jok = jax_native.decode_batch_fmt16([p + ".dat" for p in records], 300, 12)
    np.testing.assert_array_equal(adc, jadc)
    for i, rec in enumerate(records):
        np.testing.assert_array_equal(adc[i], P.read_adc(rec)[0].T.astype(np.int16))
    _, ok = native.decode_batch_fmt16([records[0] + ".dat", "/no/such.dat"], 300, 12)
    assert ok.tolist() == [True, False]


def test_native_gather_and_convert_match(records):
    adc, _ = native.decode_batch_fmt16([p + ".dat" for p in records], 300, 12)
    idx = np.array([4, 0, 2, 2])
    np.testing.assert_array_equal(native.gather_rows(adc, idx, n_threads=2), adc[idx])
    np.testing.assert_array_equal(native.gather_rows(adc, idx), jax_native.gather_rows(adc, idx))
    with pytest.raises(IndexError):
        native.gather_rows(adc, np.array([5]))
    hdr = P.read_header(records[2])
    gains = np.array([s.gain for s in hdr.signals], np.float32)
    bases = np.array([s.effective_baseline for s in hdr.signals], np.float32)
    phys = native.adc_to_physical(adc[2], gains, bases)
    _assert_same(phys, jax_native.adc_to_physical(adc[2], gains, bases))
    want = P.rdsamp(records[2])[0].T.astype(np.float32)
    assert np.isnan(phys).sum() == 1
    np.testing.assert_array_equal(np.isnan(phys), np.isnan(want))
    np.testing.assert_allclose(phys, want, rtol=1e-6, atol=1e-9)


def test_native_library_lives_under_build():
    path = native.library_path(native._compiler())
    assert os.path.exists(path) and "/build/ptbxl_torch/" in path
