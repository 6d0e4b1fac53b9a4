"""The port's signal ops (ptbxl_torch/ops/signal.py) against ptbxl_tpu.ops.signal
on the same seeded inputs, and tests/test_signal_ops.py's property cases on
the port.  Tolerance 1e-5: the convolutions are f32 with TF32 off in both
packages (JAX ``precision="highest"``); the resampler's positions are JAX's
to the bit."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.ops import signal as jax_signal  # noqa: E402

from ptbxl_torch.ops import signal as port_signal  # noqa: E402
from ptbxl_torch.ops.signal import (  # noqa: E402
    _sinc_kernel,
    fir_bandpass,
    remove_baseline_wander,
    resample_linear,
)

FS = 500.0
TOL = 1e-5


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 1000, 12)) * rng.uniform(0.5, 2.5, (2, 1, 12))
            + rng.standard_normal((2, 1, 12))).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("fir_bandpass", ()),
    ("fir_bandpass", (5.0, 40.0, FS, 100)),  # even taps round up to 101
    ("fir_bandpass", (0.0, 40.0, FS, 51)),   # pure lowpass, DC gain normalized
    ("remove_baseline_wander", ()),
    ("remove_baseline_wander", (FS, 0.8)),
    ("resample_linear", (FS, 100.0)),
    ("resample_linear", (FS, 360.0)),
    ("resample_linear", (FS, 1000.0)),
], ids=lambda v: str(v))
def test_matches_jax(x, name, args):
    want = np.asarray(getattr(jax_signal, name)(jnp.asarray(x), *args))
    got = getattr(port_signal, name)(torch.from_numpy(x), *args).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_sinc_kernel_is_the_jax_one():
    for args in ((0.5, 40.0, FS, 101), (5.0, 40.0, FS, 501), (0.0, 40.0, FS, 51)):
        np.testing.assert_array_equal(_sinc_kernel(*args), jax_signal._sinc_kernel(*args))
    with pytest.raises(ValueError, match="band edges"):
        _sinc_kernel(40.0, 5.0, FS, 101)


def _tone(freq, t=6.0, fs=FS):
    ts = np.arange(int(t * fs)) / fs
    return np.sin(2 * np.pi * freq * ts).astype(np.float32)


def test_bandpass_attenuates_out_of_band():
    # 5-40 Hz band with 501 taps -> ~4 Hz transition width at fs=500
    x = np.stack([_tone(0.3), _tone(15.0), _tone(120.0)], axis=-1)[None]  # [1, T, 3]
    y = fir_bandpass(torch.from_numpy(x), 5.0, 40.0, FS, num_taps=501).numpy()
    m = y[0, 500:-500]  # ignore edges
    rms = np.sqrt((m**2).mean(axis=0))
    assert rms[1] > 0.6  # mid passes
    assert rms[0] < 0.1 and rms[2] < 0.1  # out-of-band attenuated


def test_baseline_wander_removal():
    x = (_tone(0.2) * 2.0 + _tone(8.0) * 0.5)[None, :, None]
    y = remove_baseline_wander(torch.from_numpy(x), FS, window_s=0.8).numpy()
    m = y[0, 400:-400, 0]
    # drift mostly removed: residual power far below input drift power
    assert np.sqrt((m**2).mean()) < 0.8
    assert abs(m.mean()) < 0.05


def test_resample_shapes_and_values():
    x = np.linspace(0, 1, 500, dtype=np.float32)[None, :, None]
    y = resample_linear(torch.from_numpy(x), 500.0, 100.0).numpy()
    assert y.shape == (1, 100, 1)
    np.testing.assert_allclose(y[0, :, 0], np.linspace(0, 1, 100), atol=1e-2)
