"""K5 (``zscore_wide`` in ptbxl_torch/ops/kernels/zscore.py) vs the Pallas wide z-score.

The JAX kernel runs in interpret mode on the CPU, as tests/test_pallas_kernels.py
runs it; on the CPU the port's wrapper takes its plain version.  The CUDA
kernel is held against that plain version, and against K1, on the card by
chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.ops.pallas.zscore import zscore_pallas_wide  # noqa: E402
from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch as jax_zscore  # noqa: E402

from ptbxl_torch.ops.kernels import zscore as kz  # noqa: E402

TOL = 1e-5       # f32, sums in another order (test_pallas_kernels.py:40)
TOL_BF16 = 2e-2  # bf16 output rounding (test_pallas_kernels.py:45)


def _raw(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 4 + 2).astype(np.float32)


def test_f32_matches_pallas_interpret():
    """width 36, block_b 2, B=5 (one padded record), T=240 (test_pallas_kernels.py:32)."""
    x = _raw(0, (5, 240, 12))
    want = np.asarray(zscore_pallas_wide(jnp.asarray(x), width=36, block_b=2, interpret=True))
    got = kz.zscore_wide(torch.from_numpy(x), width=36, block_b=2)
    assert got.dtype == torch.float32 and got.shape == (5, 240, 12)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_bf16_out_matches_pallas_interpret():
    x = _raw(1, (5, 240, 12))
    want = zscore_pallas_wide(jnp.asarray(x), out_dtype=jnp.bfloat16, width=36, block_b=2,
                              interpret=True)
    got = kz.zscore_wide(torch.from_numpy(x), out_dtype=torch.bfloat16, width=36, block_b=2)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL_BF16)


def test_bf16_in_keeps_its_dtype():
    x = _raw(2, (3, 240, 12))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = zscore_pallas_wide(jnp.asarray(x).astype(jnp.bfloat16), width=36, block_b=2,
                              interpret=True)
    got = kz.zscore_wide(xt, width=36, block_b=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL_BF16)


def test_full_length_default_width():
    """The default width 480 on full-length records, B=3 with block_b=2."""
    x = _raw(3, (3, 5000, 12))
    want = np.asarray(zscore_pallas_wide(jnp.asarray(x), block_b=2, interpret=True))
    got = kz.zscore_wide(torch.from_numpy(x), block_b=2).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("width", [36, 240, 480, 1200])
def test_same_function_as_k1(width):
    """Every width computes K1's z-score: the same f64 totals, rounded to f32 alike."""
    t = 240 if width == 36 else 5000
    x = torch.from_numpy(_raw(4, (3, t, 12)))
    torch.testing.assert_close(kz.zscore_wide(x, width=width, block_b=2), kz.zscore_plain(x),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("width", [35, 30, 0])
def test_bad_width_raises(width):
    """35 does not divide T*C = 2880; 30 divides it but is no multiple of C = 12."""
    x = _raw(5, (2, 240, 12))
    if width:
        with pytest.raises(ValueError, match="width"):
            zscore_pallas_wide(jnp.asarray(x), width=width, interpret=True)
    with pytest.raises(ValueError, match="width"):
        kz.zscore_wide(torch.from_numpy(x), width=width)


def test_bad_block_b_raises():
    with pytest.raises(ValueError, match="block_b"):
        kz.zscore_wide(torch.zeros(2, 240, 12), width=36, block_b=0)


def test_near_constant_lead():
    """ADVICE.md: lead 3 at a DC offset of 40 with std 1e-4.  The port's f64
    totals keep the two-pass reference's answer there (1e-5); the TPU kernel's
    f32 fold by a [W, W] product does not, so on that lead the port is held to
    the XLA two-pass form, and on the other leads to the Pallas kernel."""
    x = _raw(7, (2, 5000, 12))
    x[:, :, 3] = 40.0 + 1e-4 * np.random.default_rng(8).standard_normal((2, 5000)).astype(np.float32)
    got = kz.zscore_wide(torch.from_numpy(x), block_b=2).numpy()
    two_pass = np.asarray(jax_zscore(jnp.asarray(x)))
    pallas = np.asarray(zscore_pallas_wide(jnp.asarray(x), block_b=2, interpret=True))
    np.testing.assert_allclose(got, two_pass, atol=TOL)
    others = [c for c in range(12) if c != 3]
    np.testing.assert_allclose(got[..., others], pallas[..., others], atol=TOL)


def test_cpu_wrapper_dispatches_to_plain():
    x = torch.from_numpy(_raw(9, (3, 240, 12)))
    before = kz.launches_wide
    torch.testing.assert_close(kz.zscore_wide(x, width=36), kz.zscore_wide_plain(x, width=36),
                               rtol=0, atol=0)
    assert kz.launches_wide == before  # the counter moves only for kernel launches


def test_kernel_path_rejects_non_cuda():
    x = torch.zeros(2, 240, 12, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kz.zscore_wide(x, width=36)


def test_probe_variants_and_bounds():
    """The port of tools/probe_zscore.py: its variants (the JAX probe's standalone
    half) and bytes bounds; bf16 in and out at BS=11264 is 2.70 GB, 0.807 ms
    at the H100's 3.35 TB/s."""
    from ptbxl_torch.tools import probe_zscore

    assert list(probe_zscore.variants()) == [
        "torch_two_pass", "torch_one_pass", "k1", "k5_b4", "k5_b8", "k5_b16", "k5_w240",
        "k5_w1200"]
    x = torch.empty((11264, 5000, 12), dtype=torch.bfloat16, device="meta")
    assert probe_zscore.bound_ms(x, torch.bfloat16) == pytest.approx(0.80697, rel=1e-4)


def test_probe_run_on_the_host():
    """``run`` at B=2 on the CPU (host clocks): every variant normalizes the batch."""
    from ptbxl_torch.tools import probe_zscore

    batch = probe_zscore.make_batch(2, torch.device("cpu"))
    rows = probe_zscore.run(batch, iters=1)
    assert [r["variant"] for r in rows] == list(probe_zscore.variants())
    want = kz.zscore_plain(batch.float())
    for name, fn in probe_zscore.variants().items():
        # bf16 out: its rounding; the f32 one-pass form: E[x^2] - E[x]^2 in f32
        tol = TOL_BF16 if fn(batch).dtype == torch.bfloat16 else 2e-3
        torch.testing.assert_close(fn(batch).float(), want, rtol=0, atol=tol, msg=name)
