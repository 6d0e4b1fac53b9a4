"""K1 (ptbxl_torch/ops/kernels/zscore.py) and the framework z-score forms vs JAX.

On the CPU the kernel wrapper runs its plain version; the CUDA kernel itself
is held against that plain version on the card by chip_smoke.py.
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.ops.pallas.zscore import zscore_pallas  # noqa: E402
from ptbxl_tpu.ops.preprocess import (  # noqa: E402
    zscore_per_lead_batch as jax_zscore,
    zscore_per_lead_batch_onepass as jax_zscore_onepass,
)

from ptbxl_torch.ops.kernels import _build  # noqa: E402
from ptbxl_torch.ops.kernels import zscore as k1  # noqa: E402
from ptbxl_torch.ops.preprocess import (  # noqa: E402
    zscore_per_lead_batch,
    zscore_per_lead_batch_onepass,
)

TOL = 1e-5      # f32, sums in another order (test_pallas_kernels.py:29)
TOL_BF16 = 2e-2  # bf16 output rounding (test_pallas_kernels.py:45)


def _raw(seed, shape=(3, 256, 12)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 4 + 2).astype(np.float32)


def _advice_case():
    """ADVICE.md: one lead with std ~1e-4 on a DC offset of ~40 (preprocess.py:45)."""
    x = _raw(7, (2, 5000, 12))
    rng = np.random.default_rng(8)
    x[:, :, 3] = 40.0 + 1e-4 * rng.standard_normal((2, 5000)).astype(np.float32)
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k1_matches_pallas_interpret(seed):
    x = _raw(seed)
    want = np.asarray(zscore_pallas(jnp.asarray(x), interpret=True))
    got = k1.zscore_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_plain_k1_matches_xla_reference():
    x = _raw(2)
    want = np.asarray(jax_zscore(jnp.asarray(x)))
    np.testing.assert_allclose(k1.zscore_plain(torch.from_numpy(x)).numpy(), want, atol=TOL)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_plain_k1_bf16_out(in_dtype):
    x = _raw(3)
    want = np.asarray(jax_zscore(jnp.asarray(x)))
    xt = torch.from_numpy(x).to(in_dtype)
    got = k1.zscore_plain(xt, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_BF16)
    # out dtype defaults to the input's
    assert k1.zscore_plain(xt).dtype == in_dtype


def test_jax_bf16_pallas_matches_plain_k1_bf16():
    x = _raw(4)
    want = zscore_pallas(jnp.asarray(x).astype(jnp.bfloat16), interpret=True)
    assert want.dtype == jnp.bfloat16
    got = k1.zscore_plain(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL_BF16)


def test_stats_match_two_pass_moments():
    x = _raw(5)
    st = k1.zscore_stats_plain(torch.from_numpy(x)).numpy()
    assert st.shape == (3, 12, 2)
    np.testing.assert_allclose(st[..., 0], x.mean(axis=1), atol=1e-5)
    np.testing.assert_allclose(st[..., 1], x.std(axis=1) + 1e-6, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(_raw(6))
    before = k1.launches
    torch.testing.assert_close(k1.zscore(x), k1.zscore_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(k1.zscore_stats(x), k1.zscore_stats_plain(x), rtol=0, atol=0)
    assert k1.launches == before  # the counter moves only for kernel launches


@pytest.mark.parametrize("name", ["two_pass", "advice_case"])
def test_framework_two_pass_matches_jax(name):
    x = _raw(9) if name == "two_pass" else _advice_case()
    want = np.asarray(jax_zscore(jnp.asarray(x)))
    got = zscore_per_lead_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("name", ["one_pass", "advice_case"])
def test_framework_one_pass_matches_jax(name):
    """Matches the JAX one-pass form, its loss of precision on the ADVICE case included."""
    x = _raw(10) if name == "one_pass" else _advice_case()
    want = np.asarray(jax_zscore_onepass(jnp.asarray(x)))
    got = zscore_per_lead_batch_onepass(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: a build without nvcc raises instead of using the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def _defined_names(src: str) -> set:
    """The functions (a name, its parameters, a body) and structs a CUDA
    source defines."""
    funcs = re.findall(r'^\s*(?:extern\s+"C"\s+)?(?:template\s*<[^>]*>\s*)?(?:[\w:<>]+[\s*&]+)+'
                       r'(\w+)\s*\([^;{}]*\)\s*\{', src, re.M)
    return set(funcs) | set(re.findall(r"^\s*struct\s+(\w+)", src, re.M))


def test_every_kernel_source_takes_the_helpers_from_the_header():
    """Each ``csrc/*.cu`` includes ``hopper.cuh`` and defines none of its
    names (the PTX helpers, the device guard, ``ptbxl_strerror``), and no
    source but the header sets the device."""
    header = (_build.CSRC / "hopper.cuh").read_text()
    names = _defined_names(header)
    assert {"mbar_wait", "bulk_load", "wg_wait", "WgmmaTf32", "ptbxl_ensure_device",
            "ptbxl_strerror"} <= names
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert {s.stem for s in sources} == {"conv_wgrad", "fused_ecgcnn", "hybrid_wgmma", "probes",
                                         "relu_pool", "zscore"}
    for s in sources:
        src = s.read_text()
        assert '#include "hopper.cuh"' in src, s.name
        assert not _defined_names(src) & names, (s.name, _defined_names(src) & names)
        assert "cudaSetDevice" not in src, s.name


def test_build_key_follows_the_header(tmp_path, monkeypatch):
    """A change to the header alone gives every library a new build key, so
    each source is rebuilt against it; an unchanged tree keeps its key."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.glob("*.cu*"):
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    key = _build._key()
    assert _build._key() == key
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// one more line\n")
    assert _build._key() != key
