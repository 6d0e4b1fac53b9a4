"""K3 (ptbxl_torch/ops/kernels/fused_ecgcnn.py, fused_multimodal_*): the plain version
vs the Pallas kernel.

The JAX kernel runs in interpret mode on the CPU, as tests/test_predictor.py:67-83
runs it.  The CUDA kernel is held against the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.models.factory import build_multimodal as jax_build_multimodal  # noqa: E402
from ptbxl_tpu.models.params_io import load_npz as jax_load_npz  # noqa: E402
from ptbxl_tpu.ops.pallas.fused_ecgcnn import (  # noqa: E402
    fold_multimodal as jax_fold_multimodal,
    fused_multimodal_probs as jax_mm_probs,
)
from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch as jax_zscore  # noqa: E402

from ptbxl_torch.models.params_io import from_flax_variables, load_checkpoint  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k  # noqa: E402
from tests.torch_port_common import CKPT_MM, golden, mm_demo_pack  # noqa: E402

TOL = 2e-5  # probs, f32 (test_predictor.py:83)
BF16_TOL = 5e-3  # bench gate of bf16 compute


@pytest.fixture(scope="module")
def models():
    _, variables = jax_build_multimodal(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return (jax_fold_multimodal(variables),
            k.fold_multimodal(from_flax_variables(variables, "multimodal")))


def _inputs(seed, b, t):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, 12)) * 2 + 0.5).astype(np.float32)
    d = np.stack([rng.uniform(0.6, 0.9, b), np.full(b, 0.5), rng.uniform(0, 0.8, b),
                  rng.uniform(0, 0.45, b), np.zeros(b)], axis=1).astype(np.float32)
    return x, d


def _pallas(jf, x, d, **kw):
    return np.asarray(jax_mm_probs(jnp.asarray(x), jnp.asarray(d), jf, interpret=True, **kw))


def _plain(tf, x, d, **kw):
    return torch.sigmoid(k.fused_multimodal_logits_plain(torch.from_numpy(x),
                                                         torch.from_numpy(d), tf, **kw)).numpy()


def test_fold_multimodal_matches_jax():
    """fold_multimodal (fused_ecgcnn.py:224) from the reference-layout state dict."""
    variables, _ = jax_load_npz(CKPT_MM)
    want = jax_fold_multimodal(variables)
    state, _ = load_checkpoint(CKPT_MM, arch="multimodal")
    got = k.fold_multimodal(state)
    assert set(got) == set(want) and got["n_blocks"] == 4
    for key, v in want.items():
        if key == "n_blocks":
            continue
        assert tuple(got[key].shape) == tuple(v.shape), key
        assert got[key].dtype == torch.float32 and got[key].is_contiguous(), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(v), atol=1e-6, err_msg=key)


@pytest.mark.parametrize("normalize", [True, False])
def test_plain_matches_pallas_interpret(models, normalize):
    """test_predictor.py:67 (fused multimodal kernel in interpret mode) on a random model."""
    jf, tf = models
    x, d = _inputs(0, 2, 512)
    if not normalize:
        x = np.array(jax_zscore(jnp.asarray(x)))
    want = _pallas(jf, x, d, normalize=normalize)
    np.testing.assert_allclose(_plain(tf, x, d, normalize=normalize), want, atol=TOL)


def test_plain_odd_pool_floor(models):
    """T=500 -> 250 -> 125 -> 62 (odd floor in a middle block) -> 31."""
    jf, tf = models
    x, d = _inputs(1, 2, 500)
    np.testing.assert_allclose(_plain(tf, x, d), _pallas(jf, x, d), atol=TOL)


def test_plain_bf16_compute_matches_pallas_interpret(models):
    """bf16 operands of every product (_dot1), f32 sums on both sides."""
    jf, tf = models
    x, d = _inputs(2, 2, 512)
    want = _pallas(jf, x, d, compute_dtype=jnp.bfloat16)
    got = _plain(tf, x, d, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=BF16_TOL)


def test_golden_checkpoint_through_plain_k3():
    """Folded reference weights reproduce the golden probs (the demo pack is
    pre-normalized, so normalize=False; test_predictor.py:67-83)."""
    state, _ = load_checkpoint(CKPT_MM, arch="multimodal")
    folded = k.fold_multimodal(state)
    sigs, demos = mm_demo_pack()
    probs = k.fused_multimodal_probs(torch.from_numpy(sigs.transpose(0, 2, 1).copy()),
                                     torch.from_numpy(demos), folded, normalize=False).numpy()
    np.testing.assert_allclose(probs, golden("multimodal")["probs"], atol=1e-4)


def test_cpu_wrapper_dispatches_to_plain(models):
    _, tf = models
    x, d = (torch.from_numpy(a) for a in _inputs(3, 2, 256))
    before = (k.launches, k.launches_mm)
    got = k.fused_multimodal_probs(x, d, tf)
    want = torch.sigmoid(k.fused_multimodal_logits_plain(x, d, tf))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (k.launches, k.launches_mm) == before


def test_kernel_path_rejects_non_cuda(models):
    _, tf = models
    x = torch.zeros(1, 64, 12, device="meta")
    d = torch.zeros(1, 5, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        k.fused_multimodal_logits(x, d, tf)


def test_more_than_128_labels_raise(models):
    """The TPU kernel's num_labels <= 128 check (fused_ecgcnn.py:298-299)."""
    _, tf = models
    wide = dict(tf, head_w=torch.zeros(256, 129), head_b=torch.zeros(129))
    x, d = (torch.from_numpy(a) for a in _inputs(4, 1, 64))
    with pytest.raises(ValueError, match="num_labels <= 128"):
        k.fused_multimodal_logits(x, d, wide)
