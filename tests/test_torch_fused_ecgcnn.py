"""K2 (ptbxl_torch/ops/kernels/fused_ecgcnn.py): the plain version vs the Pallas kernel.

The JAX kernel runs in interpret mode on the CPU, as tests/test_pallas_kernels.py
runs it.  The CUDA kernels are held against the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.ops.pallas.fused_ecgcnn import (  # noqa: E402
    fold_bn_into_conv as jax_fold,
    fused_ecgcnn_probs as jax_fused_probs,
)
from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch as jax_zscore  # noqa: E402

from ptbxl_torch.models.params_io import from_flax_variables, load_checkpoint  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2  # noqa: E402
from tests.torch_port_common import CKPT, demo_signals, golden  # noqa: E402

TOL = 2e-5  # probs, f32 (test_pallas_kernels.py:59)


@pytest.fixture(scope="module")
def models():
    _, variables = jax_build_ecgcnn(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return jax_fold(variables), k2.fold_bn_into_conv(from_flax_variables(variables))


def _x(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2).astype(np.float32)


@pytest.mark.parametrize("normalize", [True, False])
def test_plain_matches_pallas_interpret(models, normalize):
    jf, tf = models
    x = _x(0, (2, 512, 12))
    if not normalize:
        x = np.array(jax_zscore(jnp.asarray(x)))
    want = np.asarray(jax_fused_probs(jnp.asarray(x), jf, normalize=normalize, interpret=True))
    got = torch.sigmoid(k2.fused_ecgcnn_logits_plain(torch.from_numpy(x), tf,
                                                     normalize=normalize)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_plain_odd_pool_floor(models):
    """T=500 -> 250 -> 125 -> 62 (odd floor in a middle block) -> 31."""
    jf, tf = models
    x = _x(1, (1, 500, 12))
    want = np.asarray(jax_fused_probs(jnp.asarray(x), jf, interpret=True))
    got = torch.sigmoid(k2.fused_ecgcnn_logits_plain(torch.from_numpy(x), tf)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_plain_bf16_compute_matches_pallas_interpret(models):
    """bf16 operands, f32 sums on both sides; sums in another order, so the
    bench's bf16 gate (5e-3) is the tolerance."""
    jf, tf = models
    x = _x(2, (2, 512, 12))
    want = np.asarray(jax_fused_probs(jnp.asarray(x), jf, compute_dtype=jnp.bfloat16,
                                      interpret=True))
    got = torch.sigmoid(k2.fused_ecgcnn_logits_plain(
        torch.from_numpy(x), tf, compute_dtype=torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_cpu_wrapper_dispatches_to_plain(models):
    _, tf = models
    x = torch.from_numpy(_x(3, (2, 256, 12)))
    before = k2.launches
    got = k2.fused_ecgcnn_probs(x, tf)
    want = torch.sigmoid(k2.fused_ecgcnn_logits_plain(x, tf))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert k2.launches == before


def test_golden_checkpoint_through_plain_k2():
    """Folded reference weights reproduce the golden probs (demo pack is
    pre-normalized, so normalize=False; test_pallas_kernels.py:113)."""
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv(state)
    x = torch.from_numpy(demo_signals().transpose(0, 2, 1).copy())
    probs = k2.fused_ecgcnn_probs(x, folded, normalize=False).numpy()
    np.testing.assert_allclose(probs, golden("baseline")["probs"], atol=1e-4)


def test_kernel_path_rejects_non_cuda(models):
    _, tf = models
    x = torch.zeros(1, 64, 12, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        k2.fused_ecgcnn_logits(x, tf)
