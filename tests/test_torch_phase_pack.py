"""The port's phase-packed front (ptbxl_torch/ops/phase_pack.py) against the
plain front it replaces (``hybrid_ecgcnn._front_plain``, the port's
``_xla_front``) and against ptbxl_tpu/ops/phase_pack.py.

Mirrors tests/test_phase_pack.py: the same random-init ECGCNN folded, f32,
at 1e-5, at t in {512, 400, 5000}; the packed weights equal JAX's.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.ops.phase_pack import phase_packed_front as jax_front  # noqa: E402
from ptbxl_tpu.ops.phase_pack import prepack_front as jax_prepack  # noqa: E402
from ptbxl_tpu.ops.pallas.fused_ecgcnn import fold_bn_into_conv as jax_fold  # noqa: E402

from ptbxl_torch.models.params_io import from_flax_variables  # noqa: E402
from ptbxl_torch.ops.kernels.fused_ecgcnn import fold_bn_into_conv  # noqa: E402
from ptbxl_torch.ops.kernels.hybrid_ecgcnn import _front_plain  # noqa: E402
from ptbxl_torch.ops.phase_pack import (  # noqa: E402
    pack_conv2_weights,
    phase_packed_front,
    prepack_front,
)
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch  # noqa: E402


@pytest.fixture(scope="module")
def weights():
    _, variables = jax_build_ecgcnn(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return jax_fold(variables), fold_bn_into_conv(from_flax_variables(variables))


def test_packed_weights_equal_jax(weights):
    jf, folded = weights
    got, want = prepack_front(folded), jax_prepack(jf)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    with pytest.raises(ValueError, match="mixed phase"):
        pack_conv2_weights(folded["w1"], folded["b1"], 2, 4)


@pytest.mark.parametrize("t", [512, 400, 5000])
def test_phase_packed_front_exact(t, weights):
    jf, folded = weights
    x = np.random.default_rng(t).standard_normal((2, t, 12)).astype(np.float32)
    xz = zscore_per_lead_batch(torch.from_numpy(x))
    got = phase_packed_front(xz, folded, torch.float32)
    want = _front_plain(xz, folded, 2, torch.float32)
    assert got.shape == want.shape == (2, t // 4, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    packed = jax_prepack(jf)
    jgot = jax_front(jnp.asarray(xz.numpy()), None, jnp.float32, packed=packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-5)
    # prepacked weights give the same tensor as packing on the call
    assert torch.equal(phase_packed_front(xz, None, torch.float32, prepack_front(folded)), got)


def test_phase_packed_front_bf16(weights):
    """bf16 operands, f32 sums: the plain front's arithmetic and JAX's
    ``preferred_element_type=f32``, within the bf16 gate (5e-3)."""
    jf, folded = weights
    x = np.random.default_rng(3).standard_normal((2, 512, 12)).astype(np.float32)
    xz = zscore_per_lead_batch(torch.from_numpy(x))
    got = phase_packed_front(xz, folded, torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), _front_plain(xz, folded, 2, torch.bfloat16).numpy(),
                               atol=5e-3)
    jgot = jax_front(jnp.asarray(xz.numpy()), None, jnp.bfloat16, packed=jax_prepack(jf))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=5e-3)
