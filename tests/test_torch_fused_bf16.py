"""K2's and K3's bf16 form (ptbxl_torch/ops/kernels/fused_ecgcnn.py): the card's
launch sequence, each launch in its plain version, vs the Pallas kernels.

In bf16 both run K4's launches: K1's stats, one ``wgmma`` conv block a block
(the last writing per-tile channel sums), then ``sums_tail`` (K2) or
``mm_sums_tail`` (K3).  On CPU tensors ``card_logits`` / ``card_mm_logits``
take each launch's plain version (``zscore_stats_plain``,
``wgmma_conv_block_plain`` with the kernel's tiling emulated,
``sums_tail_plain`` / ``mm_sums_tail_plain``).  The JAX kernels run in
interpret mode, as tests/test_pallas_kernels.py runs them.  The CUDA kernels
are held against these plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.models.factory import build_multimodal as jax_build_multimodal  # noqa: E402
from ptbxl_tpu.ops.pallas.fused_ecgcnn import (  # noqa: E402
    fold_bn_into_conv as jax_fold,
    fold_multimodal as jax_fold_multimodal,
    fused_ecgcnn_probs as jax_fused_probs,
    fused_multimodal_probs as jax_mm_probs,
)
from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch as jax_zscore  # noqa: E402

from ptbxl_torch.models.params_io import from_flax_variables  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2  # noqa: E402
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4  # noqa: E402

TOL = 2e-5       # probs, f32 (test_pallas_kernels.py:59)
TOL_BF16 = 5e-3  # probs, bf16 operands, sums in another order (test_torch_fused_ecgcnn.py:62)
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(scope="module")
def ecg():
    _, variables = jax_build_ecgcnn(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return jax_fold(variables), k2.fold_bn_into_conv(from_flax_variables(variables))


@pytest.fixture(scope="module")
def mm():
    _, variables = jax_build_multimodal(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return (jax_fold_multimodal(variables),
            k2.fold_multimodal(from_flax_variables(variables, "multimodal")))


def _inputs(seed, b, t, normalize=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, 12)) * 2 + 0.5).astype(np.float32)
    if not normalize:
        x = np.array(jax_zscore(jnp.asarray(x)))
    d = np.stack([rng.uniform(0.6, 0.9, b), np.full(b, 0.5), rng.uniform(0, 0.8, b),
                  rng.uniform(0, 0.45, b), np.zeros(b)], axis=1).astype(np.float32)
    return x, d


CASES = [(3, 512, True), (3, 512, False), (2, 500, True)]  # T=500: 250, 125, 62, 31


@pytest.mark.parametrize("b,t,normalize", CASES)
def test_k2_bf16_card_route_matches_pallas_interpret(ecg, b, t, normalize):
    jf, tf = ecg
    x, _ = _inputs(0, b, t, normalize)
    want = np.asarray(jax_fused_probs(jnp.asarray(x), jf, compute_dtype=jnp.bfloat16,
                                      normalize=normalize, interpret=True))
    xt = torch.from_numpy(x)
    got = torch.sigmoid(k2.card_logits(xt, tf, BF16, normalize,
                                       k4.prepare_weights(tf, BF16))).numpy()
    assert got.shape == (b, 5)
    np.testing.assert_allclose(got, want, atol=TOL_BF16)
    plain = torch.sigmoid(k2.fused_ecgcnn_logits_plain(xt, tf, BF16, normalize)).numpy()
    np.testing.assert_allclose(got, plain, atol=TOL_BF16)


@pytest.mark.parametrize("b,t,normalize", CASES)
def test_k3_bf16_card_route_matches_pallas_interpret(mm, b, t, normalize):
    jf, tf = mm
    x, d = _inputs(1, b, t, normalize)
    want = np.asarray(jax_mm_probs(jnp.asarray(x), jnp.asarray(d), jf, compute_dtype=jnp.bfloat16,
                                   normalize=normalize, interpret=True))
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    got = torch.sigmoid(k2.card_mm_logits(xt, dt, tf, BF16, normalize,
                                          k4.prepare_weights(tf, BF16))).numpy()
    assert got.shape == (b, 5)
    np.testing.assert_allclose(got, want, atol=TOL_BF16)
    plain = torch.sigmoid(k2.fused_multimodal_logits_plain(xt, dt, tf, BF16, normalize)).numpy()
    np.testing.assert_allclose(got, plain, atol=TOL_BF16)


def test_k3_f32_card_route_matches_pallas_interpret(mm):
    """The f32 sequence ``card_mm_logits`` keeps (3xTF32 blocks, K3's f32 tail)."""
    jf, tf = mm
    x, d = _inputs(2, 2, 512)
    want = np.asarray(jax_mm_probs(jnp.asarray(x), jnp.asarray(d), jf, interpret=True))
    got = torch.sigmoid(k2.card_mm_logits(torch.from_numpy(x), torch.from_numpy(d), tf,
                                          F32)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_k2_bf16_route_is_k4s(ecg):
    """K2's bf16 launches are K4's bf16 route, bit for bit (one sequence)."""
    _, tf = ecg
    x = torch.from_numpy(_inputs(3, 2, 256)[0])
    w = k4.prepare_weights(tf, BF16)
    assert torch.equal(k2.card_logits(x, tf, BF16, True, w),
                       k4.card_route_logits(x, tf, 2, BF16, True, w))


def test_mm_sums_tail_adds_tiles_in_order(mm):
    """The tail takes the tiles' sums in tile order, each times 1/T (the
    ones-mean of the pooled rows), then proj and K3's plain bf16 tail; the
    tolerance is test_torch_hybrid.py's sums tail's.  The CPU wrapper is the
    plain version bit for bit."""
    _, tf = mm
    rng = np.random.default_rng(12)
    h = torch.from_numpy(np.abs(rng.standard_normal((3, 312, 256)) * 2).astype(np.float32))
    d = torch.from_numpy(_inputs(4, 3, 16)[1])
    part = torch.stack([h[:, j * 64:(j + 1) * 64].sum(1) for j in range(5)], 1)
    got = k4.mm_sums_tail_plain(part, 312, tf, d)
    g = torch.einsum("t,btc->bc", torch.full((312,), 1 / 312), h)
    z_ecg = k2._dot1(g, tf["proj_w"], BF16) + tf["proj_b"]
    want = k2._mm_tail_plain(z_ecg, d, tf, BF16)
    assert got.shape == (3, 5)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)
    assert torch.equal(k4.mm_sums_tail(part, 312, tf, d), got)


@pytest.mark.parametrize("prepared,called", [(BF16, F32), (F32, BF16)])
def test_weights_for_another_dtype_raise(ecg, mm, prepared, called):
    x, d = torch.zeros(1, 256, 12), torch.zeros(1, 5)
    for tf in (ecg[1], mm[1]):
        for weights in (k4.prepare_weights(tf, prepared), k4.prepare_weights(tf, prepared)["blocks"]):
            with pytest.raises(ValueError, match="prepared for"):
                if "fc1_w" in tf:
                    k2.card_mm_logits(x, d, tf, called, True, weights)
                else:
                    k2.card_logits(x, tf, called, True, weights)
    with pytest.raises(ValueError, match="prepared for"):
        k2.fused_ecgcnn_logits(x.to("meta"), ecg[1], called,
                               weights=k4.prepare_weights(ecg[1], prepared))
    with pytest.raises(ValueError, match="prepared for"):
        k2.fused_multimodal_logits(x.to("meta"), d.to("meta"), mm[1], called,
                                   weights=k4.prepare_weights(mm[1], prepared))


def test_custom_op_params_carry_the_bf16_blocks(ecg):
    """The serving ops' flat tensor list carries the ``wgmma`` blocks, and the
    op body reads their dtype back from them."""
    _, tf = ecg
    w = k4.prepare_weights(tf, BF16)
    folded, weights = k2._op_unpack(k2._op_params(tf, w, k2._ECG_DENSE), 4, k2._ECG_DENSE)
    blocks = k2.block_weights(folded, BF16, weights)
    assert all(a is b for a, b in zip(blocks, w["blocks"])) and len(blocks) == 4
    with pytest.raises(ValueError, match="prepared for"):
        k2.block_weights(folded, F32, weights)
    with pytest.raises(ValueError, match="3 blocks"):
        k2.block_weights(folded, BF16, w["blocks"][:3])
