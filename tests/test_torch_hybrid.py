"""K4 (ptbxl_torch/ops/kernels/hybrid_ecgcnn.py): the plain version vs the Pallas hybrid engine.

The JAX engine runs in interpret mode on the CPU, as tests/test_pallas_kernels.py
runs it; on the CPU the port's wrapper takes its plain version.  The CUDA
kernels are held against that plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.ops.pallas.fused_ecgcnn import fold_bn_into_conv as jax_fold  # noqa: E402
from ptbxl_tpu.ops.pallas.hybrid_ecgcnn import hybrid_ecgcnn_probs as jax_hybrid_probs  # noqa: E402
from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch as jax_zscore  # noqa: E402

from ptbxl_torch.models.params_io import from_flax_variables, load_checkpoint  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2  # noqa: E402
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4  # noqa: E402
from tests.torch_port_common import CKPT, demo_signals, golden  # noqa: E402

TOL = 2e-5       # probs, f32: sums in another order (test_pallas_kernels.py:91)
TOL_BF16 = 5e-3  # probs, bf16 operands: the bench's parity gate (test_pallas_kernels.py:96)
DTYPES = {"f32": (jnp.float32, torch.float32, TOL), "bf16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}


@pytest.fixture(scope="module")
def models():
    _, variables = jax_build_ecgcnn(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return jax_fold(variables), k2.fold_bn_into_conv(from_flax_variables(variables))


def _x(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2).astype(np.float32)


def _both(models, x, dtype="f32", block_b=8, **kw):
    """JAX's engine with its record tile ``block_b``, and the port's, which has none."""
    jf, tf = models
    jdt, tdt, tol = DTYPES[dtype]
    want = np.asarray(jax_hybrid_probs(jnp.asarray(x), jf, compute_dtype=jdt, interpret=True,
                                       block_b=block_b, **kw))
    got = k4.hybrid_ecgcnn_probs(torch.from_numpy(x), tf, tdt, **kw).numpy()
    return got, want, tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_probs_match_pallas_interpret(models, dtype):
    """T=512, B=3, block_b=2 (test_pallas_kernels.py:81-96); bf16 against JAX's bf16."""
    got, want, tol = _both(models, _x(0, (3, 512, 12)), dtype, block_b=2)
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, want, atol=tol)


def test_batch_padding_does_not_leak(models):
    """B=5 with JAX's block_b=4, which pads three zero records and slices them
    off (test_pallas_kernels.py:99); the port pads nothing and must agree."""
    got, want, tol = _both(models, _x(1, (5, 512, 12)), block_b=4)
    assert got.shape == (5, 5)
    np.testing.assert_allclose(got, want, atol=tol)


def test_odd_pool_floor(models):
    """T=400 -> 200 -> 100 -> 50 -> 25: the last deep block floors its pool."""
    got, want, tol = _both(models, _x(2, (2, 400, 12)), block_b=2)
    np.testing.assert_allclose(got, want, atol=tol)


def test_prenormalized_input(models):
    x = np.array(jax_zscore(jnp.asarray(_x(3, (2, 512, 12)))))
    got, want, tol = _both(models, x, normalize=False, block_b=2)
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_every_split(models, split, dtype):
    """split 1/2/3 of 4 blocks: deep blocks with Cin 32, 64 and 128, and the tail."""
    got, want, tol = _both(models, _x(4, (2, 512, 12)), dtype, split=split, block_b=2)
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("split", [0, 4, -1])
def test_split_out_of_range_raises(models, split):
    jf, tf = models
    x = _x(5, (1, 256, 12))
    with pytest.raises(ValueError, match="split"):
        jax_hybrid_probs(jnp.asarray(x), jf, interpret=True, split=split)
    with pytest.raises(ValueError, match="split"):
        k4.hybrid_ecgcnn_probs(torch.from_numpy(x), tf, split=split)


def test_golden_checkpoint_through_plain_k4():
    """Folded reference weights reproduce the golden probs through K4's plain
    version (the demo pack is pre-normalized, so normalize=False)."""
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv(state)
    x = torch.from_numpy(demo_signals().transpose(0, 2, 1).copy())
    probs = k4.hybrid_ecgcnn_probs(x, folded, torch.float32, normalize=False).numpy()
    np.testing.assert_allclose(probs, golden("baseline")["probs"], atol=1e-4)


def test_f32_matches_fused_forward(models):
    """In f32 the hybrid engine and K2 compute the same function (sums in another order)."""
    _, tf = models
    x = torch.from_numpy(_x(6, (3, 512, 12)))
    got = k4.hybrid_ecgcnn_probs(x, tf, torch.float32)
    want = torch.sigmoid(k2.fused_ecgcnn_logits_plain(x, tf))
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_cpu_wrapper_dispatches_to_plain(models):
    _, tf = models
    x = torch.from_numpy(_x(7, (2, 256, 12)))
    before = k4.launches
    got = k4.hybrid_ecgcnn_logits(x, tf, weights=k4.prepare_weights(tf))
    want = k4.hybrid_ecgcnn_logits_plain(x, tf)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert k4.launches == before  # the counter moves only for kernel launches


def test_kernel_path_rejects_non_cuda(models):
    _, tf = models
    x = torch.zeros(1, 256, 12, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        k4.hybrid_ecgcnn_logits(x, tf)


def test_too_many_labels_raises(models):
    _, tf = models
    wide = dict(tf, head_w=torch.zeros(tf["head_w"].shape[0], 129), head_b=torch.zeros(129))
    with pytest.raises(ValueError, match="num_labels"):
        k4.hybrid_ecgcnn_logits(torch.zeros(1, 256, 12), wide)


def test_tc_weight_pads_channels_to_16():
    """Cin=12 -> 16 zero channels, so no 16-wide reduction slice straddles two taps."""
    w = torch.from_numpy(np.random.default_rng(8).standard_normal((15, 12, 32), dtype=np.float32))
    wt = k4.tc_weight(w)
    assert wt.shape == (15, 16, 32) and wt.dtype == torch.bfloat16
    torch.testing.assert_close(wt[:, :12].float(), w.to(torch.bfloat16).float(), rtol=0, atol=0)
    assert not wt[:, 12:].any()


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_card_front_matches_plain_front(models, split, dtype):
    """The front as the card runs it (channels padded to 16, the pool before the
    bias, bf16 between front blocks) computes the plain front's function; run
    here on the CPU.  f32: sums in another order; bf16: the card's front
    rounds each conv output to bf16 once more, at most 2^-9 relative, on
    activations up to O(10)."""
    _, tf = models
    x = torch.from_numpy(_x(9, (2, 512, 12)))
    tdt = DTYPES[dtype][1]
    got = k4._front(x, tf, k4.prepare_weights(tf, split, tdt)["front"], tdt)
    want = k4._front_plain(x, tf, split, tdt)
    assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == want.shape
    atol = 1e-5 if dtype == "f32" else 0.05
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prepare_weights_layouts(models, split, dtype):
    """One front weight a front block ([Cout, CinP, 1, 15] channels-last, Cin
    padded to 16), and one tap weight a deep block (``tc_weight`` in bf16, K2's
    split ``tf32x3_weight`` in f32)."""
    _, tf = models
    tdt = DTYPES[dtype][1]
    wts = k4.prepare_weights(tf, split, tdt)
    assert (wts["split"], wts["dtype"]) == (split, tdt)
    assert len(wts["front"]) == split
    for i, wt in enumerate(wts["front"]):
        w = tf[f"w{i}"]
        cin_p = -(-w.shape[1] // 16) * 16
        assert wt.shape == (w.shape[2], cin_p, 1, 15) and wt.dtype == tdt
        assert wt.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(wt[:, :w.shape[1], 0].float(),
                                   w.permute(2, 1, 0).to(tdt).float(), rtol=0, atol=0)
    deep_weight = k4.tc_weight if dtype == "bf16" else k2.tf32x3_weight
    deep = [deep_weight(tf[f"w{i}"]) for i in range(split, 4)]
    assert len(wts["deep"]) == len(deep)
    for got, want in zip(wts["deep"], deep):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_weights_for_another_split_raise(models):
    _, tf = models
    x = torch.zeros(1, 256, 12, device="meta")
    with pytest.raises(ValueError, match="prepared for split=1"):
        k4.hybrid_ecgcnn_logits(x, tf, 2, weights=k4.prepare_weights(tf, 1))
