"""K2/K3's f32 conv block on the tensor cores (3xTF32, ptbxl_torch/csrc/fused_ecgcnn.cu):
its split weights, and its arithmetic emulated on the CPU against the Pallas kernels.

The card's kernel splits each f32 operand as ``big = tf32(a)``, ``small =
tf32(a - big)`` (the weights once, in ``prepare_weights``; the input in
registers) and takes each product as ``small*big + big*small + big*big`` with
f32 sums.  ``_emulated_*`` below computes that here, from the prepared weights,
and holds the ECGCNN's and the multimodal model's probs within the f32 gate
(2e-5, tests/test_pallas_kernels.py:59 and tests/test_predictor.py:83) of the
JAX kernels in interpret mode.  The CUDA kernel itself is held against the
exact-f32 plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.models.factory import build_multimodal as jax_build_multimodal  # noqa: E402
from ptbxl_tpu.ops.pallas.fused_ecgcnn import (  # noqa: E402
    fold_bn_into_conv as jax_fold,
    fold_multimodal as jax_fold_multimodal,
    fused_ecgcnn_probs as jax_fused_probs,
    fused_multimodal_probs as jax_mm_probs,
)
from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch as jax_zscore  # noqa: E402

from ptbxl_torch.models.params_io import from_flax_variables, load_checkpoint  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2  # noqa: E402
from ptbxl_torch.ops.kernels.probes import tf32_round  # noqa: E402
from ptbxl_torch.ops.kernels.zscore import zscore_plain  # noqa: E402
from tests.torch_port_common import CKPT  # noqa: E402

TOL = 2e-5  # probs, f32
K, PAD = k2.K, k2.PAD


@pytest.fixture(scope="module")
def ecgcnn():
    _, variables = jax_build_ecgcnn(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return jax_fold(variables), k2.fold_bn_into_conv(from_flax_variables(variables))


@pytest.fixture(scope="module")
def multimodal():
    _, variables = jax_build_multimodal(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return (jax_fold_multimodal(variables),
            k2.fold_multimodal(from_flax_variables(variables, "multimodal")))


def _x(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)


def _demo(seed, b):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.6, 0.9, b), np.full(b, 0.5), rng.uniform(0, 0.8, b),
                     rng.uniform(0, 0.45, b), np.zeros(b)], axis=1).astype(np.float32)


def _is_tf32(v: torch.Tensor) -> bool:
    return not (v.view(torch.int32) & 0x1FFF).any()


# -- (a) the prepared weights --------------------------------------------------------

def _check_split_weight(w: torch.Tensor, w3: torch.Tensor) -> None:
    k, cin, cout = w.shape
    cin_p = -(-cin // 8) * 8
    assert tuple(w3.shape) == (2, cout, k * cin_p)
    assert w3.dtype == torch.float32 and w3.is_contiguous()
    big, small = w3.view(2, cout, k, cin_p).permute(0, 2, 3, 1)  # each [K, CinP, Cout]
    assert not big[:, cin:].any() and not small[:, cin:].any()  # padded channels are zero
    assert _is_tf32(big) and _is_tf32(small)
    torch.testing.assert_close(big[:, :cin], tf32_round(w), rtol=0, atol=0)
    err = (w - (big[:, :cin] + small[:, :cin])).abs()
    assert bool((err <= 2.0 ** -21 * w.abs()).all()), float((err / w.abs().clamp_min(1e-30)).max())


@pytest.mark.parametrize("block", [0, 1, 2, 3])
def test_prepare_weights_layout_padding_and_split(block):
    """The checkpoint's folded weights: [2, Cout, 15*CinP], column k*CinP + c,
    Cin padded to a multiple of 8 with zeros (12 -> 16), big and small TF32
    values (13 low bits zero), |w - (big + small)| <= 2^-21 |w|."""
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv(state)
    weights = k2.prepare_weights(folded)
    assert len(weights) == folded["n_blocks"] == 4
    _check_split_weight(folded[f"w{block}"], weights[block])
    assert weights[block].shape[2] == K * (16 if block == 0 else folded[f"w{block}"].shape[1])


@pytest.mark.parametrize("cin", [1, 8, 12, 20])
def test_tf32x3_weight_pads_to_multiples_of_8(cin):
    rng = np.random.default_rng(cin)
    mags = 10.0 ** rng.uniform(-3, 2, (K, cin, 32))
    w = torch.from_numpy((rng.standard_normal((K, cin, 32)) * mags).astype(np.float32))
    _check_split_weight(w, k2.tf32x3_weight(w))


def test_conv_block_rejects_bad_weights():
    x = torch.zeros(1, 64, 12)
    w3 = k2.tf32x3_weight(torch.zeros(K, 12, 32))
    with pytest.raises(ValueError, match="w3"):
        k2.conv_block_tf32x3(x, w3[:, :, :-8].contiguous(), torch.zeros(32))
    with pytest.raises(ValueError, match="stats"):
        k2.conv_block_tf32x3(x, w3, torch.zeros(32), stats=torch.zeros(1, 12))


# -- (b) the kernel's arithmetic, emulated ---------------------------------------------

def _emulated_block(h: torch.Tensor, w3: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h [B, T, Cin] (normalized) -> pool(relu(conv_SAME + b)) [B, T//2, Cout] as the
    kernel computes it: zero halo and channels, the input split like the weights,
    small*big + big*small + big*big per product (each exact in f32), f32 sums."""
    t, cin = h.shape[1], h.shape[2]
    cout, cin_p = w3.shape[1], w3.shape[2] // K
    hp = F.pad(h, (0, cin_p - cin, PAD, PAD))
    xb = tf32_round(hp)
    xs = tf32_round(hp - xb)
    wb, ws = (p.view(cout, K, cin_p) for p in w3)
    acc = torch.zeros(h.shape[0], t, cout)
    for k in range(K):
        a_b, a_s = xb[:, k:k + t], xs[:, k:k + t]
        acc = acc + a_s @ wb[:, k].T + a_b @ ws[:, k].T + a_b @ wb[:, k].T
    y = torch.relu(acc + b)
    half = t // 2
    return y[:, :2 * half].reshape(y.shape[0], half, 2, -1).amax(dim=2)


def _emulated_z_ecg(x: torch.Tensor, folded, weights, normalize: bool) -> torch.Tensor:
    h = zscore_plain(x) if normalize else x
    for i, w3 in enumerate(weights):
        h = _emulated_block(h, w3, folded[f"b{i}"])
    g = h.mean(dim=1)
    return g @ folded["proj_w"] + folded["proj_b"]


def _emulated_ecgcnn_probs(x, folded, normalize=True) -> np.ndarray:
    z = _emulated_z_ecg(torch.from_numpy(x), folded, k2.prepare_weights(folded), normalize)
    return torch.sigmoid(z @ folded["head_w"] + folded["head_b"]).numpy()


def _emulated_mm_probs(x, d, folded, normalize=True) -> np.ndarray:
    z_ecg = _emulated_z_ecg(torch.from_numpy(x), folded, k2.prepare_weights(folded), normalize)
    h1 = torch.relu(torch.from_numpy(d) @ folded["fc1_w"] + folded["fc1_b"])
    h2 = torch.relu(h1 @ folded["fc2_w"] + folded["fc2_b"])
    film = h2 @ folded["film_w"] + folded["film_b"]
    feat = z_ecg.shape[1]
    z = (1.0 + torch.tanh(film[:, :feat])) * z_ecg + film[:, feat:]
    return torch.sigmoid(z @ folded["head_w"] + folded["head_b"]).numpy()


CASES = {"2x512": (0, (2, 512, 12), True), "2x512 pre-normalized": (1, (2, 512, 12), False),
         "1x500 odd floors": (2, (1, 500, 12), True)}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_ecgcnn_matches_pallas_interpret(ecgcnn, case):
    jf, tf = ecgcnn
    seed, shape, normalize = CASES[case]
    x = _x(seed, shape)
    if not normalize:
        x = np.array(jax_zscore(jnp.asarray(x)))
    want = np.asarray(jax_fused_probs(jnp.asarray(x), jf, normalize=normalize, interpret=True))
    np.testing.assert_allclose(_emulated_ecgcnn_probs(x, tf, normalize), want, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_multimodal_matches_pallas_interpret(multimodal, case):
    jf, tf = multimodal
    seed, shape, normalize = CASES[case]
    x, d = _x(seed + 10, shape), _demo(seed + 10, shape[0])
    if not normalize:
        x = np.array(jax_zscore(jnp.asarray(x)))
    want = np.asarray(jax_mm_probs(jnp.asarray(x), jnp.asarray(d), jf, normalize=normalize,
                                   interpret=True))
    np.testing.assert_allclose(_emulated_mm_probs(x, d, tf, normalize), want, atol=TOL)


def test_emulated_block_matches_exact_f32():
    """At the checkpoint's widest block (128 -> 256) on activations of its scale, one
    emulated block stays within 2^-20 of the largest |x|*|w| sum of the exact f32
    block (k2._conv_block_plain, TF32 off)."""
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv(state)
    w, b = folded["w3"], folded["b3"]
    h = torch.from_numpy(np.abs(_x(5, (2, 96, 128))))
    got = _emulated_block(h, k2.tf32x3_weight(w), b)
    hp = F.pad(h, (0, 0, PAD, PAD))
    want = k2._conv_block_plain(hp, w, b, torch.float32)
    scale = float(k2._conv_block_plain(hp.abs(), w.abs(), torch.zeros_like(b), torch.float32).max())
    assert float((got - want).abs().max()) <= 2.0 ** -20 * scale


@pytest.mark.parametrize("zscore", [True, False])
def test_conv_block_on_cpu_takes_plain_version(zscore):
    """A CPU tensor takes ``conv_block_tf32x3_plain``: block 0 (Cin 12 padded to 16)
    with the z-score from ``zscore_stats`` on load, or without, equals the exact-f32
    block on ``w`` within 2^-20 of its largest |x|*|w| sum (w vs big + small)."""
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv(state)
    w, b = folded["w0"], folded["b0"]
    x = torch.from_numpy(_x(6, (2, 101, 12)))
    stats = k2.zscore_stats(x) if zscore else None
    got = k2.conv_block_tf32x3(x, k2.tf32x3_weight(w), b, stats)
    hp = F.pad(zscore_plain(x) if zscore else x, (0, 0, PAD, PAD))
    want = k2._conv_block_plain(hp, w, b, torch.float32)
    scale = float(k2._conv_block_plain(hp.abs(), w.abs(), torch.zeros_like(b), torch.float32).max())
    assert got.shape == (2, 50, 32)
    assert float((got - want).abs().max()) <= 2.0 ** -20 * scale
