"""K2/K3's f32 conv block on Hopper's wgmma (3xTF32, ptbxl_torch/csrc/fused_ecgcnn.cu):
its split weights in wgmma's core-matrix order, its arithmetic emulated on the CPU
against the Pallas kernels, and the kernel itself on the card.

The card's kernel splits each f32 operand as ``big = tf32(a)``, ``small =
tf32(a - big)`` (the weights once, in ``prepare_weights``; the input in
registers) and takes each product as ``small*big + big*small + big*big``, in
sums that restart at every weight stage and are added up in f32.
``_emulated_*`` below computes that here, from the prepared weights, stage by
stage, and holds the ECGCNN's and the multimodal model's probs within the f32
gate (2e-5, tests/test_pallas_kernels.py:59 and tests/test_predictor.py:83)
of the JAX kernels in interpret mode.  JAX is imported by the fixtures that
need it, so the ``card`` tests below (each block against the exact-f32 plain
block on the H100) run where JAX is not installed.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from ptbxl_torch.models.params_io import from_flax_variables, load_checkpoint  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2  # noqa: E402
from ptbxl_torch.ops.kernels.probes import tf32_round  # noqa: E402
from ptbxl_torch.ops.kernels.zscore import zscore_plain  # noqa: E402
from ptbxl_torch.utils.device import highest_precision  # noqa: E402

# the checkpoint's path here, not from tests/: the card tests run with --noconftest
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "outputs/ecg_baseline/ckpts/ecg_baseline_best.npz")
TOL = 2e-5  # probs, f32
K, PAD = k2.K, k2.PAD
# k8 steps a weight stage of the tile each block takes at B=512 (PTBXL_TF32_TILES):
# Cout 32 -> 5, 64 -> 4, else 8
STAGE_STEPS = {32: 5, 64: 4}


def _jax():
    jax = pytest.importorskip("jax")
    from ptbxl_tpu.models import factory
    from ptbxl_tpu.ops.pallas import fused_ecgcnn as pallas
    from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch

    return jax, factory, pallas, zscore_per_lead_batch


@pytest.fixture(scope="module")
def ecgcnn():
    jax, factory, pallas, _ = _jax()
    _, variables = factory.build_ecgcnn(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return pallas.fold_bn_into_conv(variables), k2.fold_bn_into_conv(from_flax_variables(variables))


@pytest.fixture(scope="module")
def multimodal():
    jax, factory, pallas, _ = _jax()
    _, variables = factory.build_multimodal(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    return (pallas.fold_multimodal(variables),
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
    """w3 is [15*CinP/8, 2, 8*Cout]: k8 step s, plane p (big, small), then
    wgmma's K-major core matrices without swizzle, [Cout/8][K half][8][4]:
    column k of the step for channel n at (n//8)*64 + (k//4)*32 + (n%8)*4 +
    k%4; the planes read back are [Cout, 15*CinP], column tap*CinP + c."""
    k, cin, cout = w.shape
    cin_p = -(-cin // 8) * 8
    assert tuple(w3.shape) == (k * cin_p // 8, 2, 8 * cout)
    assert w3.dtype == torch.float32 and w3.is_contiguous()
    planes = k2.tf32x3_weight_unpack(w3)
    core = w3.view(k * cin_p // 8, 2, cout // 8, 2, 8, 4)
    rng = np.random.default_rng(cout + cin)
    for s, p, n, col in zip(rng.integers(0, k * cin_p // 8, 64), rng.integers(0, 2, 64),
                            rng.integers(0, cout, 64), rng.integers(0, 8, 64)):
        assert core[s, p, n // 8, col // 4, n % 8, col % 4] == planes[p, n, 8 * s + col]
    big, small = planes.view(2, cout, k, cin_p).permute(0, 2, 3, 1)  # each [K, CinP, Cout]
    assert not big[:, cin:].any() and not small[:, cin:].any()  # padded channels are zero
    assert _is_tf32(big) and _is_tf32(small)
    torch.testing.assert_close(big[:, :cin], tf32_round(w), rtol=0, atol=0)
    err = (w - (big[:, :cin] + small[:, :cin])).abs()
    assert bool((err <= 2.0 ** -21 * w.abs()).all()), float((err / w.abs().clamp_min(1e-30)).max())


@pytest.mark.parametrize("block", [0, 1, 2, 3])
def test_prepare_weights_layout_padding_and_split(block):
    """The checkpoint's folded weights: [15*CinP/8, 2, 8*Cout] in core order,
    Cin padded to a multiple of 8 with zeros (12 -> 16), big and small TF32
    values (13 low bits zero), |w - (big + small)| <= 2^-21 |w|."""
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv(state)
    weights = k2.prepare_weights(folded)
    assert len(weights) == folded["n_blocks"] == 4
    _check_split_weight(folded[f"w{block}"], weights[block])
    cin_p = 16 if block == 0 else folded[f"w{block}"].shape[1]
    assert weights[block].shape[0] * 8 == K * cin_p


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
        k2.conv_block_tf32x3(x, w3[:-1].contiguous(), torch.zeros(32))  # not whole taps
    with pytest.raises(ValueError, match="w3"):
        k2.conv_block_tf32x3(x, w3[:, :1].contiguous(), torch.zeros(32))  # one plane
    with pytest.raises(ValueError, match="stats"):
        k2.conv_block_tf32x3(x, w3, torch.zeros(32), stats=torch.zeros(1, 12))


# -- (b) the kernel's arithmetic, emulated ---------------------------------------------

def _emulated_block(h: torch.Tensor, w3: torch.Tensor, b: torch.Tensor,
                    stage_cols: int) -> torch.Tensor:
    """h [B, T, Cin] (normalized) -> pool(relu(conv_SAME + b)) [B, T//2, Cout] as the
    kernel computes it: zero halo and channels, the input split like the weights,
    small*big + big*small + big*big per product (each exact in f32), summed over
    each stage of ``stage_cols`` reduction columns (tap*CinP + c), the stage sums
    added up in f32."""
    t, cin = h.shape[1], h.shape[2]
    big, small = k2.tf32x3_weight_unpack(w3)  # [Cout, 15*CinP]
    cin_p = big.shape[1] // K
    hp = F.pad(h, (0, cin_p - cin, PAD, PAD))
    xb = tf32_round(hp)
    xs = tf32_round(hp - xb)
    a_b = torch.cat([xb[:, k:k + t] for k in range(K)], dim=2)  # [B, T, 15*CinP]
    a_s = torch.cat([xs[:, k:k + t] for k in range(K)], dim=2)
    acc = torch.zeros(h.shape[0], t, big.shape[0])
    for c0 in range(0, K * cin_p, stage_cols):
        sl = slice(c0, c0 + stage_cols)
        acc = acc + (a_s[..., sl] @ big[:, sl].T + a_b[..., sl] @ small[:, sl].T
                     + a_b[..., sl] @ big[:, sl].T)
    y = torch.relu(acc + b)
    half = t // 2
    return y[:, :2 * half].reshape(y.shape[0], half, 2, -1).amax(dim=2)


def _emulated_z_ecg(x: torch.Tensor, folded, weights, normalize: bool) -> torch.Tensor:
    h = zscore_plain(x) if normalize else x
    for i, w3 in enumerate(weights):
        cout = w3.shape[2] // 8
        h = _emulated_block(h, w3, folded[f"b{i}"], 8 * STAGE_STEPS.get(cout, 8))
    g = h.mean(dim=1)
    return g @ folded["proj_w"] + folded["proj_b"]


def _emulated_probs(arch, x, d, folded, normalize=True) -> np.ndarray:
    z = _emulated_z_ecg(torch.from_numpy(x), folded, k2.prepare_weights(folded), normalize)
    if arch == "multimodal":
        h1 = torch.relu(torch.from_numpy(d) @ folded["fc1_w"] + folded["fc1_b"])
        h2 = torch.relu(h1 @ folded["fc2_w"] + folded["fc2_b"])
        film = h2 @ folded["film_w"] + folded["film_b"]
        feat = z.shape[1]
        z = (1.0 + torch.tanh(film[:, :feat])) * z + film[:, feat:]
    return torch.sigmoid(z @ folded["head_w"] + folded["head_b"]).numpy()


CASES = {"2x512": (0, (2, 512, 12), True), "2x512 pre-normalized": (1, (2, 512, 12), False),
         "1x500 odd floors": (2, (1, 500, 12), True)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ["ecgcnn", "multimodal"])
def test_emulated_matches_pallas_interpret(request, arch, case):
    """Both models, each case: the emulated card forward against the Pallas
    kernel in interpret mode (the multimodal one with its demographics)."""
    _, _, pallas, jax_zscore = _jax()
    import jax.numpy as jnp

    jf, tf = request.getfixturevalue(arch)
    seed, shape, normalize = CASES[case]
    seed += 10 if arch == "multimodal" else 0
    x, d = _x(seed, shape), _demo(seed, shape[0])
    if not normalize:
        x = np.array(jax_zscore(jnp.asarray(x)))
    if arch == "multimodal":
        want = pallas.fused_multimodal_probs(jnp.asarray(x), jnp.asarray(d), jf,
                                             normalize=normalize, interpret=True)
    else:
        want = pallas.fused_ecgcnn_probs(jnp.asarray(x), jf, normalize=normalize, interpret=True)
    np.testing.assert_allclose(_emulated_probs(arch, x, d, tf, normalize), np.asarray(want),
                               atol=TOL)


@pytest.mark.parametrize("stage_cols", [24, 40, 64])
def test_emulated_block_matches_exact_f32(stage_cols):
    """At the checkpoint's widest block (128 -> 256) on activations of its scale, one
    emulated block, at each stage width the tiles take (3, 5 or 8 k8 steps),
    stays within 2^-20 of the largest |x|*|w| sum of the exact f32 block
    (k2._conv_block_plain, TF32 off)."""
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv(state)
    w, b = folded["w3"], folded["b3"]
    h = torch.from_numpy(np.abs(_x(5, (2, 96, 128))))
    got = _emulated_block(h, k2.tf32x3_weight(w), b, stage_cols)
    hp = F.pad(h, (0, 0, PAD, PAD))
    want = k2._conv_block_plain(hp, w, b, torch.float32)
    scale = float(k2._conv_block_plain(hp.abs(), w.abs(), torch.zeros_like(b), torch.float32).max())
    assert float((got - want).abs().max()) <= 2.0 ** -20 * scale


@pytest.mark.parametrize("zscore", [True, False])
def test_conv_block_on_cpu_takes_plain_version(zscore):
    """A CPU tensor takes ``conv_block_tf32x3_plain``: block 0 (Cin 12 padded to 16)
    with the z-score from ``zscore_stats`` on load, or without, equals the exact-f32
    block on ``w`` within 2^-20 of its largest |x|*|w| sum (w vs big + small), and
    launches nothing."""
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv(state)
    w, b = folded["w0"], folded["b0"]
    x = torch.from_numpy(_x(6, (2, 101, 12)))
    stats = k2.zscore_stats(x) if zscore else None
    before = k2.conv_block_launches
    got = k2.conv_block_tf32x3(x, k2.tf32x3_weight(w), b, stats)
    assert k2.conv_block_launches == before
    hp = F.pad(zscore_plain(x) if zscore else x, (0, 0, PAD, PAD))
    want = k2._conv_block_plain(hp, w, b, torch.float32)
    scale = float(k2._conv_block_plain(hp.abs(), w.abs(), torch.zeros_like(b), torch.float32).max())
    assert got.shape == (2, 50, 32)
    assert float((got - want).abs().max()) <= 2.0 ** -20 * scale


# -- (c) the kernel on the card ----------------------------------------------------------

@pytest.fixture(scope="module")
def card_blocks():
    """512 raw-like records at T=5000 on the card, their stats, and each block's
    input from the exact-f32 plain blocks (TF32 off), with the checkpoint's
    folded and split weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the wgmma conv block runs only there")
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(512, 5000, 12, generator=gen, device="cuda")
    x = x * (torch.rand(512, 1, 12, generator=gen, device="cuda") * 2 + 0.5)
    x = x + torch.randn(512, 1, 12, generator=gen, device="cuda")
    state, _ = load_checkpoint(CKPT)
    folded = k2.fold_bn_into_conv({k: v.to("cuda") for k, v in state.items()})
    inputs = []
    with highest_precision():
        h = zscore_plain(x)
        for i in range(4):
            inputs.append(h)
            h = k2._conv_block_plain(F.pad(h, (0, 0, PAD, PAD)), folded[f"w{i}"],
                                     folded[f"b{i}"], torch.float32)
    return x, k2.zscore_stats(x), inputs, folded, k2.prepare_weights(folded)


@pytest.mark.card
@pytest.mark.parametrize("bsz", [1, 16, 512])
@pytest.mark.parametrize("block", [0, 1, 2, 3])
def test_card_conv_block_within_gate(card_blocks, block, bsz):
    """Each block at B = 1, 16 and 512 (where the launcher picks different tiles)
    within 2^-18 of the block's largest |x| conv |w| sum of the exact-f32 plain
    block (chip_smoke.py's k2_blocks gate), block 0 z-scoring on load; one
    launch of the wgmma block each."""
    x, stats, inputs, folded, weights = card_blocks
    w, b = folded[f"w{block}"], folded[f"b{block}"]
    h = inputs[block][:bsz]
    with highest_precision():
        hp = F.pad(h, (0, 0, PAD, PAD))
        want = k2._conv_block_plain(hp, w, b, torch.float32)
        scale = float(k2._conv_block_plain(hp.abs(), w.abs(), torch.zeros_like(b),
                                           torch.float32).max())
    xin, st = (x[:bsz].contiguous(), stats[:bsz].contiguous()) if block == 0 else (h, None)
    before = k2.conv_block_launches
    got = k2.conv_block_tf32x3(xin, weights[block], b, st)
    torch.cuda.synchronize()
    assert k2.conv_block_launches == before + 1
    assert float((got - want).abs().max()) <= 2.0 ** -18 * scale
