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
import torch.nn.functional as F  # noqa: E402

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.ops.pallas.fused_ecgcnn import fold_bn_into_conv as jax_fold  # noqa: E402
from ptbxl_tpu.ops.pallas.hybrid_ecgcnn import hybrid_ecgcnn_probs as jax_hybrid_probs  # noqa: E402
from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch as jax_zscore  # noqa: E402

from ptbxl_torch.models.params_io import from_flax_variables, load_checkpoint  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2  # noqa: E402
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4  # noqa: E402
from ptbxl_torch.ops.kernels.zscore import zscore_stats_plain  # noqa: E402
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


@pytest.mark.parametrize("block", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prepare_weights_layouts(models, block, dtype):
    """One weight a block, the same for every split: in bf16 the ``wgmma``
    block's core-order tap tiles (``wg_weight``), which map back to ``[15,
    Cin, Cout]`` bit for bit with zero padded channels; in f32 K2's split
    ``tf32x3_weight``."""
    _, tf = models
    tdt = DTYPES[dtype][1]
    wts = k4.prepare_weights(tf, tdt)
    assert set(wts) == {"dtype", "blocks"} and wts["dtype"] == tdt
    assert len(wts["blocks"]) == 4
    got, w = wts["blocks"][block], tf[f"w{block}"]
    if dtype == "f32":
        torch.testing.assert_close(got, k2.tf32x3_weight(w), rtol=0, atol=0)
        return
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    back = k4.wg_weight_unpack(got)
    assert torch.equal(back[:, :w.shape[1]], w.to(torch.bfloat16))
    assert not back[:, w.shape[1]:].any()


@pytest.mark.parametrize("block", [0, 1, 2, 3])
def test_wg_weight_core_order(models, block):
    """Element (k, n) of k16 step g of slice s sits at ``[s, g, k // 8, n // 8,
    n % 8, k % 8]``: the K-major 8 x 8 cores the kernel's B descriptor reads
    (leading offset 16*BN bytes between the K halves, 128 bytes between
    8-column groups), step g = tap * CinP/16 + kk."""
    _, tf = models
    w = tf[f"w{block}"]
    wp = k4.wg_weight(w)
    cin_p, cout, bn, _ = k4._wg_geometry(wp)
    assert wp.shape == (cout // bn, 15 * cin_p // 16, 2, bn // 8, 8, 8)
    flat = wp.reshape(cout // bn, 15 * cin_p // 16, 16 * bn)
    rng = np.random.default_rng(block)
    for _ in range(64):
        tap, c, o = int(rng.integers(15)), int(rng.integers(w.shape[1])), int(rng.integers(cout))
        g, k = tap * (cin_p // 16) + c // 16, c % 16
        s, n = divmod(o, bn)
        byte = (k // 8) * 16 * bn + (n // 8) * 128 + (n % 8) * 16 + (k % 8) * 2
        assert flat[s, g, byte // 2] == w[tap, c, o].to(torch.bfloat16)


@pytest.mark.parametrize("block,t", [(0, 300), (0, 301), (1, 256), (2, 250), (3, 625), (3, 64)])
def test_wgmma_block_emulation_matches_plain_block(models, block, t):
    """One launch's plain version (the kernel's tiles emulated: halo rows,
    the z-score on load, k16 steps in order, bf16 out or per-tile sums)
    against the plain block on the same input padded after the z-score.
    Block 0 reads raw leads with a DC offset, so a halo of z-scored zeros
    (-mean/std) would show; block 3 at T=625 drops conv row 624 (odd
    length).  bf16 out: one bf16 rounding, which another sum order moves by
    at most one ulp (2^-8 of the value); sums: f32 sums in another order."""
    _, tf = models
    w, b = tf[f"w{block}"], tf[f"b{block}"]
    cin = w.shape[1]
    rng = np.random.default_rng(100 * block + t)
    if block == 0:
        x = torch.from_numpy((rng.standard_normal((2, t, cin)) * 3 + 5).astype(np.float32))
        stats = zscore_stats_plain(x)
        z = (x - stats[:, None, :, 0]) / stats[:, None, :, 1]
    else:
        x = torch.from_numpy(rng.standard_normal((2, t, cin)).astype(np.float32))
        x, stats = x.to(torch.bfloat16), None
        z = x.float()
    want = k4._im2col_block_plain(F.pad(z, (0, 0, k4.PAD, k4.PAD)), w.reshape(-1, w.shape[2]),
                                  b, torch.bfloat16)
    sums = block == 3
    got = k4.wgmma_conv_block(x, k4.wg_weight(w), b, stats, sums)
    if sums:
        per = k4.wg_tile(cin, w.shape[2])[1] // 2
        want = torch.stack([want[:, j * per:(j + 1) * per].sum(1) for j in range(got.shape[1])], 1)
        assert got.dtype == torch.float32 and got.shape == (2, -(-(t // 2) // per), w.shape[2])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert ((got.float() - want).abs() <= 2 ** -8 * want.abs() + 1e-6).all()


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_card_route_matches_plain_and_jax(models, split, dtype):
    """The card's launch sequence, each launch in its plain version (bf16:
    stats, four emulated ``wgmma`` blocks, the sums tail; f32: K2's blocks and
    tail), against K4's plain version and JAX's engine in interpret mode."""
    jf, tf = models
    jdt, tdt, tol = DTYPES[dtype]
    x = _x(10, (2, 512, 12)) + 1.5
    want = np.asarray(jax_hybrid_probs(jnp.asarray(x), jf, compute_dtype=jdt, interpret=True,
                                       split=split, block_b=2))
    xt = torch.from_numpy(x)
    got = torch.sigmoid(k4.card_route_logits(xt, tf, split, tdt,
                                             weights=k4.prepare_weights(tf, tdt))).numpy()
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(got, k4.hybrid_ecgcnn_probs(xt, tf, tdt, split=split).numpy(),
                               atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_card_route_full_length(models, dtype):
    """T=5000, B=1 (5000 -> 2500 -> 1250 -> 625 -> 312): every tile geometry
    of the main path, block 3's odd length and its five tiles of sums."""
    jf, tf = models
    jdt, tdt, tol = DTYPES[dtype]
    x = _x(11, (1, 5000, 12))
    want = np.asarray(jax_hybrid_probs(jnp.asarray(x), jf, compute_dtype=jdt, interpret=True,
                                       split=2, block_b=1))
    xt = torch.from_numpy(x)
    got = torch.sigmoid(k4.card_route_logits(xt, tf, 2, tdt)).numpy()
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(got, k4.hybrid_ecgcnn_probs(xt, tf, tdt).numpy(), atol=tol)


def test_sums_tail_adds_tiles_in_order(models):
    """The tail takes the tiles' sums in tile order, each times 1/T, which is
    the ones-mean of the pooled rows; then proj and head with bf16 operands."""
    _, tf = models
    h = torch.from_numpy(np.abs(_x(12, (3, 312, 256))))
    part = torch.stack([h[:, j * 64:(j + 1) * 64].sum(1) for j in range(5)], 1)
    got = k4.sums_tail(part, 312, tf)
    g = torch.einsum("t,btc->bc", torch.full((312,), 1 / 312), h)
    z = k2._dot1(g, tf["proj_w"], torch.bfloat16) + tf["proj_b"]
    want = k2._dot1(z, tf["head_w"], torch.bfloat16) + tf["head_b"]
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)
    assert torch.equal(got, k4.sums_tail_plain(part, 312, tf))


def test_wgmma_block_rejects_what_it_has_no_tile_for(models):
    _, tf = models
    with pytest.raises(ValueError, match="CinP -> Cout"):
        k4.wg_weight(torch.zeros(15, 12, 48))
    wp = k4.wg_weight(tf["w1"])
    with pytest.raises(ValueError, match="block 0's raw record"):
        k4.wgmma_conv_block(torch.zeros(1, 64, 32), wp, tf["b1"])  # f32 input to block 1
    with pytest.raises(ValueError, match="no stats"):
        k4.wgmma_conv_block(torch.zeros(1, 64, 32, dtype=torch.bfloat16), wp, tf["b1"],
                            torch.zeros(1, 32, 2))


@pytest.mark.parametrize("prepared,called", [("bf16", "f32"), ("f32", "bf16")])
def test_weights_for_another_dtype_raise(models, prepared, called):
    _, tf = models
    x = torch.zeros(1, 256, 12, device="meta")
    weights = k4.prepare_weights(tf, DTYPES[prepared][1])
    with pytest.raises(ValueError, match="prepared for"):
        k4.hybrid_ecgcnn_logits(x, tf, 2, DTYPES[called][1], weights=weights)
    with pytest.raises(ValueError, match="prepared for"):
        k4.card_route_logits(torch.zeros(1, 256, 12), tf, 2, DTYPES[called][1], weights=weights)


@pytest.mark.parametrize("block", [0, 1, 2, 3])
def test_tile_table_is_the_kernel_sources(models, block):
    """``WG_TILES`` is ``PTBXL_WG_TILES`` as the CUDA source writes it: a row
    for each of the ECGCNN's blocks (CinP -> Cout, BN dividing Cout, <= 128
    f32 accumulators a thread), which ``wg_tile`` and the weights' layout
    follow; the tuning tool's copy of the source changes that row alone."""
    from ptbxl_torch.tools import tune_wgmma

    _, tf = models
    w = tf[f"w{block}"]
    cin_p, cout = -(-w.shape[1] // 16) * 16, w.shape[2]
    text = k4.WG_SOURCE.read_text()
    assert k4.read_wg_tiles(text) == k4.WG_TILES
    row_cout, bn, rm, minb, steps = k4.WG_TILES[cin_p]
    assert row_cout == cout and cout % bn == 0 and rm * bn // 2 <= 128
    assert (15 * cin_p // 16) % steps == 0 and minb in (1, 2, 3)
    assert k4.wg_tile(cin_p, cout) == (bn, 128 * rm)
    assert k4.wg_weight(w).shape == (cout // bn, 15 * cin_p // 16, 2, bn // 8, 8, 8)
    for variant in tune_wgmma.VARIANTS[cin_p]:
        got = k4.read_wg_tiles(tune_wgmma.variant_source(text, cin_p, variant))
        assert got == {**k4.WG_TILES, cin_p: variant}
        assert variant[0] == cout and cout % variant[1] == 0
        back = k4.wg_weight_unpack(k4.wg_weight(w, bn=variant[1]))
        assert torch.equal(back[:, :w.shape[1]], w.to(torch.bfloat16))
