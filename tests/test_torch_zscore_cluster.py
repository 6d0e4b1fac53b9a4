"""The cluster plan and the cluster fold of K1/K5 (ptbxl_torch/ops/kernels/zscore.py).

The CUDA kernels (csrc/zscore.cu) split each record over the CTAs of one
thread-block cluster, read each piece once by bulk copies (16-byte aligned
interior, ragged head and tail by ordinary loads) and add the per-piece f64
totals in rank order.  Here, on the CPU: ``cluster_plan`` at the main paths'
shapes and at the chip gates' odd ones, and ``zscore_cluster_plain`` (the
fold on the plan's pieces) against the JAX Pallas kernels in interpret mode.
The kernels themselves are held against their plain versions on the card by
chip_smoke.py.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.ops.pallas.zscore import zscore_pallas, zscore_pallas_wide  # noqa: E402

from ptbxl_torch.ops.kernels import zscore as kz  # noqa: E402

TOL = 1e-5  # f32, sums in another order (test_pallas_kernels.py:29)
F32, BF16 = torch.float32, torch.bfloat16
MAX_SMEM = 232448  # dynamic shared memory a CTA can have on the H100

# (B, T, width, dtype, entry, per): the main paths' launches, then the chip gates' odd shapes
MAIN = [(b, 5000, 12, F32, e, None) for b in (1, 512, 8192) for e in ("zscore", "zscore_stats")]
MAIN += [(11264, 5000, w, BF16, "zscore_wide", 8) for w in (240, 480, 1200)]
ODD = [(13, 240, 36, F32, "zscore_wide", 8), (13, 240, 36, BF16, "zscore_wide", 8),
       (13, 37, 12, BF16, "zscore", None), (13, 37, 12, F32, "zscore_stats", None),
       (13, 37, 12, BF16, "zscore_wide", 8), (13, 37, 444, BF16, "zscore_wide", 8),
       (512, 5000, 480, F32, "zscore_wide", 16)]


def _size(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _harsh(seed, shape):
    """chip_smoke.py's harsh data: per-lead offset N(0, 3), scale in [0.1, 2.5]."""
    rng = np.random.default_rng(seed)
    b, _, c = shape
    x = rng.standard_normal(shape) * rng.uniform(0.1, 2.5, (b, 1, c)) + rng.normal(0, 3, (b, 1, c))
    return x.astype(np.float32)


def _raw(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 4 + 2).astype(np.float32)


DATA = {"seeded": _raw, "harsh": _harsh}


def _plan(b, t, width, dtype, entry, per, k=None):
    return kz.cluster_plan(b, t, 12, width, dtype, dtype, entry, k=k, per=per)


@pytest.mark.parametrize("case", MAIN + ODD, ids=lambda c: f"{c[4]}-B{c[0]}-T{c[1]}-W{c[2]}-"
                         f"{str(c[3])[6:]}")
def test_plan_pieces_cover_the_record_on_whole_rows(case):
    b, t, width, dtype, entry, per = case
    plan = _plan(*case)
    pieces = kz.plan_pieces(plan, t, 12)
    assert len(pieces) == plan.k and 1 <= plan.k <= 8
    pos = 0
    for start, n in pieces:
        assert start == pos and n > 0 and start % width == 0 and n % width == 0
        assert n <= plan.piece_rows * width
        pos += n
    assert pos == t * 12
    assert plan.clusters == -(-b // plan.per) and plan.per == (per or 1)


@pytest.mark.parametrize("case", MAIN + ODD, ids=lambda c: f"{c[4]}-B{c[0]}-T{c[1]}-W{c[2]}-"
                         f"{str(c[3])[6:]}")
def test_plan_bulk_copies_are_aligned_and_the_rest_is_ordinary(case):
    """Every piece of the first records, at an aligned base and at an offset
    view's (one record, and 8 bytes, in): one 16-byte-sized, 16-byte-aligned
    bulk copy, fewer than 16 bytes each side by ordinary loads, inside the
    piece buffer with its alignment pad."""
    b, t, width, dtype, entry, per = case
    plan = _plan(*case)
    size = _size(dtype)
    for base in (0, size, 8, t * 12 * size):
        for rec in range(min(b, 3)):
            for start, n in kz.plan_pieces(plan, t, 12):
                addr = base + (rec * t * 12 + start) * size
                head, bulk, tail = kz.piece_split(addr, n, size)
                assert head + bulk // size + tail == n
                assert bulk % 16 == 0 and bulk <= plan.bulk_bytes
                if bulk:
                    assert (addr + head * size) % 16 == 0
                assert head * size < 16 and (tail * size < 16 or bulk == 0)
                assert addr % 16 + n * size <= plan.buf_bytes


@pytest.mark.parametrize("case", MAIN + ODD, ids=lambda c: f"{c[4]}-B{c[0]}-T{c[1]}-W{c[2]}-"
                         f"{str(c[3])[6:]}")
def test_plan_fits_a_cta(case):
    b, t, width, dtype, entry, per = case
    plan = _plan(*case)
    ve = 16 // _size(dtype)
    lanes = min(32, 12 // math.gcd(12, ve))
    assert plan.lanes == lanes
    assert plan.threads % 32 == 0 and plan.walkers <= plan.threads < plan.walkers + 32
    assert (plan.walkers * ve) % 12 == 0
    if width // math.gcd(width, ve) <= kz.MAX_THREADS:
        assert (plan.walkers * ve) % width == 0  # the walk's line: whole rows of the width
    # the piece, the staging buffer, the fold's scratch, two inboxes of k x 12
    # totals, three mbarriers, the moments and the reciprocals of the sd
    rest = (plan.threads // 32) * lanes * ve * 8 + 2 * plan.k * 12 * 8 + 3 * 8 + 3 * 12 * 4
    assert plan.smem_bytes == plan.buf_bytes + plan.stage_bytes + rest
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.bulk_bytes == (plan.piece_rows * width * _size(dtype)) & ~15


def test_plan_k_at_the_main_shapes():
    """The tuned sizes: 8 CTAs for an f32 record of [5000, 12] (30 KB pieces), 4
    for bf16, K5 alike; the two K1 entries alike, so that zscore_stats gives
    zscore's mean and sd bit for bit."""
    for b in (1, 512, 8192):
        full = kz.cluster_plan(b, 5000, 12, 12, F32, F32, "zscore")
        stats = kz.cluster_plan(b, 5000, 12, 12, F32, None, "zscore_stats")
        assert full.k == stats.k == 8
        assert full._replace(smem_bytes=0, stage_bytes=0) == stats._replace(smem_bytes=0,
                                                                           stage_bytes=0)
    assert kz.cluster_plan(11264, 5000, 12, 12, BF16, BF16, "zscore").k == 4
    assert kz.cluster_plan(11264, 5000, 12, 480, BF16, BF16, "zscore_wide", per=8).k == 4
    # an output of another size is staged beside the piece
    mixed = kz.cluster_plan(512, 5000, 12, 12, F32, BF16, "zscore")
    assert mixed.stage_bytes >= 625 * 12 * 2 + 15 and mixed.k == 8


def test_plan_rejects_what_no_launch_takes():
    with pytest.raises(ValueError, match="entry"):
        kz.cluster_plan(1, 5000, 12, 12, F32, F32, "zscore_tile")
    with pytest.raises(ValueError, match="width"):
        kz.cluster_plan(1, 5000, 12, 480, F32, F32, "zscore")
    with pytest.raises(ValueError, match="block_b"):
        kz.cluster_plan(1, 5000, 12, 480, F32, F32, "zscore_wide")
    with pytest.raises(ValueError, match="does not fit"):
        kz.cluster_plan(1, 100000, 12, 12, F32, F32, "zscore", k=1)  # 4.8 MB over 16 CTAs


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_cluster_fold_matches_pallas_interpret(k, data):
    """Per-piece f64 totals added in rank order, on k pieces of whole rows."""
    x = DATA[data](k, (3, 2000, 12))
    plan = kz.cluster_plan(3, 2000, 12, 12, F32, F32, "zscore", k=k)
    assert plan.k == k
    want = np.asarray(zscore_pallas(jnp.asarray(x), interpret=True))
    got = kz.zscore_cluster_plain(torch.from_numpy(x), plan)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_cluster_fold_matches_pallas_wide_interpret(k, data):
    """K5's pieces: whole rows of width 480 (36 on T=240, the JAX test's geometry)."""
    for t, width in ((2000, 480), (240, 36)):
        x = DATA[data](10 + k, (3, t, 12))
        plan = kz.cluster_plan(3, t, 12, width, F32, F32, "zscore_wide", k=k, per=2)
        assert plan.k == k
        want = np.asarray(zscore_pallas_wide(jnp.asarray(x), width=width, block_b=2,
                                             interpret=True))
        got = kz.zscore_cluster_plain(torch.from_numpy(x), plan)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_cluster_fold_at_full_length_and_ragged_t(k):
    """T=5000 (the record of the main paths) and T=37 (pieces of 5 rows at k=8)
    against the plain version, and the stats form against its moments."""
    for t in (5000, 37):
        x = torch.from_numpy(_harsh(20 + k, (2, t, 12)))
        plan = kz.cluster_plan(2, t, 12, 12, F32, F32, "zscore", k=k)
        torch.testing.assert_close(kz.zscore_cluster_plain(x, plan), kz.zscore_plain(x),
                                   rtol=0, atol=1e-6)
        st = kz.zscore_cluster_plain(x, plan, stats=True)
        torch.testing.assert_close(st, kz.zscore_stats_plain(x), rtol=0, atol=1e-6)


def test_cluster_fold_output_is_its_stats_applied():
    """The seam gate's arithmetic: the output is (x - mean) / sd of its own stats,
    bit for bit, as the card checks K1 against zscore_stats."""
    x = torch.from_numpy(_harsh(30, (3, 5000, 12)))
    plan = kz.cluster_plan(3, 5000, 12, 12, F32, F32, "zscore")
    st = kz.zscore_cluster_plain(x, plan, stats=True)
    built = (x - st[..., 0][:, None, :]) / st[..., 1][:, None, :]
    assert torch.equal(kz.zscore_cluster_plain(x, plan), built)
