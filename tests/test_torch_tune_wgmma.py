"""ptbxl_torch/tools/tune_wgmma.py on the CPU: the copies of the kernel
source it builds (one row of the tile table changed), the variants it
tries, how it reads each tile's registers and spills from the ``-Xptxas
-v`` report, how it pairs timings, and the tiling of its fused blocks 2+3
kernel emulated.  The builds and timings themselves need the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ptbxl_torch.models.params_io import load_checkpoint  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2  # noqa: E402
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4  # noqa: E402
from ptbxl_torch.tools import tune_wgmma  # noqa: E402
from ptbxl_torch.utils.device import highest_precision  # noqa: E402
from tests.torch_port_common import CKPT  # noqa: E402


@pytest.fixture(scope="module")
def folded():
    state, _ = load_checkpoint(CKPT)
    return k2.fold_bn_into_conv(state)

LOG = """ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_123wgmma_conv_block_kernelILi64ELi128ELi2ELi1ELi2ELi0ELi0EEEvPKv' for 'sm_90a'
ptxas info    : Function properties for _ZN3_GLOBAL__N_123wgmma_conv_block_kernelILi64ELi128ELi2ELi1ELi2ELi0ELi0EEEvPKv
    32 bytes stack frame, 32 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN3_GLOBAL__N_123wgmma_conv_block_kernelILi32ELi64ELi1ELi2ELi6ELi0ELi1EEEvPKv' for 'sm_90a'
ptxas info    : Function properties for _ZN3_GLOBAL__N_123wgmma_conv_block_kernelILi32ELi64ELi1ELi2ELi6ELi0ELi1EEEvPKv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 83 registers, used 2 barriers
"""


@pytest.mark.parametrize("cin_p,row,want", [
    (64, (128, 128, 2, 1, 2), {"registers": 168, "spill_bytes": 32}),
    (32, (64, 64, 1, 2, 6), {"registers": 83, "spill_bytes": 0}),
    (128, (256, 256, 1, 1, 3), {"registers": None, "spill_bytes": None}),
])
def test_ptxas_reads_each_tiles_kernels(cin_p, row, want):
    assert tune_wgmma.ptxas(LOG, tune_wgmma.tile_key(cin_p, row)) == want


def test_variant_source_changes_one_row_or_raises():
    text = k4.WG_SOURCE.read_text()
    for cin_p, row in ((64, (128, 64, 2, 2, 4)), (128, (256, 128, 2, 1, 2))):
        out = tune_wgmma.variant_source(text, cin_p, row)
        changed = [(a, b) for a, b in zip(text.splitlines(), out.splitlines()) if a != b]
        assert len(changed) == 1 and f"X({cin_p}, {', '.join(map(str, row))})" in changed[0][1]
        was, now = (line.rstrip().endswith("\\") for line in changed[0])
        assert was == now  # the macro's line continuation is kept
    with pytest.raises(ValueError, match="CinP 48"):
        tune_wgmma.variant_source(text, 48, (96, 96, 1, 1, 3))


@pytest.mark.parametrize("cin_p", sorted(tune_wgmma.VARIANTS))
def test_variants_are_tiles_of_the_block(cin_p):
    """Every variant keeps the block's Cout, slices it evenly, keeps <= 128
    f32 accumulators a thread, tiles the reduction with its stages, and the
    shipped tile is among them; the names it builds under are distinct."""
    rows = tune_wgmma.VARIANTS[cin_p]
    assert k4.WG_TILES[cin_p] in rows
    for cout, bn, rm, minb, steps in rows:
        assert cout == k4.WG_TILES[cin_p][0] and cout % bn == 0 and bn % 32 == 0
        assert rm * bn // 2 <= 128 and minb in (1, 2, 3) and (15 * cin_p // 16) % steps == 0
    names = [tune_wgmma.variant_name(cin_p, r) for r in rows]
    assert len(set(names)) == len(names)


def test_paired_timings_alternate_and_count_wins():
    """Fused and launches are timed in turns, each first in every other pair;
    the medians and the fused side's wins come back."""
    order = []

    class Clock:
        def ms(self, fn, iters):
            return fn()

    def timed(name, values):
        it = iter(values)

        def fn():
            order.append(name)
            return next(it)
        return fn

    got = tune_wgmma.paired(timed("fused", [1.0, 3.0, 1.0, 1.0]),
                            timed("launches", [2.0, 2.0, 2.0, 0.5]), Clock(), 5, pairs=4)
    assert order == ["fused", "launches", "launches", "fused"] * 2
    assert got == {"fused_ms": 1.0, "launches_ms": 2.0, "fused_wins": 2, "pairs": 4}


def _deep_tiles_emulated(x2, tf):
    """The fused launch's tiling, step by step: for each 128-row tile of block
    3 (conv rows t0 ..), block 2's input rows 2(t0 - 7) - 7 .. (334, zero
    outside [0, T2)), its 320 conv rows in k16 steps, pooled, + bias, ReLU,
    rounded to bf16 and zeroed outside [0, T2/2) (block 3's SAME padding),
    of which 142 are block 3's input rows t0 - 7 ..; block 3's conv rows,
    pooled, summed over the tile's rows below T2/4."""
    w2 = k4.wg_weight_unpack(k4.wg_weight(tf["w2"])).float()
    w3 = k4.wg_weight_unpack(k4.wg_weight(tf["w3"])).float()
    b2, b3 = tf["b2"], tf["b3"]
    bsz, t2, _ = x2.shape
    half2, half3 = t2 // 2, t2 // 4
    xf = x2.float()

    def rows(x, u0, n):  # rows u0 .. u0 + n - 1 of [B, T, C], zeros outside
        out = x.new_zeros((bsz, n, x.shape[2]))
        lo, hi = max(u0, 0), min(u0 + n, x.shape[1])
        if hi > lo:
            out[:, lo - u0:hi - u0] = x[:, lo:hi]
        return out

    def conv(xs, w, m):  # m conv rows of a staged tile, k16 steps in order
        acc = xs.new_zeros((bsz, m, w.shape[2]))
        for step in range(15 * w.shape[1] // 16):
            tap, kk = divmod(step, w.shape[1] // 16)
            acc += xs[:, tap:tap + m, 16 * kk:16 * kk + 16] @ w[tap, 16 * kk:16 * kk + 16]
        return acc

    sums = []
    with highest_precision():
        for t0 in range(0, 2 * half3, 128):
            p0 = t0 - 7
            y2 = torch.relu(conv(rows(xf, 2 * p0 - 7, 334), w2, 320) + b2)
            y2 = torch.maximum(y2[:, 0::2], y2[:, 1::2])[:, :142].to(torch.bfloat16).float()
            prow = torch.arange(p0, p0 + 142)
            y2[:, (prow < 0) | (prow >= half2)] = 0.0
            y3 = torch.relu(conv(y2, w3, 128) + b3)
            y3 = torch.maximum(y3[:, 0::2], y3[:, 1::2])
            keep = (torch.arange(t0 // 2, t0 // 2 + 64) < half3).float()
            sums.append((y3 * keep[None, :, None]).sum(1))
    return torch.stack(sums, 1)


@pytest.mark.parametrize("t2", [64, 301, 1250])
def test_fused_deep_tiling_is_blocks_2_and_3(folded, t2):
    """The tiling of wgmma_fusions.cu's blocks 2+3 kernel (block 2's halo rows
    computed per 128-row tile of block 3, zero edges, block 3's odd lengths)
    gives the sums of block 2 then block 3 launched one at a time, in block
    3's own tiles, which the tool compares it with on the card."""
    rng = np.random.default_rng(14)
    x2 = torch.from_numpy(np.abs(rng.standard_normal((2, t2, 64)) * 2).astype(np.float32))
    x2 = x2.to(torch.bfloat16)
    wp2, wp3 = k4.wg_weight(folded["w2"]), k4.wg_weight(folded["w3"])
    want = k4.wgmma_conv_block(k4.wgmma_conv_block(x2, wp2, folded["b2"]), wp3, folded["b3"],
                               None, True)
    assert want.shape == (2, -(-2 * (t2 // 4) // 128), 256)
    torch.testing.assert_close(_deep_tiles_emulated(x2, folded), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("policies", ["Lb0ELb0E", "Li3ELi3E"])
def test_probe_hybrid_keys_each_blocks_ptxas(policies):
    """probe_hybrid's report of every ``wgmma_conv_block_kernel`` in a build's
    ``-Xptxas -v`` log, keyed by the template arguments read from the mangled
    name, bool or int policies alike (so two commits' reports line up)."""
    from ptbxl_torch.tools import probe_hybrid

    log = LOG.replace("Li0ELi0E", policies)
    key = "64,128,2,1,2," + ("0,0" if policies.startswith("Lb") else "3,3")
    got = probe_hybrid.block_ptxas(log)
    assert set(got) == {key, "32,64,1,2,6,0,1"}
    assert got[key] == ("32 bytes stack frame, 32 bytes spill stores, 32 bytes spill loads; "
                        "Used 168 registers, used 2 barriers, 32 bytes cumulative stack size")
    assert got["32,64,1,2,6,0,1"].endswith("Used 83 registers, used 2 barriers")
    # a P3/P4 instantiation of a tile is not one of K4's kernels of that tile
    assert tune_wgmma.ptxas(LOG.replace("Li0ELi0E", "Li2ELi2E"),
                            tune_wgmma.tile_key(64, (128, 128, 2, 1, 2)))["registers"] is None
