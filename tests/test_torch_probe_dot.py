"""P1's TF32 dot and shifted concat (ptbxl_torch/ops/kernels/probes.py) on the
host: the dot's launch plan and the shapes it refuses, the rounding its
kernel applies (``tf32_round``, which models ``cvt.rna.tf32.f32``) against a
numpy round-to-nearest-ties-away of the low 13 bits, p7's plain version
against the JAX tool's numpy reference and its Pallas kernel in interpret
mode beyond the probe's shape, and the gate cases ``chip_smoke.py`` runs on
the card.  The kernels themselves run only on the card (chip_smoke.py).
"""

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from ptbxl_torch.ops.kernels import _build  # noqa: E402
from ptbxl_torch.ops.kernels import probes as kp  # noqa: E402
from ptbxl_torch.tools import probe_mosaic  # noqa: E402
from tests.torch_port_common import HERE  # noqa: E402

sys.path.insert(0, os.path.join(HERE, "tools"))
import probe_mosaic as jax_pm  # noqa: E402

PROBE_MNK = (2048, 128, 256)


@pytest.mark.parametrize("form,smem", [("tn", 139_280), ("nt", 132_624)])
def test_plan_fills_the_card_at_the_probes_shapes(form, smem):
    """64 x 32 tiles with all of K resident: 128 CTAs (the H100 has 132 SMs)."""
    plan = kp.dot_plan(*PROBE_MNK, form == "nt", form == "nt")
    assert plan.tile == (64, 32) and plan.grid == (32, 4) and plan.ctas == 128
    assert plan.smem_bytes == smem <= kp.SMEM_MAX == 232_448


@pytest.mark.parametrize("form", ["tn", "nt"])
def test_plan_pads_k_to_whole_chunks(form):
    """K = 8 still takes one chunk of 128 in A's landing rows and B's core rows;
    K = 384 is the largest whose slices fit, K = 392 the first refused."""
    kmajor = form == "nt"
    small = kp.dot_plan(64, 32, 8, kmajor, kmajor)
    a_land = 64 * (128 + 4) if kmajor else 128 * 72
    b_land = 32 * (8 + 4) if kmajor else 8 * 32
    assert small.grid == (1, 1) and small.smem_bytes == 4 * (128 * 32 + a_land + b_land) + 16
    assert kp.dot_plan(128, 64, 384, kmajor, kmajor).smem_bytes <= kp.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        kp.dot_plan(128, 64, 392, kmajor, kmajor)


def _operands(form, m, n, k):
    if form == "tn":
        return torch.zeros(k, m), torch.zeros(k, n), (1, m, n, 1)
    return torch.zeros(m, k), torch.zeros(n, k), (k, 1, 1, k)


@pytest.mark.parametrize("form", ["tn", "nt"])
@pytest.mark.parametrize("m,n,k,rule", [(96, 128, 256, "M % 64"), (128, 48, 256, "N % 32"),
                                        (128, 64, 12, "K % 8"), (128, 64, 392, "shared memory"),
                                        (0, 32, 8, "empty")])
def test_refused_shapes_raise_before_any_launch(form, m, n, k, rule):
    a, b, strides = _operands(form, m, n, k)
    before = kp.launches
    with pytest.raises(ValueError, match=rule):
        kp.dot_plan(m, n, k, form == "nt", form == "nt")
    with pytest.raises(ValueError, match=rule):
        kp._dot(a, b, m, n, k, strides, "tf32")
    assert kp.launches == before


def test_misaligned_operand_raises_before_any_launch():
    m, n, k = 64, 32, 8
    a = torch.zeros(k * m + 1)[1:].view(k, m)  # contiguous, 4 bytes past a 16-byte boundary
    before = kp.launches
    with pytest.raises(ValueError, match="16-byte"):
        kp._dot(a, torch.zeros(k, n), m, n, k, (1, m, n, 1), "tf32")
    assert kp.launches == before


@pytest.mark.parametrize("precision", ["tf32", "fp32"])
def test_dot_hands_its_plan_to_the_entry(monkeypatch, precision):
    """The entry gets (device, a, b, c, M, N, K, strides, tf32, grid_m, grid_n,
    smem, stream): the TF32 plan, or zeros for p9's FP32 path, which keeps
    its own rules.  Device index, entry and stream are stand-ins (no card), put
    in at the launcher's seam (``_build.Library.entries``, ``_build.raw_stream``)."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(_build, "raw_stream", lambda idx: 99)
    monkeypatch.setattr(kp.LIB, "entries", {"ptbxl_probe_dot": lambda *a: calls.append(a) or 0})
    m, n, k = PROBE_MNK
    a, b, strides = _operands("tn", m, n, k)
    before = kp.launches
    out = kp._dot(a, b, m, n, k, strides, precision)
    assert kp.launches == before + 1 and out.shape == (m, n)
    plan = kp.dot_plan(m, n, k, False, False)
    tail = (1, 32, 4, plan.smem_bytes) if precision == "tf32" else (0, 0, 0, 0)
    assert calls == [(0, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, *strides, *tail, 99)]


def _tf32_rna_numpy(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 by its bits: keep the top 19, and add one unit of the
    last kept bit when the 13 dropped bits are at least half of it (nearest,
    ties away from zero: the sign bit is apart from the magnitude)."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    kept = bits & ~np.uint64(0x1FFF)
    up = (bits & np.uint64(0x1FFF)) >= np.uint64(0x1000)
    return (kept + up * np.uint64(0x2000)).astype(np.uint32).view(np.float32)


EDGES = {
    "ties": [1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 3.0 + 2.0 ** -10, 0.5 + 2.0 ** -12],
    "negative ties": [-(1.0 + 2.0 ** -11), -(1.0 + 3 * 2.0 ** -11), -(1.5 + 2.0 ** -11)],
    "carry into the exponent": [2.0 - 2.0 ** -11, 2.0 - 2.0 ** -23, -(4.0 - 2.0 ** -10),
                                float(np.float32(3.4028235e38))],
    "zeros": [0.0, -0.0],
    "subnormals": [2.0 ** -149, 2.0 ** -137, 2.0 ** -136 + 2.0 ** -137, -3.0e-40, 1.1754942e-38],
    "below and above a tie": [1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0 + 2.0 ** -11 + 2.0 ** -23],
}


@pytest.mark.parametrize("case", list(EDGES))
def test_tf32_round_is_round_to_nearest_ties_away(case):
    x = np.array(EDGES[case], dtype=np.float32)
    got = kp.tf32_round(torch.from_numpy(x)).numpy()
    want = _tf32_rna_numpy(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got.view(np.uint32) & 0x1FFF == 0).all()


def test_tf32_round_on_normals_and_the_gate_values():
    x = np.concatenate([np.random.default_rng(7).standard_normal(4096).astype(np.float32) * 1e3,
                        np.array(probe_mosaic.TF32_EDGE_VALUES, dtype=np.float32)])
    got = kp.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _tf32_rna_numpy(x).view(np.uint32))


@pytest.mark.parametrize("form", ["tn", "nt"])
def test_rounding_gate_picks_each_rounded_element(form):
    """chip_smoke's rounding gate: C = A @ one-hot gives tf32(A(m, n % 8))."""
    a, b = probe_mosaic.rounding_inputs(form, torch.device("cpu"))
    got = kp.tn_dot_plain(a, b) if form == "tn" else kp.nt_dot_plain(a, b)
    a_mk = a.t() if form == "tn" else a
    assert torch.equal(got, kp.tf32_round(a_mk)[:, torch.arange(32) % 8])


@pytest.mark.parametrize("to,c", [(37, 5), (37, 12), (512, 5)])
def test_shifted_concat_plain_matches_the_jax_reference(to, c):
    """The JAX tool's numpy reference (np.concatenate of the 15 slices) and its
    Pallas kernel in interpret mode, at shapes beyond the probe's."""
    x = np.random.default_rng(to + c).standard_normal((to + 14, c)).astype(np.float32)
    got = kp.shifted_concat_plain(torch.from_numpy(x)).numpy()
    ref = np.concatenate([x[k:k + to] for k in range(15)], axis=1)
    np.testing.assert_array_equal(got, ref)

    def kernel(x_ref, o_ref):
        o_ref[:] = jnp.concatenate([x_ref[k:k + to, :] for k in range(15)], axis=1)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_pm._call(kernel, jax.ShapeDtypeStruct((to, 15 * c), jnp.float32),
                                       jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert torch.equal(kp.shifted_concat(torch.from_numpy(x)), torch.from_numpy(got))


def test_gate_cases_on_the_host():
    """Every case chip_smoke.py gates on the card runs here through the
    wrappers' plain versions: the names, the dots' CTAs, p7's paths."""
    gates = probe_mosaic.gate_cases(torch.device("cpu"))
    assert all(g["ok"] for g in gates.values()), gates
    assert len(gates) == 2 * len(probe_mosaic.DOT_GATE_SHAPES) + 2 + len(
        probe_mosaic.CONCAT_GATE_CASES)
    assert gates["tn M=2048 N=128 K=256"]["ctas"] == 128 == gates["nt M=2048 N=128 K=256"]["ctas"]
    assert gates["nt M=192 N=96 K=136"]["ctas"] == 9
    assert gates["p7 To=512 C=12 offset=0"]["path"] == "float4"
    assert gates["p7 To=37 C=5 offset=0"]["path"] == "4-byte"
    assert gates["p7 To=37 C=12 offset=1"]["path"] == "4-byte"


def test_phase_probe_instruments_the_shipped_kernel():
    """tools/probe_dot_phases.py patches a copy of probes.cu at anchors in the
    TF32 dot's kernel: each must be there once, or the tool refuses."""
    from ptbxl_torch.tools import probe_dot_phases

    src = (_build.CSRC / "probes.cu").read_text()
    out = probe_dot_phases.instrumented_source(src)
    assert out.count("clock64() - c0_") == 3 and "ptbxl_phases_read" in out
    with pytest.raises(ValueError, match="anchor"):
        probe_dot_phases.instrumented_source(src.replace("  wg_wait<0>();\n#pragma unroll\n", ""))


@pytest.mark.parametrize("tool", ["tune_dot", "probe_dot_phases"])
def test_card_tools_refuse_without_a_card(monkeypatch, capsys, tool):
    """The dot's measurement tools need the card: without one they print why
    and exit 2, building nothing."""
    import importlib

    mod = importlib.import_module(f"ptbxl_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "build", lambda: pytest.fail("built without a card"))
    assert mod.main([]) == 2
    assert "needs a CUDA GPU" in capsys.readouterr().err
