"""The port's int8 accuracy battery (``ptbxl_torch/ops/quant_eval.py``) against
the JAX package's (``ptbxl_tpu/ops/quant_eval.py``), on the CPU.

The generators are numpy and seeded: their arrays are compared bit for bit.
The report's numbers against JAX's report on the same small battery within
1e-4 (the two int8 forwards differ by ~1e-5 on the demo pack).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ptbxl_torch.models.params_io import load_checkpoint  # noqa: E402
from ptbxl_torch.ops import quant as tq  # noqa: E402
from ptbxl_torch.ops import quant_eval as tqe  # noqa: E402
from ptbxl_tpu.models.params_io import load_npz  # noqa: E402
from ptbxl_tpu.ops import quant_eval as jqe  # noqa: E402
from tests.torch_port_common import CKPT  # noqa: E402


@pytest.fixture(scope="module")
def state():
    return load_checkpoint(CKPT)[0]


@pytest.fixture(scope="module")
def small_battery():
    return tqe.make_battery(n=6, T=5000, include_demo_pack=False)


def test_battery_is_jax_bit_for_bit():
    """The default battery: the same [519, 12, 5000] array as JAX's make_battery."""
    got = tqe.make_battery()
    want = jqe.make_battery()
    assert got.shape == (519, 12, 5000) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", [
    {"n": 32, "T": 1024, "include_demo_pack": False},
    {"n": 8, "T": 5000},
    {"n": 40, "T": 777, "seed": 5},
])
def test_battery_variants_are_jax_bit_for_bit(kwargs):
    np.testing.assert_array_equal(tqe.make_battery(**kwargs), jqe.make_battery(**kwargs))


def test_robust_calibration_signals_are_jax_bit_for_bit():
    got = tqe.robust_calibration_signals()
    assert got.shape == (71, 12, 5000)
    np.testing.assert_array_equal(got, jqe.robust_calibration_signals())


def test_battery_deterministic_and_varied():
    a = tqe.make_battery(n=32, T=1024, include_demo_pack=False)
    np.testing.assert_array_equal(a, tqe.make_battery(n=32, T=1024, include_demo_pack=False))
    assert a.shape == (32, 12, 1024) and a.dtype == np.float32
    scales = np.abs(a).max(axis=(1, 2))
    assert scales.max() / scales.min() > 20  # the amplitude sweep spans orders of magnitude
    mask = tqe.battery_artifact_mask(32, total=32)
    assert mask.any() and not mask.all()


def test_battery_includes_demo_pack_at_full_length():
    assert len(tqe.make_battery(n=8, T=5000)) == 8 + 7
    assert len(tqe.make_battery(n=8, T=1024)) == 8  # another length: no demo rows


@pytest.mark.parametrize("n,total", [(512, 519), (32, 32), (100, None)])
def test_artifact_mask_and_demo_vectors_match_jax(n, total):
    np.testing.assert_array_equal(tqe.battery_artifact_mask(n, total=total),
                                  jqe.battery_artifact_mask(n, total=total))
    np.testing.assert_array_equal(tqe.battery_demo_vectors(n), jqe.battery_demo_vectors(n))


def test_gate_is_jax_gate():
    assert tqe.BATTERY_GATE == jqe.BATTERY_GATE == {"max": 4e-2, "p99": 3e-2, "flip_rate": 6e-3}
    ok = {"max": 0.03, "p99": 0.02, "flip_rate": 0.001}
    assert tqe.passes_battery_gate(ok)
    assert not tqe.passes_battery_gate(dict(ok, max=0.05))
    assert not tqe.passes_battery_gate(dict(ok, flip_rate=0.01))
    assert tqe.passes_battery_gate(dict(ok, max=0.05), gate={"max": 0.1})


def test_report_schema_and_bias_correct(state, small_battery):
    rep = tqe.quant_accuracy_report(state, "ecgcnn", signals=small_battery, batch=6,
                                    device="cpu")
    for k in ("n", "max", "p99", "p50", "mean", "flips", "flip_rate", "int8_layers",
              "num_decisions", "flip_margin", "bias_correct"):
        assert k in rep
    assert rep["n"] == 6 and rep["num_decisions"] == 30 and rep["int8_layers"] == (3,)
    assert 0.0 <= rep["p50"] <= rep["p99"] <= rep["max"]
    assert rep["flip_margin"] <= rep["max"]

    # bias correction moves the int8 layers' biases, and nothing else
    q0 = tq.quantize_model(state, "ecgcnn", calib_signals=small_battery[:2], device="cpu")
    q1 = tq.quantize_model(state, "ecgcnn", calib_signals=small_battery[:2], bias_correct=True,
                           device="cpu")
    for i in q0["int8_layers"]:
        assert not torch.allclose(q0[f"b{i}"], q1[f"b{i}"])
        torch.testing.assert_close(q0[f"w{i}"], q1[f"w{i}"], rtol=0, atol=0)
    for k in ("b0", "b2", "w0", "w2"):
        torch.testing.assert_close(q0[k], q1[k], rtol=0, atol=0)
    rep1 = tqe.quant_accuracy_report(state, "ecgcnn", signals=small_battery, q=q1,
                                     bias_correct=True, batch=6, device="cpu")
    assert rep1["bias_correct"] is True and rep1["n"] == 6


def test_bias_correction_matches_jax(state, small_battery):
    """The port's correction applied to JAX's uncorrected q-params gives JAX's
    corrected biases within 1e-5 (the same calibration set and taps)."""
    import jax.numpy as jnp

    from ptbxl_torch.ops.kernels.fused_ecgcnn import fold_bn_into_conv
    from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
    from ptbxl_tpu.ops.quant import quantize_model as jax_quantize

    variables, _ = load_npz(CKPT)
    calib = small_battery[:2]
    qj0 = jax_quantize(variables, "ecgcnn", calib_signals=calib)
    qj1 = jax_quantize(variables, "ecgcnn", calib_signals=calib, bias_correct=True)
    q = dict(qj0)
    for k, v in qj0.items():
        if hasattr(v, "shape"):
            a = np.asarray(v)
            q[k] = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                    if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a)))
    folded = fold_bn_into_conv(state)
    x = zscore_per_lead_batch(torch.from_numpy(np.ascontiguousarray(calib.transpose(0, 2, 1))))
    tq._bias_correct_inplace(q, folded, tq.folded_layer_inputs(folded, x), (1, 3))
    for i in (1, 3):
        np.testing.assert_allclose(q[f"b{i}"].numpy(), np.asarray(qj1[f"b{i}"]),
                                   rtol=0, atol=1e-5)


def test_report_matches_jax(state, small_battery):
    """The port's report against JAX's on the same battery and calibration."""
    variables, _ = load_npz(CKPT)
    calib = small_battery[:3]
    got = tqe.quant_accuracy_report(state, "ecgcnn", int8_layers=(1, 3), signals=small_battery,
                                    batch=6, calib_signals=calib, device="cpu")
    want = jqe.quant_accuracy_report(variables, "ecgcnn", int8_layers=(1, 3),
                                     signals=small_battery, batch=6, calib_signals=calib)
    assert got["int8_layers"] == want["int8_layers"] == (1, 3)
    assert got["n"] == want["n"] and got["num_decisions"] == want["num_decisions"]
    for k in ("max", "p99", "p50", "mean"):
        assert abs(got[k] - want[k]) <= 1e-4, k


@pytest.mark.slow
def test_default_calibration_passes_battery_gate(state):
    """The robust default passes the battery gate, the shipped set and JAX's
    (1, 3); demo-pack calibration of (1, 3) does not (the documented tradeoff,
    tests/test_quant_battery.py:71)."""
    bat = tqe.make_battery(n=64)
    for layers in (None, (1, 3)):
        default = tqe.quant_accuracy_report(state, "ecgcnn", int8_layers=layers, signals=bat,
                                            device="cpu")
        assert tqe.passes_battery_gate(default), default
    demo = tqe.quant_accuracy_report(state, "ecgcnn", int8_layers=(1, 3), signals=bat,
                                     calib_signals=tq.demo_pack_signals(), device="cpu")
    assert demo["max"] > tqe.BATTERY_GATE["max"]
