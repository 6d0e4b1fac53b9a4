"""The port's multimodal Predictor (ptbxl_torch/inference.py, arch='multimodal') and
build_demo_vector (ptbxl_torch/data/demo_vector.py) against the JAX package, on the CPU."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from ptbxl_tpu.data.demo_vector import build_demo_vector as jax_build_demo_vector  # noqa: E402
from ptbxl_tpu.inference import Predictor as JaxPredictor  # noqa: E402

from ptbxl_torch.data.demo_vector import build_demo_vector  # noqa: E402
from ptbxl_torch.inference import Predictor  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k  # noqa: E402
from tests.torch_port_common import CKPT_MM, golden, mm_demo_pack  # noqa: E402

GOLD_TOL = 5e-4  # Predictor z-scores the pre-normalized demo pack again (test_predictor.py:61)
RAW_TOL = 1e-4  # two f32 algorithms on raw signals, sums in other orders
BF16_TOL = 5e-3  # bench gate of the bf16 precision (test_predictor.py:129)


@pytest.fixture(scope="module")
def pack():
    return mm_demo_pack()


def _port(**kw):
    return Predictor.from_checkpoint(CKPT_MM, arch="multimodal", device="cpu", **kw)


@pytest.mark.parametrize("engine", ["auto", "kernel", "framework"])
def test_matches_golden(pack, engine):
    """test_predictor.py:51-61 (multimodal Predictor vs the golden probs)."""
    sigs, demos = pack
    p = _port(engine=engine)
    probs = p(sigs, demo=demos)
    assert probs.dtype == np.float32 and probs.shape == (7, 5)
    np.testing.assert_allclose(probs, golden("multimodal")["probs"], atol=GOLD_TOL)
    assert p.classes == ["MI", "STTC", "HYP", "CD", "NORM"]


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(7)
    sigs = (rng.standard_normal((3, 12, 512)) * rng.uniform(0.5, 2.5, (3, 12, 1))
            + rng.standard_normal((3, 12, 1))).astype(np.float32)
    demos = rng.uniform(0.0, 1.0, (3, 5)).astype(np.float32)
    return sigs, demos


@pytest.mark.parametrize("engine", ["kernel", "framework"])
def test_matches_jax_predictor_on_raw(raw, engine):
    """The JAX Predictor(engine='xla') on raw random signals and demos."""
    sigs, demos = raw
    want = JaxPredictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="xla")(sigs, demo=demos)
    np.testing.assert_allclose(_port(engine=engine)(sigs, demo=demos), want, atol=RAW_TOL)


def test_missing_and_wrong_demo_raise(pack):
    """test_predictor.py:63-64 and inference.py:271-281."""
    sigs, demos = pack
    p = _port()
    with pytest.raises(ValueError, match="demo"):
        p(sigs)
    with pytest.raises(ValueError, match=r"demo must be \[N, 5\]"):
        p(sigs, demo=demos[:6])
    with pytest.raises(ValueError, match=r"demo must be \[N, 5\]"):
        p(sigs, demo=demos[:, :4])


def test_one_record_with_1d_demo(pack):
    """A [5] demo vector is one record's ([1, 5])."""
    sigs, demos = pack
    p = _port(engine="kernel")
    np.testing.assert_allclose(p(sigs[2], demo=demos[2]), p(sigs[2:3], demo=demos[2:3]),
                               atol=1e-6)


def test_default_precision_close_to_highest(pack):
    """test_predictor.py:114-129: precision='default' (bf16 framework, one-pass
    z-score) stays within 5e-3 of 'highest'."""
    sigs, demos = pack
    hi = _port(engine="framework")(sigs[:2], demo=demos[:2])
    lo = _port(engine="framework", precision="default")(sigs[:2], demo=demos[:2])
    assert lo.dtype == np.float32
    assert np.abs(hi - lo).max() < BF16_TOL
    np.testing.assert_allclose(_port(precision="default")(sigs[:2], demo=demos[:2]), hi,
                               atol=2e-5)  # the kernel engine stays f32


def test_default_precision_matches_jax(pack):
    """The bf16 framework path rounds where flax rounds (BatchNorm in f32 then one
    rounding; biases added after the rounded product): within the bf16 gate of the
    JAX Predictor's 'default' on all 7 demo records."""
    sigs, demos = pack
    want = JaxPredictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="xla",
                                        precision="default")(sigs, demo=demos)
    got = _port(engine="framework", precision="default")(sigs, demo=demos)
    np.testing.assert_allclose(got, want, atol=BF16_TOL)


def test_chunking_pads_with_the_last_row(pack, monkeypatch):
    """chunk_size=4 on 7 records: chunks of 4 and 3 (+1 pad row repeating the
    last signal and demo vector, inference.py:309-311)."""
    sigs, demos = pack
    full = _port()(sigs, demo=demos)
    p = _port(chunk_size=4)
    seen = []
    orig = p._forward
    monkeypatch.setattr(p, "_forward", lambda x, d: seen.append((x.clone(), d.clone()))
                        or orig(x, d))
    np.testing.assert_allclose(p(sigs, demo=demos), full, atol=1e-6)
    assert [tuple(d.shape) for _, d in seen] == [(4, 5), (4, 5)]
    torch.testing.assert_close(seen[1][1][3], seen[1][1][2])
    torch.testing.assert_close(seen[1][0][3], seen[1][0][2])


def test_kernel_engine_reaches_k3(pack, monkeypatch):
    """'auto' sends chunks of at most KERNEL_MAX_BATCH to K3, not to K2."""
    import ptbxl_torch.inference as inf

    sigs, demos = pack
    calls = []
    monkeypatch.setattr(inf, "fused_multimodal_probs",
                        lambda *a, **kw: calls.append(a[1].shape) or k.fused_multimodal_probs(*a, **kw))
    monkeypatch.setattr(inf, "fused_ecgcnn_probs", None)
    _port()(sigs[:3], demo=demos[:3])
    assert calls == [(4, 5)]


ROWS = [
    {"age": 56, "sex": "M", "height": 180, "weight": 80, "pacemaker": 0},
    {"age": 72.5, "sex": "F", "height": 160.0, "weight": 55.5, "pacemaker": "ja, pacemaker"},
    {"age": 300, "sex": 1, "height": -3, "weight": float("nan"), "pacemaker": 1},
    {"age": -4, "sex": 0.0, "height": "", "weight": "heavy", "pacemaker": None},
    {"age": float("nan"), "sex": None, "height": float("inf"), "weight": 0},
    {"age": "61", "sex": "m", "height": "170", "weight": "70.5", "pacemaker": "1"},
    {},
]


@pytest.mark.parametrize("row", ROWS, ids=[str(i) for i in range(len(ROWS))])
def test_build_demo_vector_matches_jax(row):
    """data/demo_vector.py: the clamp and fallback rules (test_datasets.py:52)."""
    got = build_demo_vector(row)
    assert got.dtype == np.float32 and got.shape == (5,)
    np.testing.assert_array_equal(got, jax_build_demo_vector(row))
