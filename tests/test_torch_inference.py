"""The port's Predictor (ptbxl_torch/inference.py) against the JAX Predictor, on the CPU."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from ptbxl_tpu.inference import Predictor as JaxPredictor  # noqa: E402

from ptbxl_torch.inference import Predictor  # noqa: E402
from ptbxl_torch.ops.kernels import fused_ecgcnn as k2  # noqa: E402
from tests.torch_port_common import CKPT, CKPT_AF, CKPT_MM, demo_signals, golden  # noqa: E402

GOLD_TOL = 5e-4  # Predictor normalizes the pre-normalized demo pack again (test_predictor.py:29)
PARITY_TOL = 2e-5  # same f32 function, sums in another order
BF16_TOL = 5e-3  # bench gate of the bf16 precision


@pytest.fixture(scope="module")
def sigs():
    return demo_signals()


@pytest.fixture(scope="module")
def jax_ref(sigs):
    """JAX Predictor outputs on the demo pack: f32 ('highest') and bf16 ('default')."""
    hi = JaxPredictor.from_checkpoint(CKPT, engine="xla")(sigs)
    lo = JaxPredictor.from_checkpoint(CKPT, engine="xla", precision="default")(sigs)
    return {"highest": hi, "default": lo}


def _port(**kw):
    return Predictor.from_checkpoint(CKPT, device="cpu", **kw)


@pytest.mark.parametrize("engine", ["auto", "kernel", "framework"])
def test_highest_matches_jax_and_golden(sigs, jax_ref, engine):
    probs = _port(engine=engine)(sigs)
    assert probs.dtype == np.float32 and probs.shape == (7, 5)
    np.testing.assert_allclose(probs, jax_ref["highest"], atol=PARITY_TOL)
    np.testing.assert_allclose(probs, golden("baseline")["probs"], atol=GOLD_TOL)


@pytest.mark.parametrize("engine", ["auto", "kernel", "framework"])
def test_default_precision(sigs, jax_ref, engine):
    """'default': bf16 framework engine (the kernel engine stays f32, as in JAX)."""
    probs = _port(engine=engine, precision="default")(sigs)
    np.testing.assert_allclose(probs, jax_ref["default"], atol=BF16_TOL)
    np.testing.assert_allclose(probs, jax_ref["highest"], atol=BF16_TOL)
    if engine != "framework":
        np.testing.assert_allclose(probs, jax_ref["highest"], atol=PARITY_TOL)


def test_af_checkpoint_one_label(sigs):
    p = Predictor.from_checkpoint(CKPT_AF, num_labels=1, device="cpu")
    assert p.classes is None
    want = JaxPredictor.from_checkpoint(CKPT_AF, num_labels=1, engine="xla")(sigs)
    probs = p(sigs)
    np.testing.assert_allclose(probs, want, atol=PARITY_TOL)
    np.testing.assert_allclose(probs, golden("af")["probs"], atol=GOLD_TOL)


@pytest.mark.parametrize("engine", ["kernel", "framework"])
def test_small_batches_bucket_to_pow2(sigs, engine):
    p = _port(engine=engine)
    full = p(sigs)
    for n in (1, 2, 3, 5, 7):
        np.testing.assert_allclose(p(sigs[:n]), full[:n], atol=1e-6)


def test_pad_rows_repeat_the_last_record(sigs, monkeypatch):
    p = _port(engine="kernel")
    seen = []
    orig = p._forward
    monkeypatch.setattr(p, "_forward", lambda x: seen.append(x.clone()) or orig(x))
    p(sigs[:3])
    assert [tuple(x.shape) for x in seen] == [(4, 5000, 12)]
    torch.testing.assert_close(seen[0][3], seen[0][2])


def test_chunking(sigs):
    small = _port(chunk_size=3)
    np.testing.assert_allclose(small(sigs), _port()(sigs), atol=1e-6)


def test_auto_engine_crossover(sigs, monkeypatch):
    """'auto' takes the kernel for chunks up to KERNEL_MAX_BATCH, the framework above."""
    import ptbxl_torch.inference as inf

    monkeypatch.setattr(inf, "KERNEL_MAX_BATCH", 2)
    calls = []
    monkeypatch.setattr(inf, "fused_ecgcnn_probs",
                        lambda *a, **k: calls.append(a[0].shape[0]) or k2.fused_ecgcnn_probs(*a, **k))
    p = _port(chunk_size=4)
    p(sigs[:2])
    assert calls == [2]
    p(sigs[:4])
    assert calls == [2]  # chunk of 4 > 2 went to the framework engine


def test_layouts(sigs):
    p = _port()
    a = p(sigs[:1])                        # [1, 12, T]
    b = p(sigs[:1].transpose(0, 2, 1))     # [1, T, 12]
    c = p(sigs[0])                         # [12, T]
    np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(a, c, atol=1e-6)


def test_empty_input_and_classes():
    p = _port()
    out = p(np.zeros((0, 12, 5000), np.float32))
    assert out.shape == (0, 5) and out.dtype == np.float32
    assert p.classes == ["MI", "STTC", "HYP", "CD", "NORM"]


def test_no_cuda_raises_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.from_checkpoint(CKPT)


def test_multimodal_raises():
    """The multimodal Predictor is ported (tests/test_torch_predictor_mm.py); it raises
    without demo vectors (test_predictor.py:63)."""
    p = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", device="cpu")
    with pytest.raises(ValueError, match="demo"):
        p(demo_signals()[:1])


def test_bad_engine_or_precision():
    """'xla' and 'pallas' are the JAX names of the engines (below); an unknown
    name raises and lists them."""
    with pytest.raises(ValueError, match="engine must be one of .*'xla', 'pallas'"):
        _port(engine="tpu")
    with pytest.raises(ValueError, match="precision"):
        _port(precision="fp8")


@pytest.mark.parametrize("alias,engine", [("xla", "framework"), ("pallas", "kernel")])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_jax_engine_names_are_aliases(sigs, alias, engine, precision):
    """The JAX Predictor's engine names route as the port's own and give the same probs."""
    a, b = _port(engine=alias, precision=precision), _port(engine=engine, precision=precision)
    assert a.engine == b.engine == engine
    for n in (1, 7, 512, 2048):
        assert a._use_kernel(n) == b._use_kernel(n) == (engine == "kernel")
    np.testing.assert_array_equal(a(sigs), b(sigs))
