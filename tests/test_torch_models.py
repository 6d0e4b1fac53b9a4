"""The port's ECGCNN (ptbxl_torch/models) against the goldens and the JAX model."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402

from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.models.factory import build_ecgcnn, load_ecgcnn  # noqa: E402
from ptbxl_torch.models.params_io import from_flax_variables  # noqa: E402
from tests.torch_port_common import CKPT, CKPT_AF, demo_signals, golden  # noqa: E402

PROB_TOL = 2e-5  # test_model_parity.py:26


def _demo_x():
    return torch.from_numpy(demo_signals().transpose(0, 2, 1).copy())  # [7, T, 12]


@pytest.mark.parametrize("path,labels,name", [(CKPT, 5, "baseline"), (CKPT_AF, 1, "af")])
def test_goldens(path, labels, name):
    model, _ = load_ecgcnn(path, num_labels=labels, device="cpu")
    with torch.no_grad():
        probs = torch.sigmoid(model(_demo_x())).numpy()
    np.testing.assert_allclose(probs, golden(name)["probs"], atol=PROB_TOL)


def test_features_shape_and_pool_floor():
    model, _ = load_ecgcnn(CKPT, device="cpu")
    x = torch.zeros(1, 5000, 12)
    with torch.no_grad():
        a = model.features(x)
        assert tuple(a.shape) == (1, 625, 256)  # 5000 -> 2500 -> 1250 -> 625 (tap)
        logits, z = model(torch.zeros(2, 5000, 12), return_features=True)
    assert tuple(logits.shape) == (2, 5) and tuple(z.shape) == (2, 256)


@pytest.fixture(scope="module")
def jax_and_port():
    jm, variables = jax_build_ecgcnn(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    # non-trivial BN statistics, so the BatchNorm mapping is exercised
    rng = np.random.default_rng(11)
    for i in range(4):
        bn = variables["batch_stats"][f"blocks_{i}"]["bn"]
        bn["mean"] = rng.standard_normal(bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    pm = ECGCNN(num_labels=5)
    pm.load_state_dict(from_flax_variables(variables), strict=True)
    return jm, variables, pm.eval()


@pytest.mark.parametrize("t", [512, 500])
def test_matches_jax_apply_on_random_input(jax_and_port, t):
    jm, variables, pm = jax_and_port
    x = np.random.default_rng(t).standard_normal((2, t, 12)).astype(np.float32)
    want_logits, want_z = jm.apply(variables, jnp.asarray(x), False, True)
    want_a = jm.apply(variables, jnp.asarray(x), False, method=jm.features)
    with torch.no_grad():
        got_logits, got_z = pm(torch.from_numpy(x), return_features=True)
        got_a = pm.features(torch.from_numpy(x))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-5)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), atol=1e-5)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-5)


def test_bf16_dtype_close_to_f32():
    """dtype=bfloat16 (the 'default' precision) stays within the bench gate (5e-3)."""
    hi, _ = load_ecgcnn(CKPT, device="cpu")
    lo, _ = load_ecgcnn(CKPT, device="cpu", dtype=torch.bfloat16, precision=None)
    x = _demo_x()[:3]
    with torch.no_grad():
        p_hi = torch.sigmoid(hi(x).float())
        p_lo = torch.sigmoid(lo(x).float())
    assert float((p_hi - p_lo).abs().max()) < 5e-3


def test_torch_init_distribution():
    """torch_init=True: kernels and biases ~ U(+-1/sqrt(fan_in)); False: flax's
    lecun-normal kernels and zero biases (test_model_parity.py:128)."""
    m = build_ecgcnn(num_labels=5, seed=0, torch_init=True, device="cpu")
    w = m.backbone[0].net[0].weight.detach()  # [32, 12, 15]
    bound = (15 * 12) ** -0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert abs(float(w.std()) - bound / np.sqrt(3)) < 0.15 * bound
    b = m.backbone[0].net[0].bias.detach()
    assert 0 < float(b.abs().max()) <= bound
    assert float(m.head.weight.detach().abs().max()) <= 256 ** -0.5

    m0 = build_ecgcnn(num_labels=5, seed=0, device="cpu")
    assert float(m0.backbone[0].net[0].bias.detach().abs().max()) == 0.0
    w0 = m0.backbone[0].net[0].weight.detach()
    std = (1.0 / 180) ** 0.5
    assert abs(float(w0.std()) - std) < 0.1 * std
    assert float(w0.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6


def test_seeded_build_is_deterministic():
    a = build_ecgcnn(seed=3, device="cpu").state_dict()
    b = build_ecgcnn(seed=3, device="cpu").state_dict()
    c = build_ecgcnn(seed=4, device="cpu").state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k])
    assert not torch.equal(a["proj.weight"], c["proj.weight"])


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_ecgcnn()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_ecgcnn(CKPT)
