"""The port's FiLM multimodal model (ptbxl_torch/models/ecg_multimodal.py), its weight
bridge and its Grad-CAM / demo importance, against the goldens and the JAX package."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.interpret.grad_cam import GradCAM as JaxGradCAM  # noqa: E402
from ptbxl_tpu.interpret.grad_cam import batch_grad_cam as jax_batch_grad_cam  # noqa: E402
from ptbxl_tpu.interpret.grad_cam import demo_importance as jax_demo_importance  # noqa: E402
from ptbxl_tpu.models.ecg_multimodal import ECGMultimodal as JaxECGMultimodal  # noqa: E402
from ptbxl_tpu.models.factory import build_multimodal as jax_build_multimodal  # noqa: E402
from ptbxl_tpu.models.params_io import export_pth, flax_to_torch_multimodal  # noqa: E402

from ptbxl_torch.interpret.grad_cam import GradCAM, batch_grad_cam, demo_importance  # noqa: E402
from ptbxl_torch.interpret.plotting import plot_ecg_and_demo_importance  # noqa: E402
from ptbxl_torch.models.ecg_multimodal import ECGMultimodal  # noqa: E402
from ptbxl_torch.models.factory import build_multimodal, load_multimodal  # noqa: E402
from ptbxl_torch.models.params_io import from_flax_variables, load_checkpoint  # noqa: E402
from tests.torch_port_common import CKPT_MM, golden, mm_demo_pack  # noqa: E402

PROB_TOL = 2e-5  # test_model_parity.py:26
CAM_TOL = 2e-3  # test_model_parity.py:27
IMP_TOL = 1e-4  # test_model_parity.py:95
LOGIT_TOL = 1e-5  # same f32 function in both frameworks, sums in another order


def _n_params(model):
    return sum(p.numel() for p in model.parameters())


@pytest.fixture(scope="module")
def golden_model():
    return load_multimodal(CKPT_MM, device="cpu")


@pytest.fixture(scope="module")
def jax_seed0():
    """Full-width JAX model, seed 0, with non-trivial BN statistics."""
    jm, variables = jax_build_multimodal(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    rng = np.random.default_rng(11)
    for i in range(4):
        bn = variables["batch_stats"]["ecg_backbone"][f"blocks_{i}"]["bn"]
        bn["mean"] = rng.standard_normal(bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return jm, variables


@pytest.fixture(scope="module")
def narrow():
    """A narrow JAX model (channels 8/16/32, feat 32, hidden 16) and its port."""
    jm = JaxECGMultimodal(feat_dim=32, demo_hidden_dim=16, channels=(8, 16, 32), num_labels=5)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 12)),
                                       jnp.zeros((1, 5))))
    pm = ECGMultimodal(feat_dim=32, demo_hidden_dim=16, channels=(8, 16, 32), num_labels=5)
    pm.load_state_dict(from_flax_variables(variables, "multimodal"), strict=True)
    return jm, variables, pm.eval()


def _rand(seed, b, t):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, 12)) * 2 + 1).astype(np.float32)
    d = rng.uniform(0.0, 1.0, (b, 5)).astype(np.float32)
    return x, d


def test_param_count_and_classes(golden_model):
    """test_model_parity.py:56 (757,221 parameters)."""
    model, classes = golden_model
    assert _n_params(model) == 757_221
    assert classes == ["MI", "STTC", "HYP", "CD", "NORM"]


def test_bridge_matches_jax_mapping(jax_seed0):
    """test_params_io.py: the reference state-dict layout of flax_to_torch_multimodal."""
    _, variables = jax_seed0
    got = from_flax_variables(variables, "multimodal")
    want = flax_to_torch_multimodal(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_matches_jax_apply_on_random_model(jax_seed0):
    """test_model_parity.py:76 on a random-init model: logits and the features tap."""
    jm, variables = jax_seed0
    pm = ECGMultimodal(num_labels=5)
    pm.load_state_dict(from_flax_variables(variables, "multimodal"), strict=True)
    x, d = _rand(0, 2, 512)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(d), False))
    want_a = np.asarray(jm.apply(variables, jnp.asarray(x), False, method=jm.features))
    with torch.no_grad():
        a = pm.eval().features(torch.from_numpy(x))
        got = pm(torch.from_numpy(x), torch.from_numpy(d)).numpy()
    assert tuple(a.shape) == (2, 64, 256)  # 512 -> 256 -> 128 -> 64 (tap)
    np.testing.assert_allclose(a.numpy(), want_a, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL)


def test_golden_probs_cam_importance(golden_model):
    """test_model_parity.py:76-95: probs, CAM (eps 1e-8, interpolate then normalize)
    and demo_importance on the 7 multimodal demo records, one record a call."""
    model, _ = golden_model
    g = golden("multimodal")
    sigs, demos = mm_demo_pack()
    cam_fn = GradCAM(model, signal_length=5000, norm_first=False, eps=1e-8, multimodal=True)
    for i in range(7):
        x = sigs[i:i + 1].transpose(0, 2, 1)
        d = demos[i:i + 1]
        probs, cam = cam_fn(x, 0, x_demo=d)
        np.testing.assert_allclose(probs.numpy()[0], g["probs"][i], atol=PROB_TOL)
        np.testing.assert_allclose(cam.numpy()[0], g["cam"][i], atol=CAM_TOL)
        imp = demo_importance(model, x, d, class_idx=0)
        assert tuple(imp.shape) == (5,)
        np.testing.assert_allclose(imp.numpy(), g["demo_importance"][i], atol=IMP_TOL)


def test_golden_probs_batched(golden_model):
    """The 7 records as one batch give the golden probs (test_model_parity.py:76)."""
    model, _ = golden_model
    sigs, demos = mm_demo_pack()
    with torch.no_grad():
        probs = torch.sigmoid(model(torch.from_numpy(sigs.transpose(0, 2, 1).copy()),
                                    torch.from_numpy(demos))).numpy()
    np.testing.assert_allclose(probs, golden("multimodal")["probs"], atol=PROB_TOL)


@pytest.mark.parametrize("norm_first", [False, True])
def test_batch_grad_cam_matches_jax(narrow, norm_first):
    """test_interpret_extras.py:49 (batch_grad_cam with x_demo), held against JAX."""
    jm, variables, pm = narrow
    x, d = _rand(1, 2, 256)
    jfn = JaxGradCAM(jm, variables, signal_length=256, norm_first=norm_first, eps=1e-8,
                     multimodal=True)
    jp, jc = jax_batch_grad_cam(jfn, jnp.asarray(x), [1, 3], x_demo=jnp.asarray(d))
    fn = GradCAM(pm, signal_length=256, norm_first=norm_first, eps=1e-8, multimodal=True)
    tp, tc = batch_grad_cam(fn, x, [1, 3], x_demo=d)
    assert tuple(tc.shape) == (2, 2, 256)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=PROB_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=CAM_TOL)
    for slot, ci in enumerate([1, 3]):
        p1, c1 = fn(x, ci, x_demo=d)
        torch.testing.assert_close(p1, tp)
        torch.testing.assert_close(c1, tc[slot], atol=1e-6, rtol=0)


def test_demo_importance_matches_jax_on_batch(narrow):
    """test_model_parity.py:93 on B=2: record 0 alone, as in the reference."""
    jm, variables, pm = narrow
    x, d = _rand(2, 2, 256)
    want = np.asarray(jax_demo_importance(jm, variables, jnp.asarray(x), jnp.asarray(d), 2))
    got = demo_importance(pm, x, d, 2).numpy()
    np.testing.assert_allclose(got, want, atol=IMP_TOL)
    assert got.max() == pytest.approx(1.0)


def test_demo_importance_of_zero_demo_is_zero(narrow):
    """max == 0: no division (grad_cam.py:239-240)."""
    _, _, pm = narrow
    x, _ = _rand(3, 1, 128)
    imp = demo_importance(pm, x, np.zeros((1, 5), np.float32), 0)
    assert torch.equal(imp, torch.zeros(5))


def test_gradcam_needs_demo(narrow):
    _, _, pm = narrow
    x, _ = _rand(4, 1, 128)
    with pytest.raises(ValueError, match="x_demo"):
        GradCAM(pm, multimodal=True)(x, 0)


@pytest.mark.parametrize("wrapped", [True, False])
def test_pth_loads_through_load_checkpoint(tmp_path, jax_seed0, wrapped):
    """A reference-layout .pth (JAX's export, or a bare torch.save state dict)
    loads through load_checkpoint(..., 'multimodal') (test_params_io.py)."""
    _, variables = jax_seed0
    path = str(tmp_path / "mm.pth")
    if wrapped:
        export_pth(path, variables, arch="multimodal", classes=["a", "b", "c", "d", "e"])
    else:
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in flax_to_torch_multimodal(variables).items()}, path)
    state, classes = load_checkpoint(path, arch="multimodal")
    assert classes == (["a", "b", "c", "d", "e"] if wrapped else None)
    want = from_flax_variables(variables, "multimodal")
    for k, v in want.items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)
    model, _ = load_multimodal(path, device="cpu")
    np.testing.assert_array_equal(model.film_gen.weight.detach().numpy(),
                                  want["film_gen.weight"].numpy())


@pytest.mark.parametrize("torch_init", [False, True])
def test_build_multimodal_seeded(torch_init):
    """factory.build_multimodal: the seed decides the weights; torch_init is
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with biases (test_model_parity.py:128)."""
    a = build_multimodal(seed=0, torch_init=torch_init, device="cpu")
    b = build_multimodal(seed=0, torch_init=torch_init, device="cpu")
    c = build_multimodal(seed=1, torch_init=torch_init, device="cpu")
    torch.testing.assert_close(a.film_gen.weight, b.film_gen.weight, rtol=0, atol=0)
    assert not torch.equal(a.film_gen.weight, c.film_gen.weight)
    assert _n_params(a) == 757_221 and not a.training
    fc1 = a.demo_encoder.mlp[0]
    if torch_init:
        assert fc1.weight.abs().max() <= 5 ** -0.5 and fc1.bias.abs().max() > 0
    else:
        assert torch.equal(fc1.bias, torch.zeros(64))


def test_plot_ecg_and_demo_importance(tmp_path):
    """test_interpret_extras.py: the two-panel figure is written."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    path = str(tmp_path / "mm.png")
    plot_ecg_and_demo_importance(rng.standard_normal((12, 200)), rng.uniform(size=200),
                                 rng.uniform(size=5), ["age", "sex", "height", "weight", "pm"],
                                 0, "t", path)
    assert os.path.getsize(path) > 1000
