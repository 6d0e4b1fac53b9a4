"""The port's Grad-CAM (ptbxl_torch/interpret) against the goldens and JAX."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.interpret.grad_cam import GradCAM as JaxGradCAM  # noqa: E402
from ptbxl_tpu.interpret.grad_cam import linear_interpolate_1d as jax_interp  # noqa: E402
from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402

from ptbxl_torch import demo_inference  # noqa: E402
from ptbxl_torch.interpret.grad_cam import GradCAM, batch_grad_cam, linear_interpolate_1d  # noqa: E402
from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.models.factory import load_ecgcnn  # noqa: E402
from ptbxl_torch.models.params_io import from_flax_variables  # noqa: E402
from tests.torch_port_common import CKPT, CKPT_AF, HERE, demo_signals, golden  # noqa: E402

PROB_TOL = 2e-5
CAM_TOL = 2e-3  # CAMs amplify conv rounding through min-max normalization (test_model_parity.py:27)


@pytest.fixture(scope="module")
def demo_x():
    return torch.from_numpy(demo_signals().transpose(0, 2, 1).copy())


@pytest.fixture(scope="module")
def baseline():
    return load_ecgcnn(CKPT, device="cpu", strict=False)[0]


def test_baseline_cam_demo_golden(baseline, demo_x):
    g = golden("baseline")
    probs, cam = GradCAM(baseline, signal_length=5000, norm_first=False, eps=1e-9)(demo_x, 0)
    assert tuple(cam.shape) == (7, 5000)
    np.testing.assert_allclose(probs.numpy(), g["probs"], atol=PROB_TOL)
    np.testing.assert_allclose(cam.numpy(), g["cam_demo"], atol=CAM_TOL)


def test_baseline_cam_library_golden(baseline, demo_x):
    _, cam = GradCAM(baseline, signal_length=5000, norm_first=True)(demo_x, 0)
    np.testing.assert_allclose(cam.numpy(), golden("baseline")["cam_library"], atol=CAM_TOL)


def test_af_cam_golden(demo_x):
    model, _ = load_ecgcnn(CKPT_AF, num_labels=1, device="cpu")
    g = golden("af")
    probs, cam = GradCAM(model, signal_length=5000, eps=1e-9)(demo_x, 0)
    np.testing.assert_allclose(probs.numpy(), g["probs"], atol=PROB_TOL)
    np.testing.assert_allclose(cam.numpy(), g["cam"], atol=CAM_TOL)


@pytest.mark.parametrize("norm_first", [False, True])
def test_multi_equals_per_class(baseline, demo_x, norm_first):
    fn = GradCAM(baseline, signal_length=5000, norm_first=norm_first)
    x = demo_x[:2]
    probs, cams = batch_grad_cam(fn, x, [0, 2, 4])
    assert tuple(cams.shape) == (3, 2, 5000)
    for n, ci in enumerate([0, 2, 4]):
        p1, c1 = fn(x, ci)
        torch.testing.assert_close(p1, probs)
        torch.testing.assert_close(c1, cams[n], atol=1e-6, rtol=0)


def test_matches_jax_gradcam_on_random_model():
    """Same seeded weights in both frameworks, raw-scale random input, T'=T/8 kept."""
    jm, variables = jax_build_ecgcnn(num_labels=5, seed=0)
    variables = jax.device_get(variables)
    pm = ECGCNN(num_labels=5)
    pm.load_state_dict(from_flax_variables(variables), strict=True)
    x = np.random.default_rng(5).standard_normal((2, 512, 12)).astype(np.float32)
    jp, jc = JaxGradCAM(jm, variables, signal_length=None, norm_first=True)(jnp.asarray(x), 3)
    tp, tc = GradCAM(pm, signal_length=None, norm_first=True)(torch.from_numpy(x), 3)
    assert tuple(tc.shape) == (2, 64)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=PROB_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=CAM_TOL)


@pytest.mark.parametrize("in_len,out_len", [(625, 5000), (7, 20), (20, 7), (64, 64), (1, 5)])
def test_linear_interpolate_matches_jax(in_len, out_len):
    x = np.random.default_rng(in_len).standard_normal((3, in_len)).astype(np.float32)
    want = np.asarray(jax_interp(jnp.asarray(x), out_len))
    got = linear_interpolate_1d(torch.from_numpy(x), out_len).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_linear_interpolate_matches_torch_interpolate():
    x = torch.randn(2, 625, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.interpolate(x[:, None], size=5000, mode="linear",
                                           align_corners=False)[:, 0]
    torch.testing.assert_close(linear_interpolate_1d(x, 5000), want, atol=1e-6, rtol=0)


def test_multimodal_not_ported_yet(baseline):
    """multimodal=True is ported (tests/test_torch_multimodal.py); on an ECGCNN it is refused."""
    with pytest.raises(TypeError, match="multimodal=True"):
        GradCAM(baseline, multimodal=True)


def test_demo_cli_on_cpu(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    args = demo_inference.parse_args([
        "--demo_path", os.path.join(HERE, "data/demo/single/single_sample_00.npz"),
        "--ckpt", CKPT, "--out_dir", str(tmp_path), "--device", "cpu"])
    path = demo_inference.main(args)
    assert os.path.getsize(path) > 0 and path.endswith("single_sample_00_gradcam_MI.png")
    out = capsys.readouterr().out
    p_mi = golden("baseline")["probs"][0, 0]
    assert f"MI: {p_mi:.3f}" in out
