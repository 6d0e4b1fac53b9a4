"""The port's serving artifacts (``ptbxl_torch/serving.py``) against the JAX
package's (``ptbxl_tpu/serving.py``), on the CPU.

The same checkpoint is exported by both packages; a fresh port
``ServingModel`` and a fresh JAX ``ServingModel`` then score the demo pack.
Tolerances (measured in brackets): ``highest`` and multimodal probabilities
1e-5 (1.8e-7, 1.2e-7: two f32 programs that sum in different orders); the
``with_cam`` artifact's probabilities 1e-5 (1.8e-7) and its all-class CAMs
2e-5 (1.2e-6; the bound of tests/test_serving_export.py's CAM artifact
against JAX's ``GradCAM``: the port's CAM backward is ``GradCAM.all_classes``,
written out as tensor ops, JAX's an exported ``jax.vjp``); an int8 artifact
built from one JAX ``save_qparams`` file, at JAX's layer set (1, 3) and the
port's shipped (3,), 1e-4 (6.0e-6, 1.3e-5; the bound of JAX's q-params
through the port's ``Predictor``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ptbxl_torch.serving import ServingModel, export_serving_artifact  # noqa: E402
from ptbxl_tpu.models.params_io import load_npz  # noqa: E402
from ptbxl_tpu.ops import quant as jq  # noqa: E402
from ptbxl_tpu.serving import ServingModel as JaxServingModel  # noqa: E402
from ptbxl_tpu.serving import export_serving_artifact as jax_export  # noqa: E402
from tests.torch_port_common import CKPT, CKPT_MM, demo_signals, mm_demo_pack  # noqa: E402

CPU = "cpu"
PROB_TOL = 1e-5
CAM_TOL = 2e-5
INT8_TOL = 1e-4


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """name -> (port ServingModel, JAX ServingModel), each exported once."""
    d = tmp_path_factory.mktemp("vs_jax")
    variables, _ = load_npz(CKPT)
    variants = {
        "highest": (CKPT, {}),
        "multimodal": (CKPT_MM, {"arch": "multimodal"}),
        "with_cam": (CKPT, {"with_cam": True}),
    }
    for layers in ((1, 3), (3,)):
        qpath = str(d / f"jax_q{''.join(map(str, layers))}.npz")
        jq.save_qparams(jq.quantize_model(variables, arch="ecgcnn", int8_layers=layers,
                                          calib_signals=jq.demo_pack_signals()), qpath)
        variants[f"int8{layers}"] = (CKPT, {"precision": "int8", "qparams": qpath})
    out = {}
    for name, (ckpt, kw) in variants.items():
        port_path, jax_path = str(d / f"{name}.ptbxlpt"), str(d / f"{name}.stablehlo")
        export_serving_artifact(ckpt, port_path, device=CPU, **kw)
        jax_export(ckpt, jax_path, platforms=("cpu",), **kw)
        out[name] = (ServingModel(port_path, device=CPU), JaxServingModel(jax_path))
    return out


def test_highest_artifact_matches_jax(pair):
    port, ref = pair["highest"]
    sigs = demo_signals()
    assert port.classes == ref.classes
    np.testing.assert_allclose(port(sigs), ref(sigs), rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(port(sigs[:1]), ref(sigs[:1]), rtol=0, atol=PROB_TOL)


def test_multimodal_artifact_matches_jax(pair):
    port, ref = pair["multimodal"]
    sigs, demos = mm_demo_pack()
    np.testing.assert_allclose(port(sigs, demo=demos), ref(sigs, demo=demos), rtol=0,
                               atol=PROB_TOL)


def test_cam_artifact_matches_jax(pair):
    port, ref = pair["with_cam"]
    sigs = demo_signals()
    probs, cams = port(sigs)
    ref_probs, ref_cams = ref(sigs)
    assert cams.shape == np.asarray(ref_cams).shape == (7, 5, 5000)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(cams, ref_cams, rtol=0, atol=CAM_TOL)


@pytest.mark.parametrize("layers", [(1, 3), (3,)])
def test_int8_artifact_from_jax_qparams_matches_jax(pair, layers):
    port, ref = pair[f"int8{layers}"]
    assert port.meta["int8_layers"] == list(layers) == list(ref.meta["int8_layers"])
    sigs = demo_signals()
    np.testing.assert_allclose(port(sigs), ref(sigs), rtol=0, atol=INT8_TOL)
