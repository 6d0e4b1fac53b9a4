"""The port's weight bridge (ptbxl_torch/models/params_io.py) against the JAX package."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.models.params_io import (  # noqa: E402
    export_pth,
    flax_to_torch_ecgcnn,
    load_npz as jax_load_npz,
)
from ptbxl_tpu.ops.pallas.fused_ecgcnn import fold_bn_into_conv as jax_fold  # noqa: E402

from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.models.factory import load_ecgcnn, merge_state  # noqa: E402
from ptbxl_torch.models.params_io import (  # noqa: E402
    from_flax_variables,
    load_checkpoint,
    load_npz,
    read_pth,
)
from ptbxl_torch.ops.kernels.fused_ecgcnn import fold_bn_into_conv  # noqa: E402
from tests.torch_port_common import CKPT, CKPT_AF, CKPT_MM  # noqa: E402


def _n_params(model):
    return sum(p.numel() for p in model.parameters())


@pytest.fixture(scope="module")
def jax_seed0():
    _, variables = jax_build_ecgcnn(num_labels=5, seed=0)
    return jax.device_get(variables)


def test_bridge_matches_jax_mapping(jax_seed0):
    got = from_flax_variables(jax_seed0)
    want = flax_to_torch_ecgcnn(jax_seed0)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_bridge_loads_into_port_model_strictly(jax_seed0):
    model = ECGCNN(num_labels=5)
    model.load_state_dict(from_flax_variables(jax_seed0), strict=True)
    assert _n_params(model) == 719_397


@pytest.mark.parametrize("path,labels,count", [(CKPT, 5, 719_397), (CKPT_AF, 1, 718_369)])
def test_checkpoint_param_counts(path, labels, count):
    model, classes = load_ecgcnn(path, num_labels=labels, device="cpu")
    assert _n_params(model) == count
    assert classes == (["MI", "STTC", "HYP", "CD", "NORM"] if labels == 5 else None)


@pytest.mark.parametrize("path", [CKPT, CKPT_AF, CKPT_MM])
def test_load_npz_matches_jax(path):
    got, got_cls = load_npz(path)
    want, want_cls = jax_load_npz(path)
    assert got_cls == want_cls
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (_, a), (_, b) in zip(gl, wl):
        np.testing.assert_array_equal(a, b)


def test_multimodal_arch_not_ported_yet():
    """The multimodal arch loads, and so does the 'backbone' of the warm start:
    an ECGCNN checkpoint's conv blocks and proj, without the head; an unknown
    arch raises."""
    state, classes = load_checkpoint(CKPT_MM, arch="multimodal")
    assert "film_gen.weight" in state and classes == ["MI", "STTC", "HYP", "CD", "NORM"]
    full, _ = load_checkpoint(CKPT)
    bb, _ = load_checkpoint(CKPT, arch="backbone")
    assert set(bb) == {k for k in full if not k.startswith("head.")}
    for k, v in bb.items():
        torch.testing.assert_close(v, full[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="arch"):
        load_checkpoint(CKPT, arch="resnet")


@pytest.mark.parametrize("path", [CKPT, CKPT_AF])
def test_fold_bn_matches_jax(path):
    variables, _ = jax_load_npz(path)
    want = jax_fold(variables)
    state, _ = load_checkpoint(path)
    got = fold_bn_into_conv(state)
    assert got["n_blocks"] == want["n_blocks"] == 4
    for k, v in want.items():
        if k == "n_blocks":
            continue
        assert tuple(got[k].shape) == tuple(v.shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("wrapped", [True, False])
def test_pth_roundtrip(tmp_path, jax_seed0, wrapped):
    """A reference .pth (JAX's export, or a bare state dict) reads back equal."""
    path = str(tmp_path / "ref.pth")
    classes = ["MI", "STTC", "HYP", "CD", "NORM"]
    if wrapped:
        export_pth(path, jax_seed0, arch="ecgcnn", classes=classes)
    else:
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in flax_to_torch_ecgcnn(jax_seed0).items()}, path)
    state, got_cls = read_pth(path)
    assert got_cls == (classes if wrapped else None)
    want = from_flax_variables(jax_seed0)
    for k, v in want.items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)
    model, _ = load_ecgcnn(path, device="cpu")
    np.testing.assert_array_equal(model.head.weight.detach().numpy(), want["head.weight"].numpy())


def test_strict_and_lenient_merge(jax_seed0):
    state = from_flax_variables(jax_seed0)
    partial = {k: v for k, v in state.items() if not k.startswith("head.")}
    model = ECGCNN(num_labels=5)
    with pytest.raises(KeyError, match="head.weight"):
        merge_state(model, partial, strict=True)
    init_head = model.head.weight.detach().clone()
    merge_state(model, partial, strict=False)
    torch.testing.assert_close(model.head.weight.detach(), init_head)  # keeps init
    torch.testing.assert_close(model.proj.weight.detach(), state["proj.weight"])
    bad = dict(state, **{"head.weight": torch.zeros(3, 256)})
    with pytest.raises(ValueError, match="Shape mismatch"):
        merge_state(ECGCNN(num_labels=5), bad, strict=True)
