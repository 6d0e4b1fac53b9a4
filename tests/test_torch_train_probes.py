"""The port's training-backward probes and int8 prototype
(ptbxl_torch/tools/{probe_phase_forms,probe_pool,probe_bwd_breakdown,
probe_train_gap,proto_int8}.py) on the CPU at tiny sizes.

Each probe runs end to end and prints its rows (host clocks: a wiring check,
no device measurement); the forms each probe compares compute the same
function (phase forms within 1e-5 of ``conv_s1`` in f32, pool forms' values
and gradients equal away from ties, the fast-wgrad rung's loss equal and its
gradients within 1e-5 of the standard rung's); ``proto_int8``'s
``quantize_weights`` and ``calibrate`` equal JAX's (int8 exact, scales 1e-6)
and its forward is within 1e-4 of JAX's ``make_int8_forward``.
"""

import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.models.params_io import load_npz  # noqa: E402
from ptbxl_tpu.ops.pallas.fused_ecgcnn import fold_bn_into_conv as jax_fold  # noqa: E402
from ptbxl_tpu.ops.preprocess import zscore_per_lead_batch as jax_zscore  # noqa: E402

from ptbxl_torch.models.ecg_cnn import ConvBlock  # noqa: E402
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch  # noqa: E402
from ptbxl_torch.tools import (  # noqa: E402
    probe_bwd_breakdown,
    probe_phase_forms,
    probe_pool,
    probe_train_gap,
    proto_int8,
)
from tests.torch_port_common import CKPT, HERE  # noqa: E402

TINY = ["--batch", "2", "--t", "32", "--iters", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def jax_proto():
    spec = importlib.util.spec_from_file_location(
        "proto_int8_jax", os.path.join(HERE, "tools", "proto_int8.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_probe_phase_forms(dtype, capsys):
    assert probe_phase_forms.main(TINY + ["--dtype", dtype]) == 0
    out = capsys.readouterr().out
    assert out.count("conv_s2p") == 3 and out.count("tail3d") == 3
    if dtype == "f32":
        for r in probe_phase_forms.run(2, "f32", 32, 1, "cpu"):
            assert r["err_s2p"] <= 1e-5 and r["err_pair"] <= 1e-5, r


def test_probe_pool_forms_agree(capsys):
    assert probe_pool.main(TINY + ["--dtype", "f32"]) == 0
    out = capsys.readouterr().out
    assert "k6 (port default)" in out and out.count("fwd+bwd") == len(probe_pool.FORMS)
    x = torch.randn(2, 8, 21, generator=torch.Generator().manual_seed(0), requires_grad=True)
    g = torch.randn(2, 8, 10, generator=torch.Generator().manual_seed(1))
    ref_y = probe_pool.FORMS["rw"](x)
    (ref_dx,) = torch.autograd.grad(ref_y, x, g)
    for name, pool in probe_pool.FORMS.items():
        y = pool(x)
        (dx,) = torch.autograd.grad(y, x, g)
        assert torch.equal(y, ref_y), name
        assert torch.equal(dx, ref_dx), name


def test_probe_bwd_breakdown(capsys):
    assert probe_bwd_breakdown.main(TINY) == 0
    out = capsys.readouterr().out
    assert "block3 bwd slice" in out and "freeze k4 kernel" in out and "fast_wgrad b1" in out
    # the fast-wgrad rung computes the standard rung's step
    batch = probe_train_gap.make_batch(2, 32, torch.device("cpu"))
    x0 = zscore_per_lead_batch(batch["ecg"])
    grads = []
    for fast in (False, True):
        m = probe_train_gap.make_model("f32", torch.device("cpu"))
        loss = probe_train_gap.masked_bce(probe_bwd_breakdown.forward(m, x0, fast_block1=fast),
                                          batch)
        loss.backward()
        grads.append((float(loss.detach()), {n: p.grad for n, p in m.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for n, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][n], g, rtol=1e-5, atol=1e-6, msg=n)
    w = m.backbone[0].net[0].weight
    with probe_bwd_breakdown.frozen([w]):
        assert not w.requires_grad
    assert w.requires_grad


def test_probe_train_gap(capsys):
    assert probe_train_gap.main(TINY) == 0
    lines = capsys.readouterr().out.splitlines()[1:]
    assert [ln.split()[0] for ln in lines] == ["fwdbwd", "fwdbwd_stats", "fwdbwd_carry",
                                               "step_sgd", "step_adamw_hoistz", "step_adamw"]
    m = probe_train_gap.make_model("f32", torch.device("cpu")).train()
    before = m.backbone[0].net[1].running_mean.clone()
    orig = ConvBlock._train_batch_norm
    with probe_train_gap.running_stats_off():
        m(torch.randn(2, 32, 12))
    assert ConvBlock._train_batch_norm is orig
    assert torch.equal(m.backbone[0].net[1].running_mean, before)


def test_proto_int8_matches_jax(jax_proto):
    variables, _ = load_npz(CKPT)
    jf = jax_fold(variables)
    jf = {k: (jnp.asarray(v, jnp.float32) if hasattr(v, "shape") else v) for k, v in jf.items()}
    folded = {k: (torch.from_numpy(np.array(v)) if hasattr(v, "shape") else v)
              for k, v in jf.items()}
    x = proto_int8.demo_pack()
    xz = np.asarray(jax_zscore(jnp.asarray(x)))

    want_s = jax_proto.calibrate(jf, jnp.asarray(xz))
    got_s = proto_int8.calibrate(folded, torch.from_numpy(np.array(xz)))
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    want_q = jax_proto.quantize_weights(jf, want_s)
    got_q = proto_int8.quantize_weights(folded, want_s)
    for k, v in want_q.items():
        if k == "n_blocks":
            assert got_q[k] == v
        elif k.startswith("w"):
            np.testing.assert_array_equal(got_q[k].numpy(), np.asarray(v), err_msg=k)
        else:
            np.testing.assert_allclose(got_q[k].numpy(), np.asarray(v), rtol=1e-6, err_msg=k)
    for _, layers in proto_int8.LAYER_SETS:
        want = np.asarray(jax_proto.make_int8_forward(want_q, int8_layers=set(layers),
                                                      folded=jf)(jnp.asarray(x)))
        got = proto_int8.make_int8_forward(got_q, int8_layers=layers, folded=folded)(
            torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=str(layers))


def test_proto_int8_main(capsys):
    assert proto_int8.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name, _ in proto_int8.LAYER_SETS:
        assert f"{name:8s}: max|dprob|=" in out
    assert "rec/s" not in out  # no timing rows off the card
