"""The port's ``conv1d_fast_wgrad`` (ptbxl_torch/ops/fast_wgrad.py) against
autograd's conv and against ptbxl_tpu/ops/fast_wgrad.py.

Mirrors tests/test_fast_wgrad.py: the primal and dx equal autograd's bit for
bit, dw within rtol 1e-5 / atol 1e-4 of autograd's and of JAX's
``conv1d_fast_wgrad`` (fallback case included), and ``_pick_phases``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ptbxl_tpu.ops.fast_wgrad import conv1d_fast_wgrad as jax_fast_wgrad  # noqa: E402

from ptbxl_torch.ops.fast_wgrad import _pick_phases, conv1d_fast_wgrad  # noqa: E402


@pytest.mark.parametrize(
    "B,T,Ci,Co,k,P",
    [(3, 40, 12, 32, 15, 8), (2, 48, 5, 7, 15, 4),
     (2, 30, 4, 6, 7, 2), (2, 33, 4, 6, 7, 8)],  # 33 % 8 != 0 -> fallback
)
def test_grads_match_autograd_and_jax(B, T, Ci, Co, k, P):
    rng = np.random.default_rng(B * T + k)
    xn = rng.standard_normal((B, T, Ci)).astype(np.float32)
    wn = rng.standard_normal((k, Ci, Co)).astype(np.float32)
    pad = (k // 2, k // 2)

    def run(fast):
        x = torch.from_numpy(xn).requires_grad_(True)
        w = torch.from_numpy(wn).requires_grad_(True)
        if fast:
            y = conv1d_fast_wgrad(x, w, pad, None, P)
        else:
            y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=k // 2).transpose(1, 2)
        v = torch.sum(torch.sin(y))
        v.backward()
        return y.detach(), float(v.detach()), x.grad, w.grad

    yr, vr, gxr, gwr = run(False)
    yf, vf, gxf, gwf = run(True)
    assert torch.equal(yr, yf) and vr == vf  # identical primal
    assert torch.equal(gxr, gxf)
    np.testing.assert_allclose(gwf.numpy(), gwr.numpy(), rtol=1e-5, atol=1e-4)

    def jax_fast(x, w):
        return jnp.sum(jnp.sin(jax_fast_wgrad(x, w, pad, None, P)))

    gwj = jax.grad(jax_fast, argnums=1)(jnp.asarray(xn), jnp.asarray(wn))
    np.testing.assert_allclose(gwf.numpy(), np.asarray(gwj), rtol=1e-5, atol=1e-4)


def test_asymmetric_padding_and_weight_only_grad():
    """JAX's padding is a (pl, pr) pair: an asymmetric one pads the input first;
    with x constant (the input layer) only the weight gradient is formed."""
    rng = np.random.default_rng(11)
    xn = rng.standard_normal((2, 32, 3)).astype(np.float32)
    wn = rng.standard_normal((5, 3, 4)).astype(np.float32)
    x = torch.from_numpy(xn)
    w = torch.from_numpy(wn).requires_grad_(True)
    y = conv1d_fast_wgrad(x, w, (1, 3), None, 8)
    want = F.conv1d(F.pad(x.transpose(1, 2), (1, 3)), w.detach().permute(2, 1, 0)).transpose(1, 2)
    assert torch.equal(y.detach(), want)
    torch.sum(torch.sin(y)).backward()

    def jax_fast(w):
        return jnp.sum(jnp.sin(jax_fast_wgrad(jnp.asarray(xn), w, (1, 3), None, 8)))

    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jax.grad(jax_fast)(jnp.asarray(wn))),
                               rtol=1e-5, atol=1e-4)


def test_pick_phases():
    assert [_pick_phases(t) for t in (5000, 2500, 1250, 625)] == [8, 4, 2, 1]
