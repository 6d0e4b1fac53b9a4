"""K6 (ptbxl_torch/ops/kernels/relu_pool.py) and relu_max_pool2
(ptbxl_torch/ops/relu_pool.py) against ptbxl_tpu/ops/relu_pool.py.

Mirrors tests/test_relu_pool.py on the port's [B, C, T] layout (the JAX
functions take [B, T, C]; inputs are transposed).  On the CPU the kernel
wrapper runs its plain version; chip_smoke.py holds the CUDA kernel against
that plain version on the card at max |diff| 0.0.  K6 is a select and a
division by 1 or 2, so every comparison with the JAX backward is exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.ops.relu_pool import (  # noqa: E402
    _jnp_bwd,
    _pallas_bwd,
    _xla_relu_pool,
)

from ptbxl_torch.ops import relu_pool as rp  # noqa: E402
from ptbxl_torch.ops.kernels import relu_pool as k6  # noqa: E402

AUTODIFF_TOL = 1e-6  # test_relu_pool.py:57, away from exact positive ties


def _t(a: np.ndarray) -> torch.Tensor:
    """JAX [B, T, C] numpy -> port [B, C, T] tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


def _j(t: torch.Tensor) -> np.ndarray:
    """Port [B, C, T] -> JAX [B, T, C] numpy (f32)."""
    return t.float().numpy().transpose(0, 2, 1)


def _data(shape, seed, ties=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(shape).astype(np.float32)
    if ties:  # quarter steps: many windows with equal positive values
        h = np.round(h * 4) / 4
    g = rng.standard_normal((shape[0], shape[1] // 2, shape[2])).astype(np.float32)
    return h, g


@pytest.mark.parametrize("shape", [(4, 16, 8), (3, 25, 16), (2, 625, 256)])
def test_forward_identical_to_jax(shape):
    h, _ = _data(shape, sum(shape))
    want = np.asarray(_xla_relu_pool(jnp.asarray(h)))
    ht = _t(h)
    np.testing.assert_array_equal(_j(rp.relu_max_pool2(ht)), want)
    with rp.force_framework_pool_bwd():
        np.testing.assert_array_equal(_j(rp.relu_max_pool2(ht)), want)
    np.testing.assert_array_equal(_j(rp.relu_max_pool2(ht.requires_grad_(True)).detach()), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(4, 16, 8), (3, 25, 16), (2, 5000, 32), (1, 625, 256),
                                   (2, 2500, 64)])
def test_plain_k6_matches_jnp_bwd(shape, ties, dtype):
    h, g = _data(shape, sum(shape) + 1, ties)
    jd = getattr(jnp, dtype)
    want = np.asarray(_jnp_bwd(jnp.asarray(h, jd), jnp.asarray(g, jd)).astype(jnp.float32))
    td = getattr(torch, dtype)
    got = k6.relu_pool_bwd_plain(_t(h).to(td), _t(g).to(td))
    assert got.dtype == td and tuple(got.shape) == (shape[0], shape[2], shape[1])
    np.testing.assert_array_equal(_j(got), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 16, 8), (3, 25, 16), (1, 625, 256)])
def test_plain_k6_matches_pallas_interpret(shape, dtype):
    h, g = _data(shape, sum(shape) + 2, ties=True)
    jd = getattr(jnp, dtype)
    want = np.asarray(_pallas_bwd(jnp.asarray(h, jd), jnp.asarray(g, jd), interpret=True)
                      .astype(jnp.float32))
    td = getattr(torch, dtype)
    np.testing.assert_array_equal(_j(k6.relu_pool_bwd_plain(_t(h).to(td), _t(g).to(td))), want)


def test_tie_split():
    """A window of two equal positive values splits the cotangent evenly
    (test_relu_pool.py:60-67)."""
    h = torch.tensor([[[2.0, 2.0, 3.0, 1.0, -1.0, -2.0]]])  # [1, 1, 6]
    g = torch.tensor([[[4.0, 6.0, 8.0]]])
    np.testing.assert_array_equal(k6.relu_pool_bwd_plain(h, g)[0, 0].numpy(),
                                  [2.0, 2.0, 6.0, 0.0, 0.0, 0.0])
    hj = jnp.asarray(h.numpy().transpose(0, 2, 1))
    gj = jnp.asarray(g.numpy().transpose(0, 2, 1))
    np.testing.assert_array_equal(np.asarray(_pallas_bwd(hj, gj, interpret=True))[0, :, 0],
                                  [2.0, 2.0, 6.0, 0.0, 0.0, 0.0])


def test_odd_tail_zero_grad():
    h = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 7)).astype(np.float32))
    dh = k6.relu_pool_bwd_plain(h, torch.ones(2, 4, 3))
    assert tuple(dh.shape) == (2, 4, 7)
    np.testing.assert_array_equal(dh[:, :, 6].numpy(), 0.0)


@pytest.mark.parametrize("shape", [(4, 16, 8), (3, 25, 16), (2, 5000, 32), (1, 625, 256),
                                   (2, 2500, 64)])
def test_autograd_matches_jax_autodiff(shape):
    """The port's relu_max_pool2 under autograd (K6) == JAX autodiff of the XLA
    composite, away from exact positive ties (test_relu_pool.py:37-57)."""
    h, _ = _data(shape, sum(shape) + 1)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jnp.sin(_xla_relu_pool(x))))(jnp.asarray(h)))
    ht = _t(h).requires_grad_(True)
    torch.sin(rp.relu_max_pool2(ht)).sum().backward()
    t_len = shape[1]
    e = (t_len // 2) * 2
    tie = np.repeat((h[:, 0:e:2] == h[:, 1:e:2]) & (h[:, 0:e:2] > 0), 2, axis=1)
    tie = np.concatenate([tie, np.zeros((shape[0], t_len - e, shape[2]), bool)], axis=1)
    np.testing.assert_allclose(_j(ht.grad)[~tie], want[~tie], atol=AUTODIFF_TOL)


def test_switch_and_force_framework(monkeypatch):
    """The kernel backward (the default) splits a positive tie; inside
    ``force_framework_pool_bwd`` the backward routes it to the first element
    (torch's max_pool1d) and never calls K6; the default returns on exit."""
    h0 = torch.tensor([[[2.0, 2.0, 3.0, 1.0]]])
    calls = []
    real = rp.relu_pool_bwd
    monkeypatch.setattr(rp, "relu_pool_bwd", lambda h, g: calls.append(1) or real(h, g))

    def grad():
        h = h0.clone().requires_grad_(True)
        rp.relu_max_pool2(h).sum().backward()
        return h.grad[0, 0].tolist()

    assert grad() == [0.5, 0.5, 1.0, 0.0] and len(calls) == 1
    with rp.force_framework_pool_bwd():
        assert grad() == [1.0, 0.0, 1.0, 0.0] and len(calls) == 1
        with rp.force_framework_pool_bwd():  # nests
            assert grad() == [1.0, 0.0, 1.0, 0.0]
        assert grad() == [1.0, 0.0, 1.0, 0.0] and len(calls) == 1
    assert grad() == [0.5, 0.5, 1.0, 0.0] and len(calls) == 2


def test_wrapper_takes_plain_version_on_cpu():
    h, g = _data((2, 50, 8), 3, ties=True)
    before = k6.launches
    got = k6.relu_pool_bwd(_t(h), _t(g))
    torch.testing.assert_close(got, k6.relu_pool_bwd_plain(_t(h), _t(g)), rtol=0, atol=0)
    assert k6.launches == before  # the counter moves only for kernel launches


def test_kernel_checks_inputs():
    """Off the CPU the wrapper checks shapes and dtypes before any launch."""
    h = torch.zeros(2, 3, 10, device="meta")
    with pytest.raises(ValueError, match="T // 2"):
        k6.relu_pool_bwd(h, torch.zeros(2, 3, 4, device="meta"))
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        k6.relu_pool_bwd(h, torch.zeros(2, 3, 5, device="meta", dtype=torch.bfloat16))
    with pytest.raises(RuntimeError, match="CUDA"):
        k6.relu_pool_bwd(h, torch.zeros(2, 3, 5, device="meta"))
