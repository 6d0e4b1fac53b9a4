"""The port's phase-domain training path (ptbxl_torch/ops/phase_conv.py and
``phase_train`` in ptbxl_torch/models/{ecg_cnn,ecg_multimodal}.py) against
ptbxl_tpu/ops/phase_conv.py and JAX's ``ECGCNN(phase_train=True)``.

Mirrors tests/test_phase_conv.py with its tolerances: ``phase_conv`` at
rtol 1e-6 / atol 1e-5, a full-model train step (loss 1e-5, BatchNorm batch
statistics 1e-5, gradients 2e-4) against the standard path and against JAX,
eval logits bit-identical to ``phase_train=False``.  The standard path's pool
backward is K6's plain version on the CPU; the phase path runs it on the
last block alone.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ptbxl_tpu.models.ecg_cnn import ECGCNN as JaxECGCNN  # noqa: E402
from ptbxl_tpu.models.ecg_multimodal import ECGMultimodal as JaxECGMultimodal  # noqa: E402
from ptbxl_tpu.ops.phase_conv import build_phase_kernel as jax_build_phase_kernel  # noqa: E402
from ptbxl_tpu.ops.phase_conv import phase_conv as jax_phase_conv  # noqa: E402

from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.models.ecg_multimodal import ECGMultimodal  # noqa: E402
from ptbxl_torch.models.params_io import from_flax_variables  # noqa: E402
from ptbxl_torch.ops import relu_pool  # noqa: E402
from ptbxl_torch.ops.phase_conv import build_phase_kernel, phase_conv, phase_conv_cf  # noqa: E402
from ptbxl_torch.parallel import dryrun  # noqa: E402
from tests import torch_parallel_workers as workers  # noqa: E402

SMALL = dict(feat_dim=64, num_labels=3, channels=(8, 12, 16, 24))


@pytest.mark.parametrize(
    "B,T,Ci,Co,k", [(2, 16, 3, 5, 15), (3, 40, 12, 32, 15), (2, 10, 2, 4, 7)]
)
def test_phase_conv_matches_jax_and_same_conv(B, T, Ci, Co, k):
    rng = np.random.default_rng(T + k)
    x = rng.standard_normal((B, T, Ci)).astype(np.float32)
    w = rng.standard_normal((k, Ci, Co)).astype(np.float32)
    b = rng.standard_normal((Co,)).astype(np.float32)
    got = phase_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_phase_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    assert got.shape == (B, T // 2, 2, Co)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    same = F.conv1d(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(w).permute(2, 1, 0),
                    torch.from_numpy(b), padding=k // 2).transpose(1, 2)
    np.testing.assert_allclose(got, same.reshape(B, T // 2, 2, Co).numpy(), rtol=1e-6, atol=1e-5)
    # the channels-first form: channels [phase 0 C, phase 1 C]
    cf = phase_conv_cf(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(w).permute(2, 1, 0),
                       torch.from_numpy(b))
    np.testing.assert_array_equal(cf.numpy(), got.reshape(B, T // 2, 2 * Co).transpose(0, 2, 1))


def test_build_phase_kernel_is_jax_bit_for_bit():
    w = np.random.default_rng(3).standard_normal((15, 12, 32)).astype(np.float32)
    got = build_phase_kernel(torch.from_numpy(w)).numpy()
    assert got.shape == (16, 12, 64)
    np.testing.assert_array_equal(got, np.asarray(jax_build_phase_kernel(jnp.asarray(w))))


def test_phase_conv_rejects_odd_t_and_even_k():
    with pytest.raises(ValueError, match="even T"):
        phase_conv(torch.zeros(1, 9, 2), torch.zeros(3, 2, 4))
    with pytest.raises(ValueError, match="odd k"):
        phase_conv(torch.zeros(1, 8, 2), torch.zeros(4, 2, 4))
    with pytest.raises(ValueError, match="even T"):
        phase_conv_cf(torch.zeros(1, 2, 9), torch.zeros(4, 2, 3))


def _jax_train(model, variables, x, y, demo=None):
    def f(params):
        args = (x,) if demo is None else (x, demo)
        logits, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  *args, True, mutable=["batch_stats"])
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, y)), mut["batch_stats"]

    # eager, as tests/test_phase_conv.py runs it: under jax.jit, XLA's CPU
    # backend (jax 0.9.0) gives the phase blocks' conv-kernel gradients up to
    # 0.094 off on a max of 0.166 (phase_conv alone is right under jit), while
    # the eager ones agree with the standard path's to 1e-7
    (loss, stats), grads = jax.value_and_grad(f, has_aux=True)(variables["params"])
    arch = "ecgcnn" if demo is None else "multimodal"
    state = from_flax_variables({"params": jax.device_get(variables["params"]),
                                 "batch_stats": jax.device_get(stats)}, arch)
    g = from_flax_variables({"params": jax.device_get(grads),
                             "batch_stats": jax.device_get(stats)}, arch)
    return float(loss), state, dryrun.params(g)


class _CountPoolBwd:
    """Counts the pool backward's calls (K6's plain version on the CPU)."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = relu_pool.relu_pool_bwd

        def counted(h, g):
            self.n += 1
            return orig(h, g)

        monkeypatch.setattr(relu_pool, "relu_pool_bwd", counted)


def _port_train(model, x, y, demo=None):
    model.train()
    logits = model(x) if demo is None else model(x, demo)
    loss = F.binary_cross_entropy_with_logits(logits, y)
    model.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return float(loss.detach()), state, grads


def _assert_step_close(got, want, name):
    (l1, s1, g1), (l2, s2, g2) = got, want
    np.testing.assert_allclose(l1, l2, atol=1e-5, err_msg=name)
    for k in s2:
        if "running_" in k:
            np.testing.assert_allclose(s1[k].numpy(), s2[k].numpy(), atol=1e-5,
                                       err_msg=f"{name} {k}")
    for k in g2:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), atol=2e-4, err_msg=f"{name} {k}")


# T=200: 200 -> 100 -> 50 -> 25 (the last block on the standard path, as always)
@pytest.mark.parametrize("T", [80, 200])
def test_full_model_phase_equivalence(T, monkeypatch):
    jm = JaxECGCNN(phase_train=True, **SMALL)
    variables = jax.device_get(
        JaxECGCNN(**SMALL).init(jax.random.PRNGKey(0), jnp.zeros((1, T, 12))))
    rng = np.random.default_rng(T)
    x = rng.standard_normal((4, T, 12)).astype(np.float32)
    y = (rng.uniform(size=(4, 3)) > 0.5).astype(np.float32)
    want = _jax_train(jm, variables, jnp.asarray(x), jnp.asarray(y))
    models, got_phase, got_std = _phase_and_standard(from_flax_variables(variables), x, y, 1,
                                                     monkeypatch)
    _assert_step_close(got_phase, want, "port phase vs jax phase")
    _assert_step_close(got_phase, got_std, "port phase vs port standard")

    # eval never takes the phase path: bit-identical
    xt = torch.from_numpy(x)
    with torch.no_grad():
        e1, e2 = models[True].eval()(xt), models[False].eval()(xt)
    assert torch.equal(e1, e2)
    assert not ECGCNN().backbone[0].phase_train  # the default stays off


def _phase_and_standard(state, x, y, pool_bwds, monkeypatch):
    """One port step of each form from ``state``; the phase step must run the
    pool backward ``pool_bwds`` times, the standard one four times."""
    models = {}
    for phase in (True, False):
        models[phase] = ECGCNN(phase_train=phase, **SMALL)
        models[phase].load_state_dict(state)
    counter = _CountPoolBwd(monkeypatch)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got_phase = _port_train(models[True], xt, yt)
    assert counter.n == pool_bwds
    got_std = _port_train(models[False], xt, yt)
    assert counter.n == pool_bwds + 4
    return models, got_phase, got_std


def test_odd_length_block_takes_the_standard_path(monkeypatch):
    """T=90: block 1's input 45 is odd and takes the standard path (its pool
    backward too), block 2's 22 the phase one; the step is the standard step's."""
    rng = np.random.default_rng(90)
    x = rng.standard_normal((4, 90, 12)).astype(np.float32)
    y = (rng.uniform(size=(4, 3)) > 0.5).astype(np.float32)
    state = ECGCNN(generator=torch.Generator().manual_seed(0), **SMALL).state_dict()
    _, got_phase, got_std = _phase_and_standard(state, x, y, 2, monkeypatch)
    _assert_step_close(got_phase, got_std, "port phase vs port standard, T=90")


def test_multimodal_phase_equivalence():
    T = 80
    kw = dict(feat_dim=32, num_labels=3, channels=(8, 12, 16, 24), demo_hidden_dim=16)
    jm = JaxECGMultimodal(phase_train=True, **kw)
    variables = jax.device_get(JaxECGMultimodal(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, T, 12)), jnp.zeros((1, 5))))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, T, 12)).astype(np.float32)
    d = rng.uniform(size=(4, 5)).astype(np.float32)
    y = (rng.uniform(size=(4, 3)) > 0.5).astype(np.float32)
    want = _jax_train(jm, variables, jnp.asarray(x), jnp.asarray(y), jnp.asarray(d))
    state = from_flax_variables(variables, "multimodal")
    models = {}
    for phase in (True, False):
        models[phase] = ECGMultimodal(phase_train=phase, **kw)
        models[phase].load_state_dict(state)
    xt, dt, yt = (torch.from_numpy(v) for v in (x, d, y))
    got_phase = _port_train(models[True], xt, yt, dt)
    _assert_step_close(got_phase, want, "mm port phase vs jax phase")
    _assert_step_close(got_phase, _port_train(models[False], xt, yt, dt), "mm phase vs standard")
    with torch.no_grad():
        assert torch.equal(models[True].eval()(xt, dt), models[False].eval()(xt, dt))


def test_data_parallel_phase_step_equals_unsharded():
    """The phase path's BatchNorm goes through the data group's sync: one SGD
    step of the phase-train FiLM model on two gloo ranks against one process,
    at JAX's gates (tests/test_torch_parallel.py)."""
    batch = dryrun.make_batch(8, 64)
    state = {k: v.contiguous() for k, v in ECGMultimodal(
        num_labels=5, phase_train=True, generator=torch.Generator().manual_seed(0)
    ).state_dict().items()}
    got = dryrun.run_ranks(workers.phase_step, 2, (state, batch, True), device="cpu",
                           timeout=300, threads=1)
    ref = workers.phase_step(state, batch, False)
    assert abs(got["loss"] - ref["loss"]) / abs(ref["loss"]) < 1e-5
    assert dryrun.max_diff(dryrun.bn_stats(got["state"]), dryrun.bn_stats(ref["state"])) < 1e-5
    assert dryrun.max_diff(dryrun.params(got["state"]), dryrun.params(ref["state"])) < 1e-5
    assert ref["pool_bwds"] == 1


def test_bf16_phase_conv_on_the_cpu_is_the_same_conv():
    """bf16 at block 0's channels (12 -> 32): torch's CPU bf16 conv gets the
    even-length phase kernel wrong, so the port runs it as an f32 conv of the
    bf16 values; it matches the bf16 stride-1 conv to one bf16 rounding."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((4, 12, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((32, 12, 15)).astype(np.float32)).bfloat16()
    got = phase_conv_cf(x, w)
    assert got.dtype == torch.bfloat16
    same = F.conv1d(x, w, padding=7).float()  # [4, 32, 64]
    inter = got.float().view(4, 2, 32, 32).permute(0, 2, 3, 1).reshape(4, 32, 64)
    assert float((inter - same).abs().max()) <= 2 ** -7 * float(same.abs().max())
