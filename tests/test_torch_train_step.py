"""The port's train and eval steps (ptbxl_torch/training/{loop,train_state}.py)
against ptbxl_tpu/training/{loop,train_state}.py.

Mirrors tests/test_training.py:33-153 and the tolerances of
tests/test_train_parity_torch.py, now between the JAX package and the port:
the same weights, batches and optimizer settings go through JAX's
``make_train_step`` and the port's.  Train-mode BatchNorm follows flax
(biased variance in the running update), so ``running_var`` is held as
tightly as ``running_mean``.  On the CPU the pool backward is K6's plain
version.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ptbxl_tpu.models.factory import build_ecgcnn as jax_build_ecgcnn  # noqa: E402
from ptbxl_tpu.models.factory import build_multimodal as jax_build_multimodal  # noqa: E402
from ptbxl_tpu.training.loop import make_train_step as jax_make_train_step  # noqa: E402
from ptbxl_tpu.training.train_state import (  # noqa: E402
    create_train_state as jax_create_train_state,
    large_batch_lr as jax_large_batch_lr,
    make_optimizer as jax_make_optimizer,
)

from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.models.ecg_multimodal import ECGMultimodal  # noqa: E402
from ptbxl_torch.models.params_io import from_flax_variables  # noqa: E402
from ptbxl_torch.ops.kernels import relu_pool as k6  # noqa: E402
from ptbxl_torch.training.loop import (  # noqa: E402
    eval_one_epoch,
    make_eval_step,
    make_train_step,
    train_one_epoch,
)
from ptbxl_torch.training.train_state import (  # noqa: E402
    TrainState,
    create_train_state,
    large_batch_lr,
    make_optimizer,
)

B, T, LABELS = 16, 256, 5  # test_train_parity_torch.py:29
LR, WD = 1e-3, 1e-4
BN_RTOL = 1e-4  # the old unbiased running_var update is n/(n-1) off: 0.4% at n=256


def _batch(rng, bs=8, t=T, demo=False, mask_last=0):
    b = {
        "ecg": rng.standard_normal((bs, t, 12)).astype(np.float32),
        "y": (rng.uniform(size=(bs, LABELS)) > 0.7).astype(np.float32),
        "mask": np.concatenate([np.ones(bs - mask_last), np.zeros(mask_last)]).astype(np.float32),
    }
    if demo:
        b["demo"] = rng.uniform(size=(bs, 5)).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def jax_init():
    model, variables = jax_build_ecgcnn(num_labels=LABELS, seed=0)
    return model, jax.device_get(variables)


def _port(variables, multimodal=False):
    m = ECGMultimodal(num_labels=LABELS) if multimodal else ECGCNN(num_labels=LABELS)
    m.load_state_dict(from_flax_variables(variables, "multimodal" if multimodal else "ecgcnn"))
    return m


def _state(model, lr=LR, wd=WD, warmup=0):
    return create_train_state(model, lr, wd, warmup)


def _jax_state_dict(state):
    return {k: v.numpy() for k, v in from_flax_variables(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)}).items()}


# -- section 0: train-mode BatchNorm as flax computes it -------------------------

def test_train_mode_bn_stats_match_flax(jax_init):
    """One train-mode forward from the same weights on the same batch: the
    updated running stats equal flax's ``mutable=["batch_stats"]`` update.
    torch's own train mode stores the unbiased variance and fails this."""
    jm, variables = jax_init
    x = np.random.default_rng(5).standard_normal((4, 64, 12)).astype(np.float32) * 2 + 0.5
    want_logits, mutated = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    want = from_flax_variables({"params": variables["params"],
                                "batch_stats": jax.device_get(mutated["batch_stats"])})
    pm = _port(variables).train()
    with torch.no_grad():
        got_logits = pm(torch.from_numpy(x))
    got = pm.state_dict()
    for i in range(4):
        for s in ("running_mean", "running_var"):
            k = f"backbone.{i}.net.1.{s}"
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=BN_RTOL,
                                       atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-5)


def test_eval_mode_unchanged_by_train_path(jax_init):
    """Eval mode keeps the running statistics and F.batch_norm's arithmetic."""
    jm, variables = jax_init
    x = np.random.default_rng(6).standard_normal((2, 64, 12)).astype(np.float32)
    pm = _port(variables).eval()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(variables, jnp.asarray(x))),
                               atol=1e-5)


# -- mirrors of tests/test_training.py ---------------------------------------------

def test_train_step_reduces_loss(jax_init, rng):
    _, variables = jax_init
    state = _state(_port(variables), lr=1e-3, wd=1e-4)
    step = make_train_step()
    batch = _batch(rng)
    before = k6.launches
    losses = []
    for _ in range(12):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8
    assert state.step == 12
    assert k6.launches == before  # the plain version on the CPU


def test_batch_stats_update_in_train_only(jax_init, rng):
    _, variables = jax_init
    state = _state(_port(variables), wd=0.0)
    key = "backbone.0.net.1.running_mean"
    before = state.model.state_dict()[key].clone()
    state, _ = make_train_step()(state, _batch(rng))
    after = state.model.state_dict()[key].clone()
    assert not torch.allclose(before, after)
    make_eval_step()(state, _batch(rng))
    torch.testing.assert_close(state.model.state_dict()[key], after, rtol=0, atol=0)


def test_padding_mask_excluded_from_loss(jax_init, rng):
    """Junk labels under the mask do not change the loss (lr 0)."""
    _, variables = jax_init
    step = make_train_step()
    padded = _batch(rng, bs=8)
    padded["ecg"][-2:] = 1e3
    padded["y"][-2:] = 1.0
    padded["mask"][-2:] = 0.0
    _, l1 = step(_state(_port(variables), lr=0.0, wd=0.0), padded)
    padded2 = {k: v.copy() for k, v in padded.items()}
    padded2["y"][-2:] = 0.0
    _, l2 = step(_state(_port(variables), lr=0.0, wd=0.0), padded2)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)


def test_multimodal_step_matches_jax(rng):
    jm, variables = jax_build_multimodal(num_labels=LABELS, seed=0)
    variables = jax.device_get(variables)
    batch = _batch(rng, demo=True)
    tx = jax_make_optimizer(LR, WD)
    js, jl = jax_make_train_step(jm, tx, multimodal=True, donate=False)(
        jax_create_train_state(jm, variables, tx), batch)
    ps, pl = make_train_step(multimodal=True)(_state(_port(variables, True)), batch)
    assert np.isfinite(float(pl))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    want = from_flax_variables({"params": jax.device_get(js.params),
                                "batch_stats": jax.device_get(js.batch_stats)}, "multimodal")
    got = ps.model.state_dict()
    for k in ("head.weight", "film_gen.weight", "demo_encoder.mlp.0.weight",
              "ecg_backbone.proj.weight", "ecg_backbone.backbone.3.net.1.running_var"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=5e-4, atol=2e-4,
                                   err_msg=k)


def test_loss_mode_aggregation(jax_init, rng):
    """per_sample (loop.py) vs per_batch (loop_demo.py) epoch aggregation."""
    _, variables = jax_init
    step = make_train_step()
    b_full = _batch(rng, bs=8)
    b_part = _batch(rng, bs=8, mask_last=4)
    l1 = float(step(_state(_port(variables), 0.0, 0.0), b_full)[1])
    l2 = float(step(_state(_port(variables), 0.0, 0.0), b_part)[1])
    _, per_sample = train_one_epoch(_state(_port(variables), 0.0, 0.0), step,
                                    iter([b_full, b_part]), "per_sample")
    _, per_batch = train_one_epoch(_state(_port(variables), 0.0, 0.0), step,
                                   iter([b_full, b_part]), "per_batch")
    np.testing.assert_allclose(per_sample, (l1 * 8 + l2 * 4) / 12, rtol=1e-5)
    np.testing.assert_allclose(per_batch, (l1 + l2) / 2, rtol=1e-5)


def test_eval_per_batch_ignores_all_padding_batch(jax_init, rng):
    _, variables = jax_init
    state = TrainState(_port(variables))
    eval_step = make_eval_step()
    real = _batch(rng, bs=8)
    all_pad = _batch(rng, bs=8, mask_last=8)
    m_real = eval_one_epoch(state, eval_step, iter([real]), loss_mode="per_batch")
    m_pad = eval_one_epoch(state, eval_step, iter([real, all_pad]), loss_mode="per_batch")
    np.testing.assert_allclose(m_pad["bce_loss"], m_real["bce_loss"], rtol=1e-6)
    m = eval_one_epoch(state, eval_step, iter([real, _batch(rng, mask_last=3)]))
    assert set(m) == {"auroc_macro", "auprc_macro", "f1_macro", "bce_loss"}


@pytest.mark.parametrize("loss_mode", ["per_sample", "per_batch"])
def test_predict_all_matches_jax(jax_init, loss_mode):
    """Whole-split inference with masked padding, both loss modes, vs JAX's predict_all."""
    from ptbxl_tpu.training.loop import make_eval_step as jax_make_eval_step
    from ptbxl_tpu.training.loop import predict_all as jax_predict_all

    from ptbxl_torch.training.loop import predict_all

    jm, variables = jax_init
    rng = np.random.default_rng(9)
    batches = [_batch(rng, bs=8), _batch(rng, bs=8, mask_last=5), _batch(rng, bs=8, mask_last=8)]
    tx = jax_make_optimizer(LR, WD)
    want = jax_predict_all(jax_create_train_state(jm, variables, tx), jax_make_eval_step(jm),
                           iter(batches), loss_mode)
    got = predict_all(TrainState(_port(variables)), make_eval_step(), iter(batches), loss_mode)
    assert got[0].shape == want[0].shape == (11, LABELS)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


# -- one and fifty steps against JAX's make_train_step ------------------------------

def _compare_params(got, want, init, n_steps):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got[k].numpy()
        if k.endswith("net.0.bias"):
            # conv bias before train-mode BN: its true gradient is ~0 and Adam
            # turns float noise into O(lr) steps; only the step bound means
            # anything (test_train_parity_torch.py:115-122)
            assert np.all(np.abs(g - init[k]) <= 1.5 * LR * n_steps), k
            assert np.all(np.abs(w - init[k]) <= 1.5 * LR * n_steps), k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=BN_RTOL, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=5e-4, atol=2e-4, err_msg=k)


def test_one_step_matches_jax(jax_init):
    jm, variables = jax_init
    rng = np.random.default_rng(20240817)
    batch = _batch(rng, bs=B)
    tx = jax_make_optimizer(LR, WD)
    js, jl = jax_make_train_step(jm, tx, donate=False)(
        jax_create_train_state(jm, variables, tx), batch)
    init = {k: v.numpy() for k, v in from_flax_variables(variables).items()}
    ps, pl = make_train_step()(_state(_port(variables)), batch)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _compare_params(ps.model.state_dict(), _jax_state_dict(js), init, 1)


def test_fifty_steps_match_jax(jax_init):
    """50 AdamW steps on fresh batches: the trajectories stay locked within the
    gauge-aware tolerances of test_train_parity_torch.py:137-225."""
    jm, variables = jax_init
    rng = np.random.default_rng(50_20240817)
    tx = jax_make_optimizer(LR, WD)
    jstep = jax_make_train_step(jm, tx, donate=False)
    js = jax_create_train_state(jm, variables, tx)
    pstep = make_train_step()
    ps = _state(_port(variables))
    base = rng.standard_normal((B, T, 12)).astype(np.float32)
    for i in range(50):
        x = (base * (1.0 + 0.1 * np.sin(i + 1))
             + 0.3 * rng.standard_normal((B, T, 12))).astype(np.float32)
        y = (rng.uniform(size=(B, LABELS)) > 0.6).astype(np.float32)
        batch = {"ecg": x, "y": y, "mask": np.ones(B, np.float32)}
        js, jl = jstep(js, batch)
        ps, pl = pstep(ps, batch)
        np.testing.assert_allclose(float(pl), float(jl), rtol=5e-3, err_msg=f"step {i}")
    want, got = _jax_state_dict(js), {k: v.numpy() for k, v in ps.model.state_dict().items()}
    rm, bias = "backbone.0.net.1.running_mean", "backbone.0.net.0.bias"
    np.testing.assert_allclose(got[rm] - got[bias], want[rm] - want[bias], atol=2e-3)
    rv = "backbone.0.net.1.running_var"
    np.testing.assert_allclose(got[rv], want[rv], rtol=1e-2)
    for li in range(1, 4):
        k = f"backbone.{li}.net.1.running_var"
        np.testing.assert_allclose(got[k], want[k], rtol=0.5, err_msg=k)
    x_eval = rng.standard_normal((B, T, 12)).astype(np.float32)
    probs_j = np.asarray(jax.nn.sigmoid(jm.apply(js.variables(), jnp.asarray(x_eval), False)))
    ps.model.eval()
    with torch.no_grad():
        probs_p = torch.sigmoid(ps.model(torch.from_numpy(x_eval))).numpy()
    np.testing.assert_allclose(probs_p, probs_j, atol=4e-2)
    assert float(np.abs(probs_p - probs_j).mean()) < 2e-2


# -- optimizer and schedule ----------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 3])
def test_adamw_and_warmup_match_optax(warmup):
    """AdamW (+ linear warmup) vs the JAX package's make_optimizer, step by step:
    the lr of every update, params after every step, and a first warmup
    update that leaves the params exactly as they were."""
    rng = np.random.default_rng(warmup)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    lr, wd = 1e-2, 1e-2
    tx = jax_make_optimizer(lr, wd, warmup_steps=warmup)
    jp = {"w": jnp.asarray(p0)}
    jst = tx.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = make_optimizer([w], lr, wd, warmup_steps=warmup)
    assert (sched is None) == (warmup == 0)
    sched_fn = optax.linear_schedule(0.0, lr, warmup) if warmup else (lambda k: lr)
    for k in range(8):
        g = rng.standard_normal((6, 5)).astype(np.float32)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched_fn(k)), rtol=1e-6)
        upd, jst = tx.update({"w": jnp.asarray(g)}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        w.grad = torch.from_numpy(g)
        opt.step()
        if sched is not None:
            sched.step()
        if k == 0 and warmup:
            np.testing.assert_array_equal(w.detach().numpy(), p0)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {k}")


@pytest.mark.parametrize("bs,ref", [(64, 64), (512, 64), (256, 128)])
def test_large_batch_lr(bs, ref):
    assert large_batch_lr(1.5e-3, bs, ref) == jax_large_batch_lr(1.5e-3, bs, ref)
