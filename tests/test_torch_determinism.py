"""The port's train and eval steps pin cuDNN to deterministic algorithms
(ptbxl_torch/utils/device.py::deterministic_algorithms), so one seed gives one
training bit for bit on the card as well as on the host: the JAX package's
contract (tests/test_determinism.py), which the reference keeps by pinning
cuDNN in its ``set_seed`` (src/utils/seed.py:7-14).

On the CPU the flags change no arithmetic, so these tests read them where the
card would: from a backward hook inside the step, with and without a mesh,
and after the step returns.  ``chip_smoke.py``'s ``determinism`` phase runs
the seed pair itself on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from ptbxl_torch.models.ecg_cnn import ConvBlock  # noqa: E402
from ptbxl_torch.models.factory import build_ecgcnn, build_multimodal  # noqa: E402
from ptbxl_torch.parallel.mesh import make_mesh  # noqa: E402
from ptbxl_torch.training.loop import make_eval_step, make_train_step  # noqa: E402
from ptbxl_torch.training.train_state import create_train_state  # noqa: E402
from ptbxl_torch.utils.device import deterministic_algorithms  # noqa: E402
from ptbxl_torch.utils.rng import set_seed  # noqa: E402

T = 64
CALLER = (False, True)  # a caller's (deterministic, benchmark): autotuned cuDNN


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The steps here are tiny: one intra-op thread keeps them from thrashing
    when the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags():
    cudnn = torch.backends.cudnn
    return cudnn.deterministic, cudnn.benchmark


@pytest.fixture
def caller_flags():
    """The global flags set as a caller that autotunes would set them, and the
    process's own restored after the test."""
    cudnn = torch.backends.cudnn
    saved = _flags()
    cudnn.deterministic, cudnn.benchmark = CALLER
    yield
    cudnn.deterministic, cudnn.benchmark = saved


def _batch(b=4, demo=False, seed=0):
    rng = np.random.default_rng(seed)
    out = {"ecg": rng.standard_normal((b, T, 12)).astype(np.float32),
           "y": (rng.uniform(size=(b, 5)) < 0.3).astype(np.float32),
           "mask": np.ones(b, np.float32)}
    if demo:
        out["demo"] = rng.standard_normal((b, 5)).astype(np.float32)
    return out


def _block(model):
    """The model's second conv block (its input needs a gradient, so its
    backward hook runs)."""
    return [m for m in model.modules() if isinstance(m, ConvBlock)][1]


def _step_flags(multimodal=False, mesh=None):
    """The flags a backward hook reads inside one train step, and the step's loss."""
    build = build_multimodal if multimodal else build_ecgcnn
    model = build(num_labels=5, seed=0, device="cpu")
    seen = []
    _block(model).register_full_backward_hook(lambda m, gi, go: seen.append(_flags()))
    state = create_train_state(model, 1e-3, 1e-4)
    _, loss = make_train_step(multimodal=multimodal, mesh=mesh)(state, _batch(demo=multimodal))
    return seen, float(loss)


@pytest.mark.parametrize("multimodal", [False, True], ids=["ecgcnn", "multimodal"])
def test_train_step_backward_runs_deterministic_cudnn(caller_flags, multimodal):
    seen, loss = _step_flags(multimodal)
    assert seen == [(True, False)]
    assert np.isfinite(loss)


@pytest.mark.parametrize("multimodal", [False, True], ids=["ecgcnn", "multimodal"])
def test_train_step_on_a_mesh_runs_deterministic_cudnn(caller_flags, multimodal):
    """The data-parallel step (``mesh``): a one-rank gloo group in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        seen, loss = _step_flags(multimodal, mesh=make_mesh())
    finally:
        dist.destroy_process_group()
    assert seen == [(True, False)]
    assert np.isfinite(loss)


@pytest.mark.parametrize("multimodal", [False, True], ids=["ecgcnn", "multimodal"])
def test_flags_are_restored_after_the_steps(caller_flags, multimodal):
    build = build_multimodal if multimodal else build_ecgcnn
    model = build(num_labels=5, seed=0, device="cpu")
    seen = []
    _block(model).register_forward_hook(lambda m, i, o: seen.append(_flags()))
    state = create_train_state(model, 1e-3, 1e-4)
    batch = _batch(demo=multimodal)
    make_train_step(multimodal=multimodal)(state, batch)
    assert _flags() == CALLER
    make_eval_step(multimodal=multimodal)(state, batch)
    assert _flags() == CALLER
    assert seen == [(True, False), (True, False)]  # the train and the eval forward


@pytest.mark.parametrize("multimodal", [False, True], ids=["ecgcnn", "multimodal"])
def test_flags_are_restored_when_the_step_raises(caller_flags, multimodal):
    build = build_multimodal if multimodal else build_ecgcnn
    model = build(num_labels=5, seed=0, device="cpu")
    state = create_train_state(model, 1e-3, 1e-4)
    batch = _batch(demo=multimodal)
    batch["ecg"][0, 0, 0] = np.inf
    with pytest.raises(FloatingPointError):
        make_train_step(multimodal=multimodal, check_numerics=True)(state, batch)
    assert _flags() == CALLER


def test_scope_nests_and_restores(caller_flags):
    with deterministic_algorithms():
        assert _flags() == (True, False)
        with deterministic_algorithms():
            assert _flags() == (True, False)
        assert _flags() == (True, False)
    assert _flags() == CALLER


def test_set_seed_pins_cudnn(caller_flags):
    """``set_seed`` leaves cuDNN deterministic with autotuning off for the
    process, as the reference's does, and seeds the generators."""
    gen = set_seed(3)
    assert _flags() == (True, False)
    a = (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=gen).item())
    set_seed(3)
    gen = torch.Generator().manual_seed(3)
    assert a == (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=gen).item())
