"""The port's process-group bootstrap (ptbxl_torch/parallel/multihost.py):
tests/test_multihost.py's no-op and truthiness cases on
``PTBXL_TORCH_DISTRIBUTED``, torchrun's variables, the GPU default, and one
two-process gloo step whose loss both ranks report equally."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from ptbxl_torch.models.factory import build_multimodal  # noqa: E402
from ptbxl_torch.parallel.dryrun import make_batch, run_ranks  # noqa: E402
from ptbxl_torch.parallel.multihost import maybe_initialize_distributed  # noqa: E402
from tests import torch_parallel_workers as workers  # noqa: E402

CLUSTER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "PTBXL_TORCH_DISTRIBUTED")


@pytest.fixture
def calls(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    seen = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: seen.append((a, k)))
    return seen


def test_maybe_initialize_is_noop_without_cluster_env(calls):
    assert maybe_initialize_distributed() is False
    assert calls == []


@pytest.mark.parametrize("value", ["0", "false", "no", "False", "NO", " "])
def test_distributed_env_falsey_values_stay_noop(monkeypatch, calls, value):
    """PTBXL_TORCH_DISTRIBUTED=false/no must not initialize: the contract is '=1'."""
    monkeypatch.setenv("PTBXL_TORCH_DISTRIBUTED", value)
    assert maybe_initialize_distributed(device="cpu") is False
    assert calls == []


@pytest.mark.parametrize("value", ["1", "true", "YES"])
def test_distributed_env_truthy_values_initialize(monkeypatch, calls, value):
    monkeypatch.setenv("PTBXL_TORCH_DISTRIBUTED", value)
    assert maybe_initialize_distributed(device="cpu") is True
    assert len(calls) == 1
    (backend,), kw = calls[0]
    assert backend == "gloo" and kw["init_method"] == "env://"


def test_torchrun_env_initializes(monkeypatch, calls):
    for var, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29511"), ("WORLD_SIZE", "2"),
                   ("RANK", "1")):
        monkeypatch.setenv(var, v)
    assert maybe_initialize_distributed(device="cpu") is True
    (backend,), kw = calls[0]
    assert (backend, kw["world_size"], kw["rank"]) == ("gloo", 2, 1)


def test_explicit_arguments_and_gpu_default(monkeypatch, calls):
    """Explicit arguments initialize; the backend follows the device, and the
    default device is the GPU, which raises where there is none."""
    assert maybe_initialize_distributed("tcp://127.0.0.1:29512", 1, 0, device="cpu") is True
    assert calls[0][0] == ("gloo",)
    assert maybe_initialize_distributed("tcp://127.0.0.1:29512", 1, 0, "nccl", "cpu") is True
    assert calls[1][0] == ("nccl",)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        maybe_initialize_distributed("tcp://127.0.0.1:29512", 1, 0)
    assert len(calls) == 2


def test_two_process_train_step():
    state = {k: v.cpu() for k, v in build_multimodal(num_labels=5, seed=0,
                                                     device="cpu").state_dict().items()}
    losses = run_ranks(workers.losses_of_one_step, 2, (state, make_batch(8, 64)),
                       device="cpu", timeout=240, threads=1)
    assert len(losses) == 2
    assert losses[0] == losses[1]
    assert np.isfinite(losses[0]) and 0.0 < losses[0] < 10.0
