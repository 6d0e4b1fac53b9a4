"""The port's data-parallel (+ model-parallel) layer (ptbxl_torch/parallel/,
the mesh paths of training/{loop,trainer}.py, synced train-mode BatchNorm,
``Predictor(data_parallel=True)``) against the unsharded port and JAX.

The invariant is the JAX package's own (``__graft_entry__.py:37-170``,
tests/test_training.py:155-258): a sharded step equals an unsharded step on
the same global batch, gated as JAX gates it: loss 1e-5 relative, BatchNorm
running stats 1e-5, parameters after one SGD step (lr 1e-3) 1e-5.  The
ranks are gloo processes on the CPU; a 2-rank mesh is (2, 1), a 4-rank mesh
(2, 2), whose model axis splits the Linear layers of >= 64 outputs.
"""

import csv
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import optax  # noqa: E402

from ptbxl_tpu.models.factory import build_multimodal as jax_build_multimodal  # noqa: E402
from ptbxl_tpu.training.loop import make_train_step as jax_make_train_step  # noqa: E402
from ptbxl_tpu.training.train_state import create_train_state as jax_state  # noqa: E402

from ptbxl_torch.inference import Predictor  # noqa: E402
from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.models.params_io import from_flax_variables  # noqa: E402
from ptbxl_torch.parallel import dryrun  # noqa: E402
from ptbxl_torch.parallel.mesh import Mesh, param_spec  # noqa: E402
from ptbxl_torch.training.trainer import data_width  # noqa: E402
from tests import torch_parallel_workers as workers  # noqa: E402
from tests.torch_port_common import CKPT, CKPT_MM, demo_signals, mm_demo_pack  # noqa: E402

GATE = 1e-5
PARITY_TOL = 2e-5  # tests/test_torch_inference.py


@pytest.fixture(scope="module")
def jax_init():
    model, variables = jax_build_multimodal(num_labels=5, seed=0)
    return model, jax.device_get(variables)


@pytest.fixture(scope="module")
def batch():
    return dryrun.make_batch(8, 64)


def test_mesh_rows_and_param_rule():
    m = Mesh(n_data=4, n_model=1, data_index=2, model_index=0, data_group=None,
             model_group=None)
    assert m.rows(16) == slice(8, 12)
    b = {"mask": np.arange(16), "ecg": np.arange(32).reshape(16, 2)}
    np.testing.assert_array_equal(m.local(b)["mask"], [8, 9, 10, 11])
    with pytest.raises(ValueError, match="does not split"):
        m.rows(10)
    # mesh.py:49-59: a 2-D weight whose output dim divides by n_model and is >= 64
    assert param_spec((256, 256), 2) == "model"
    assert param_spec((64, 5), 2) == "model"
    assert param_spec((5, 256), 2) is None      # the head
    assert param_spec((32, 12, 15), 2) is None  # a conv
    assert param_spec((256, 256), 1) is None
    assert [data_width(64, w) for w in (1, 2, 3, 4, 5, 8)] == [1, 2, 2, 4, 4, 8]


@pytest.mark.parametrize("n", [2, 4], ids=["2 ranks (2x1)", "4 ranks (2x2)"])
def test_sharded_step_equals_unsharded(jax_init, batch, n):
    """One SGD step of the FiLM model at [8, 64, 12], one row masked."""
    jm, variables = jax_init
    state = {k: v.contiguous() for k, v in from_flax_variables(variables, "multimodal").items()}
    n_model = 2 if n == 4 else 1
    got = dryrun.run_ranks(dryrun.one_step, n, (state, batch, "sgd", n_model, "cpu"),
                           device="cpu", timeout=300, threads=1)
    port = dryrun.one_step(state, batch, "sgd", None, "cpu")
    tx = optax.sgd(dryrun.LR)
    js, jl = jax_make_train_step(jm, tx, multimodal=True, donate=False)(
        jax_state(jm, variables, tx), batch)
    jax_sd = {k: v for k, v in from_flax_variables(
        {"params": jax.device_get(js.params), "batch_stats": jax.device_get(js.batch_stats)},
        "multimodal").items()}
    for name, ref_loss, ref in (("port", port["loss"], port["state"]),
                                ("jax", float(jl), jax_sd)):
        assert abs(got["loss"] - ref_loss) / abs(ref_loss) < GATE, name
        assert dryrun.max_diff(dryrun.bn_stats(got["state"]), dryrun.bn_stats(ref)) < GATE, name
        assert dryrun.max_diff(dryrun.params(got["state"]), dryrun.params(ref)) < GATE, name
    # the sharded state saves unsharded: every key at its full shape
    assert {k: tuple(v.shape) for k, v in got["state"].items()} == {
        k: tuple(v.shape) for k, v in port["state"].items()}


def test_dryrun_runs_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2, t=64)


@pytest.mark.slow
def test_dryrun_multichip_production_shape():
    """The dry run at the real shape [B, 5000, 12] on 4 ranks (2x2)."""
    out = dryrun.dryrun_multichip(4, device="cpu")
    assert (out["n_data"], out["n_model"], out["t"]) == (2, 2, 5000)


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))[1:]


def test_sharded_trainer_matches_unsharded(tmp_path):
    """tests/test_training.py:197-258 on the port: two gloo ranks against one
    process, 2 epochs at batch 8 over 22 records (the last batch padded):
    rank metrics equal, losses within 1e-3, the same best checkpoint; rank 0
    alone writes the CSV."""
    torch.manual_seed(0)
    state = ECGCNN(num_labels=5).state_dict()
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    assert workers.fit(state, str(one), 2, 8) is None
    assert dryrun.run_ranks(workers.fit, 2, (state, str(two), 2, 8), device="cpu",
                            timeout=300, threads=1) == 0
    rows1, rows2 = _csv_rows(one / "m.csv"), _csv_rows(two / "m.csv")
    assert len(rows1) == len(rows2) == 2
    for r1, r2 in zip(rows1, rows2):
        assert r1[2] == r2[2]
        assert r1[4:7] == r2[4:7], (r1, r2)  # auroc, auprc, f1
        np.testing.assert_allclose(float(r1[3]), float(r2[3]), atol=1e-3)
        np.testing.assert_allclose(float(r1[7]), float(r2[7]), atol=1e-3)
    meta = [json.loads((d / "best.npz.meta.json").read_text()) for d in (one, two)]
    assert meta[0]["val_auprc"] == meta[1]["val_auprc"]


@pytest.mark.parametrize("n", [7, 4, 1])
def test_data_parallel_predictor_matches_framework(n):
    """Two CPU replicas, each a block of every chunk's rows; an odd N pads to
    an even chunk (inference.py:304-305)."""
    sigs = demo_signals()[:n]
    dp = Predictor.from_checkpoint(CKPT, data_parallel=True, device=["cpu", "cpu"])
    assert dp.engine == "framework"  # 'auto' resolves to it (inference.py:94-97)
    seen = []
    orig = dp._forward_replicas
    dp._forward_replicas = lambda x, d=None: seen.append(x.shape[0]) or orig(x, d)
    want = Predictor.from_checkpoint(CKPT, engine="framework", device="cpu")(sigs)
    got = dp(sigs)
    assert got.shape == (n, 5)
    np.testing.assert_allclose(got, want, atol=PARITY_TOL)
    assert all(b % 2 == 0 for b in seen)


def test_data_parallel_predictor_multimodal_chunks():
    sigs, demos = mm_demo_pack()
    dp = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", data_parallel=True,
                                   chunk_size=4, device=["cpu", "cpu"])
    want = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="framework",
                                     device="cpu")(sigs, demo=demos)
    np.testing.assert_allclose(dp(sigs, demo=demos), want, atol=PARITY_TOL)


def test_data_parallel_predictor_rejects(monkeypatch):
    with pytest.raises(ValueError, match="engine='xla'"):
        Predictor.from_checkpoint(CKPT, data_parallel=True, engine="kernel", device=["cpu"])
    with pytest.raises(ValueError, match="engine='xla'"):
        Predictor.from_checkpoint(CKPT, data_parallel=True, engine="pallas", device=["cpu"])
    with pytest.raises(ValueError, match="not divisible by 2 devices"):
        Predictor.from_checkpoint(CKPT, data_parallel=True, chunk_size=5,
                                  device=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):  # every visible GPU: none
        Predictor.from_checkpoint(CKPT, data_parallel=True)


@pytest.mark.parametrize("cli", ["train_ecg_baseline", "train_multimodal_prototype",
                                 "train_af_binary"])
def test_train_clis_join_the_group_and_print_the_width(ptbxl_dir, tmp_path, monkeypatch,
                                                       capsys, cli):
    """CLIs 03-05 call maybe_initialize_distributed before the trainer (the JAX
    multi-host recipe's step 1, docs/ARCHITECTURE.md:445-458) and print the
    data width they train on."""
    import importlib

    mod = importlib.import_module(f"ptbxl_torch.cli.{cli}")
    order = []
    monkeypatch.setattr(mod, "maybe_initialize_distributed",
                        lambda device=None: order.append(("init", device)) or False)
    monkeypatch.setattr(mod, "train", lambda run: order.append(("train", run.batch_size)))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"""seed: 42
data:
  base_dir: {ptbxl_dir}
  labels: ["MI", "STTC", "HYP", "CD", "NORM"]
train:
  batch_size: 6
  epochs: 1
log:
  out_dir: {tmp_path / "out"}
""")
    mod.main(["--config", str(cfg), "--device", "cpu"])
    assert order == [("init", "cpu"), ("train", 6)]
    assert "[INFO] Data-parallel width: 1 (world size 1)" in capsys.readouterr().out
