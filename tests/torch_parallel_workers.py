"""Rank functions for the port's process-group tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py).  ``ptbxl_torch.parallel.dryrun.run_ranks``
spawns fresh interpreters, which import these by name; this module imports
no JAX, so a rank starts quickly."""

import os

import torch.distributed as dist


def losses_of_one_step(state_dict, batch):
    """One sharded multimodal SGD step; every rank's reported loss, gathered."""
    from ptbxl_torch.parallel.dryrun import one_step

    loss = one_step(state_dict, batch, "sgd", 1, "cpu")["loss"]
    losses = [None] * dist.get_world_size()
    dist.all_gather_object(losses, loss)
    return losses


def fit(state_dict, out_dir, epochs, batch_size):
    """``trainer.train`` of an ECGCNN on the seeded in-memory datasets of
    tests/test_torch_parallel.py; the metrics CSV and best checkpoint land in
    ``out_dir`` (rank 0 writes them)."""
    from ptbxl_torch.models.ecg_cnn import ECGCNN
    from ptbxl_torch.training.trainer import TrainRun, train
    from tests.torch_port_common import CLASSES, InMemoryECG

    model = ECGCNN(num_labels=5)
    model.load_state_dict(state_dict)
    train(TrainRun(model=model, train_ds=InMemoryECG(n=22, t=128, seed=21),
                   val_ds=InMemoryECG(n=14, t=128, seed=22), batch_size=batch_size,
                   epochs=epochs, lr=1e-3, weight_decay=1e-4, seed=42, run_name="fit",
                   metrics_csv=os.path.join(out_dir, "m.csv"),
                   ckpt_path=os.path.join(out_dir, "best.npz"), config_path="c.yaml",
                   classes=CLASSES, pth_export=False, train_desc=None, eval_desc=None))
    return dist.get_rank() if dist.is_initialized() else None


def phase_step(state_dict, batch, sharded):
    """One SGD step (lr 1e-3) of the FiLM model with ``phase_train=True`` on the
    global ``batch``: over a (world, 1) mesh when ``sharded``, else unsharded.
    Returns the loss, the full state after the step and the pool backward's calls."""
    import torch

    from ptbxl_torch.models.ecg_multimodal import ECGMultimodal
    from ptbxl_torch.ops import relu_pool
    from ptbxl_torch.parallel.mesh import make_mesh, shard_model
    from ptbxl_torch.training.loop import make_train_step
    from ptbxl_torch.training.train_state import TrainState

    model = ECGMultimodal(num_labels=5, phase_train=True)
    model.load_state_dict(state_dict)
    mesh = None
    if sharded:
        mesh = make_mesh(n_model=1)
        shard_model(model, mesh)
    calls = []
    orig = relu_pool.relu_pool_bwd
    relu_pool.relu_pool_bwd = lambda h, g: calls.append(1) or orig(h, g)
    try:
        state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-3))
        _, loss = make_train_step(multimodal=True, mesh=mesh)(state, batch)
    finally:
        relu_pool.relu_pool_bwd = orig
    return {"loss": float(loss), "pool_bwds": len(calls),
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
