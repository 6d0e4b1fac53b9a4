"""The PyTorch port imports nothing of JAX or of the JAX package."""

import ast
import glob
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ptbxl_tpu")
PORT_FILES = sorted(
    os.path.relpath(p, HERE)
    for p in glob.glob(os.path.join(HERE, "ptbxl_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import ptbxl_torch, ptbxl_torch.inference, ptbxl_torch.interpret.grad_cam\n"
        "import ptbxl_torch.demo_inference, ptbxl_torch.interpret.plotting\n"
        "import ptbxl_torch.models.ecg_multimodal, ptbxl_torch.data.demo_vector\n"
        "import ptbxl_torch.models.factory, ptbxl_torch.ops.kernels.fused_ecgcnn\n"
        "import ptbxl_torch.training.trainer, ptbxl_torch.data.pipeline\n"
        "import ptbxl_torch.ops.relu_pool, ptbxl_torch.ops.kernels.relu_pool\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=HERE)
    r = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", PORT_FILES)
def test_source_imports_no_jax(path):
    tree = ast.parse(open(os.path.join(HERE, path)).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_file_list_is_complete():
    assert "ptbxl_torch/inference.py" in PORT_FILES
    assert "ptbxl_torch/ops/kernels/fused_ecgcnn.py" in PORT_FILES
    assert "ptbxl_torch/models/ecg_multimodal.py" in PORT_FILES
    assert "ptbxl_torch/data/demo_vector.py" in PORT_FILES
    for path in ("ptbxl_torch/ops/relu_pool.py", "ptbxl_torch/ops/kernels/relu_pool.py",
                 "ptbxl_torch/ops/adc_convert.py", "ptbxl_torch/data/pipeline.py",
                 "ptbxl_torch/training/metrics.py", "ptbxl_torch/training/train_state.py",
                 "ptbxl_torch/training/loop.py", "ptbxl_torch/training/trainer.py",
                 "ptbxl_torch/utils/csv_log.py", "ptbxl_torch/utils/rng.py"):
        assert path in PORT_FILES, path
