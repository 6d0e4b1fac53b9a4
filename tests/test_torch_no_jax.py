"""The PyTorch port imports nothing of JAX or of the JAX package, and its
code imports none of the packages the GPU machine lacks (pandas, PyYAML,
scikit-learn, wfdb) at any level; matplotlib and seaborn only inside functions."""

import ast
import glob
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ptbxl_tpu")
ABSENT_ON_GPU = ("pandas", "yaml", "sklearn", "wfdb")  # not installed on the GPU machine
DRAWN = ("matplotlib", "seaborn")  # imported only inside the functions that draw
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
        "import ptbxl_torch.bench, ptbxl_torch.ops.kernels.hybrid_ecgcnn\n"
        "import ptbxl_torch.tools.probe_zscore, ptbxl_torch.tools.probe_layer_perf\n"
        "import ptbxl_torch.ops.kernels.probes, ptbxl_torch.tools.probe_mosaic\n"
        "import ptbxl_torch.tools.probe_mosaic2, ptbxl_torch.tools.probe_sublane_conv\n"
        "import ptbxl_torch.tools.synthetic_ptbxl, ptbxl_torch.config\n"
        "import ptbxl_torch.tools.probe_hybrid, ptbxl_torch.tools.probe_dispatch\n"
        "import ptbxl_torch.tools.tune_wgmma\n"
        "import ptbxl_torch.io.wfdb_io, ptbxl_torch.io.native, ptbxl_torch.utils.table\n"
        "import ptbxl_torch.utils.label_maps, ptbxl_torch.data, ptbxl_torch.data.manifest\n"
        "import ptbxl_torch.data.cache, ptbxl_torch.data.datasets\n"
        "import ptbxl_torch.training.thresholds, ptbxl_torch.cli._common\n"
        "import ptbxl_torch.cli.train_ecg_baseline, ptbxl_torch.cli.train_multimodal_prototype\n"
        "import ptbxl_torch.cli.train_af_binary, ptbxl_torch.cli.ecg_baseline_test\n"
        "import ptbxl_torch.cli.ecg_multimodal_test, ptbxl_torch.cli.af_binary_test\n"
        "import ptbxl_torch.cli.grad_cam_ecg_demo\n"
        "import ptbxl_torch.analysis, ptbxl_torch.analysis.merge, ptbxl_torch.analysis.figures\n"
        "import ptbxl_torch.data.demo_export, ptbxl_torch.data.ptb_test\n"
        "import ptbxl_torch.cli.merge_all_test, ptbxl_torch.cli.analyse_merged_test\n"
        "import ptbxl_torch.cli.grad_cam_ecg_baseline, ptbxl_torch.cli.grad_cam_af\n"
        "import ptbxl_torch.cli.plot_results, ptbxl_torch.cli.plot_distributions\n"
        "import ptbxl_torch.cli.plot_baseline_only, ptbxl_torch.cli.plot_mm_only\n"
        "import ptbxl_torch.cli.prepare_data, ptbxl_torch.cli.printsize\n"
        "import ptbxl_torch.cli.make_demo_pack, ptbxl_torch.cli.save_demo_ecg\n"
        "import ptbxl_torch.cli.save_demo_multimodal\n"
        "import ptbxl_torch.utils.profiling, ptbxl_torch.ops.signal\n"
        "import ptbxl_torch.parallel.collectives, ptbxl_torch.parallel.mesh\n"
        "import ptbxl_torch.parallel.multihost, ptbxl_torch.parallel.dryrun\n"
        "import ptbxl_torch.ops.quant, ptbxl_torch.ops.quant_eval, ptbxl_torch.serving\n"
        "import ptbxl_torch.tools.probe_int8, ptbxl_torch.tools.tune_int8\n"
        "import ptbxl_torch.tools.probe_cam_export\n"
        "import ptbxl_torch.ops.phase_conv, ptbxl_torch.ops.phase_pack\n"
        "import ptbxl_torch.ops.fast_wgrad, ptbxl_torch.data.fetch\n"
        "import ptbxl_torch.cli.download_missing_records\n"
        "import ptbxl_torch.tools.probe_phase_forms, ptbxl_torch.tools.probe_pool\n"
        "import ptbxl_torch.tools.probe_bwd_breakdown, ptbxl_torch.tools.probe_train_gap\n"
        "import ptbxl_torch.tools.proto_int8\n"
        f"banned = {FORBIDDEN + ABSENT_ON_GPU + DRAWN!r}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
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
                 "ptbxl_torch/utils/csv_log.py", "ptbxl_torch/utils/rng.py",
                 "ptbxl_torch/bench.py", "ptbxl_torch/ops/kernels/hybrid_ecgcnn.py",
                 "ptbxl_torch/tools/probe_zscore.py", "ptbxl_torch/tools/probe_layer_perf.py",
                 "ptbxl_torch/ops/kernels/probes.py", "ptbxl_torch/tools/probe_mosaic.py",
                 "ptbxl_torch/tools/probe_mosaic2.py", "ptbxl_torch/tools/probe_sublane_conv.py",
                 "ptbxl_torch/tools/synthetic_ptbxl.py", "ptbxl_torch/config.py",
                 "ptbxl_torch/io/wfdb_io.py", "ptbxl_torch/io/native.py",
                 "ptbxl_torch/utils/table.py", "ptbxl_torch/utils/label_maps.py",
                 "ptbxl_torch/data/manifest.py", "ptbxl_torch/data/cache.py",
                 "ptbxl_torch/data/datasets.py", "ptbxl_torch/training/thresholds.py",
                 "ptbxl_torch/cli/_common.py", "ptbxl_torch/cli/train_ecg_baseline.py",
                 "ptbxl_torch/cli/train_multimodal_prototype.py",
                 "ptbxl_torch/cli/train_af_binary.py", "ptbxl_torch/cli/ecg_baseline_test.py",
                 "ptbxl_torch/cli/ecg_multimodal_test.py", "ptbxl_torch/cli/af_binary_test.py",
                 "ptbxl_torch/cli/grad_cam_ecg_demo.py", "ptbxl_torch/analysis/__init__.py",
                 "ptbxl_torch/analysis/merge.py", "ptbxl_torch/analysis/figures.py",
                 "ptbxl_torch/data/demo_export.py", "ptbxl_torch/data/ptb_test.py",
                 "ptbxl_torch/cli/merge_all_test.py", "ptbxl_torch/cli/analyse_merged_test.py",
                 "ptbxl_torch/cli/grad_cam_ecg_baseline.py", "ptbxl_torch/cli/grad_cam_af.py",
                 "ptbxl_torch/cli/plot_results.py", "ptbxl_torch/cli/plot_distributions.py",
                 "ptbxl_torch/cli/plot_baseline_only.py", "ptbxl_torch/cli/plot_mm_only.py",
                 "ptbxl_torch/cli/prepare_data.py", "ptbxl_torch/cli/printsize.py",
                 "ptbxl_torch/cli/make_demo_pack.py", "ptbxl_torch/cli/save_demo_ecg.py",
                 "ptbxl_torch/cli/save_demo_multimodal.py", "ptbxl_torch/utils/profiling.py",
                 "ptbxl_torch/ops/signal.py", "ptbxl_torch/parallel/collectives.py",
                 "ptbxl_torch/parallel/mesh.py", "ptbxl_torch/parallel/multihost.py",
                 "ptbxl_torch/parallel/dryrun.py", "ptbxl_torch/ops/quant.py",
                 "ptbxl_torch/ops/quant_eval.py", "ptbxl_torch/serving.py",
                 "ptbxl_torch/tools/probe_int8.py", "ptbxl_torch/tools/tune_int8.py",
                 "ptbxl_torch/tools/probe_cam_export.py", "ptbxl_torch/ops/phase_conv.py",
                 "ptbxl_torch/ops/phase_pack.py", "ptbxl_torch/ops/fast_wgrad.py",
                 "ptbxl_torch/data/fetch.py", "ptbxl_torch/cli/download_missing_records.py",
                 "ptbxl_torch/tools/probe_phase_forms.py", "ptbxl_torch/tools/probe_pool.py",
                 "ptbxl_torch/tools/probe_bwd_breakdown.py",
                 "ptbxl_torch/tools/probe_train_gap.py", "ptbxl_torch/tools/proto_int8.py"):
        assert path in PORT_FILES, path


def test_fetch_reads_the_csv_without_pandas():
    """The JAX fetcher reads ptbxl_database.csv with pandas, which the GPU
    machine lacks; the port's reads it through utils/table.py."""
    tree = ast.parse(open(os.path.join(HERE, "ptbxl_torch/data/fetch.py")).read())
    modules = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    modules += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in modules if m.split(".")[0] == "pandas"]
    assert "ptbxl_torch.utils.table" in modules


@pytest.mark.parametrize("path", PORT_FILES)
def test_source_imports_nothing_absent_on_the_gpu_machine(path):
    """pandas, PyYAML, scikit-learn and wfdb at no level (top, function or
    conditional); matplotlib and seaborn only inside a function."""
    tree = ast.parse(open(os.path.join(HERE, path)).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if a.name.split(".")[0] in ABSENT_ON_GPU]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if node.module.split(".")[0] in ABSENT_ON_GPU:
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n.split(".")[0] in DRAWN], path
