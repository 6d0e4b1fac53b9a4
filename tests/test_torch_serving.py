"""The port's serving artifacts (``ptbxl_torch/serving.py``, ``torch.export``)
on the CPU: the port's versions of tests/test_serving_export.py's cases.

Each artifact is exported on the CPU, loaded by a fresh ``ServingModel`` and
held against the port's ``Predictor`` of the same engine and precision (and
``GradCAM.multi`` for the CAMs) at 2e-6 on the demo pack.  The kernel-engine
artifact runs its custom ops' plain versions here.
"""

import glob
import json
import os
import struct
import warnings

import numpy as np
import pytest
import torch

from ptbxl_torch import serving
from ptbxl_torch.inference import Predictor
from ptbxl_torch.interpret.grad_cam import GradCAM
from ptbxl_torch.models.factory import load_ecgcnn, load_multimodal
from ptbxl_torch.ops import quant as tq
from ptbxl_torch.ops.preprocess import zscore_per_lead_batch
from ptbxl_torch.ops.relu_pool import force_framework_pool_bwd
from ptbxl_torch.serving import ServingModel, export_serving_artifact
from tests.torch_port_common import CKPT, CKPT_AF, CKPT_MM, HERE, demo_signals, mm_demo_pack

CPU = "cpu"
TOL = 2e-6


@pytest.fixture(scope="module")
def sigs():
    return demo_signals()


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The artifacts, each exported once on the CPU: name -> path."""
    d = tmp_path_factory.mktemp("artifacts")
    q = tq.quantize_model(tq_state(), device=CPU)
    variants = {
        "highest": (CKPT, {}),
        "default": (CKPT, {"precision": "default"}),
        "int8": (CKPT, {"precision": "int8", "qparams": q}),
        "with_cam": (CKPT, {"with_cam": True}),
        "kernel": (CKPT, {"engine": "kernel"}),
        "fixed4": (CKPT, {"batch_size": 4}),
        "multimodal": (CKPT_MM, {"arch": "multimodal"}),
    }
    out = {"q": q}
    for name, (ckpt, kw) in variants.items():
        out[name] = str(d / f"{name}.ptbxlpt")
        assert export_serving_artifact(ckpt, out[name], device=CPU, **kw) == out[name]
    return out


def tq_state():
    from ptbxl_torch.models.params_io import load_checkpoint

    return load_checkpoint(CKPT)[0]


def test_baseline_artifact_roundtrip(art, sigs):
    model = ServingModel(art["highest"], device=CPU)
    assert model.classes == ["MI", "STTC", "HYP", "CD", "NORM"]
    assert model.meta["platforms"] == ["cpu", "cuda"] and model.batch_size is None
    got = model(sigs)
    ref = Predictor.from_checkpoint(CKPT, engine="framework", device=CPU)(sigs)
    np.testing.assert_allclose(got, ref, atol=TOL)
    # the symbolic batch: any N through the same program
    np.testing.assert_allclose(model(sigs[0])[0], got[0], atol=TOL)
    np.testing.assert_allclose(model(sigs[:3]), got[:3], atol=TOL)


@pytest.mark.parametrize("name,precision", [("default", "default"), ("int8", "int8")])
def test_perf_precision_artifacts_match_their_predictor(art, sigs, name, precision):
    model = ServingModel(art[name], device=CPU)
    assert model.meta["precision"] == precision
    kw = {"qparams": art["q"]} if precision == "int8" else {"engine": "framework"}
    ref = Predictor.from_checkpoint(CKPT, precision=precision, device=CPU, **kw)(sigs)
    np.testing.assert_allclose(model(sigs), ref, atol=TOL)
    np.testing.assert_allclose(model(sigs[:2]), ref[:2], atol=TOL)


def test_int8_artifact_within_the_battery_gate(art, sigs):
    got = ServingModel(art["int8"], device=CPU)(sigs)
    ref = Predictor.from_checkpoint(CKPT, engine="framework", device=CPU)(sigs)
    assert np.abs(got - ref).max() < 4e-2
    assert ServingModel(art["int8"], device=CPU).meta["int8_layers"] == [3]


def test_multimodal_artifact_roundtrip(art):
    sigs, demos = mm_demo_pack()
    model = ServingModel(art["multimodal"], device=CPU)
    got = model(sigs, demo=demos)
    ref = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="framework",
                                    device=CPU)(sigs, demo=demos)
    np.testing.assert_allclose(got, ref, atol=TOL)
    np.testing.assert_allclose(model(sigs[:3], demo=demos[:3]), got[:3], atol=TOL)
    with pytest.raises(ValueError, match="demo"):
        model(sigs)
    with pytest.raises(ValueError, match="demo must be"):
        model(sigs, demo=demos[:2])


def test_artifact_layout_and_validation(art, sigs):
    model = ServingModel(art["highest"], device=CPU)
    np.testing.assert_array_equal(model(sigs.transpose(0, 2, 1)), model(sigs))
    with pytest.raises(ValueError, match="expected"):
        model(np.zeros((2, 999, 12), np.float32))


def test_container_layout(art):
    """Magic, u64 LE meta length, JSON meta with JAX's keys, the torch.export bytes."""
    blob = open(art["highest"], "rb").read()
    assert blob.startswith(b"PTBXLPT1\n")
    (n,) = struct.unpack("<Q", blob[9:17])
    meta = json.loads(blob[17:17 + n])
    for k in ("arch", "classes", "num_labels", "n_samples", "n_leads", "normalize", "precision",
              "int8_layers", "platforms", "with_cam", "engine", "batch_size", "data_parallel",
              "n_devices"):
        assert k in meta, k
    assert meta["payload_bytes"] == len(blob) - 17 - n
    assert not os.path.exists(art["highest"] + ".tmp")


def test_cam_artifact(art, sigs):
    """(probs, all-class CAMs) against the Predictor and GradCAM.multi."""
    model = ServingModel(art["with_cam"], device=CPU)
    assert model.with_cam
    probs, cams = model(sigs)
    assert probs.shape == (7, 5) and cams.shape == (7, 5, 5000)
    assert np.isfinite(cams).all() and cams.min() >= 0.0 and cams.max() <= 1.0
    ref = Predictor.from_checkpoint(CKPT, engine="framework", device=CPU)(sigs)
    np.testing.assert_allclose(probs, ref, atol=TOL)
    m, _ = load_ecgcnn(CKPT, device=CPU)
    gc = GradCAM(m, signal_length=5000, norm_first=False, eps=1e-9)
    x = zscore_per_lead_batch(torch.from_numpy(np.ascontiguousarray(sigs.transpose(0, 2, 1))))
    with force_framework_pool_bwd():  # the artifact's pool backward, as JAX's export
        ref_probs, ref_cams = gc.multi(x, range(5))
    np.testing.assert_allclose(probs, ref_probs.numpy(), atol=TOL)
    np.testing.assert_allclose(cams, ref_cams.numpy().transpose(1, 0, 2), atol=TOL)


@pytest.mark.parametrize("multimodal", [False, True])
def test_all_classes_matches_grad_cam_multi(multimodal):
    """GradCAM.all_classes (the explicit backward the artifact traces) against
    the autograd GradCAM.multi at 2e-6, both pool backwards."""
    if multimodal:
        sigs, demos = mm_demo_pack()
        m, _ = load_multimodal(CKPT_MM, device=CPU)
        extra = (torch.from_numpy(demos),)
    else:
        sigs, m, extra = demo_signals(), load_ecgcnn(CKPT, device=CPU)[0], ()
    gc = GradCAM(m, signal_length=5000, norm_first=False, eps=1e-9, multimodal=multimodal)
    x = zscore_per_lead_batch(torch.from_numpy(np.ascontiguousarray(sigs.transpose(0, 2, 1))))
    probs, cams = gc.all_classes(x, *extra)
    for scope in (force_framework_pool_bwd, lambda: torch.no_grad()):
        with scope():
            ref_probs, ref_cams = gc.multi(x, range(5), *extra)
        torch.testing.assert_close(probs, ref_probs, rtol=0, atol=TOL)
        torch.testing.assert_close(cams, ref_cams, rtol=0, atol=TOL)


def test_cam_export_probe_reports_each_attempt(capsys):
    """tools/probe_cam_export.py (why the artifact traces ``all_classes``, not
    the autograd ``multi``): one JSON line per tracer mode and batch, each
    naming the stage it reached, then ``all_classes`` against ``multi``."""
    from ptbxl_torch.tools import probe_cam_export

    assert probe_cam_export.main(["--samples", "1000", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 7
    for r in lines[:6]:
        assert r["stage"] in ("export", "call", "save", "load", "ok")
        assert ("error" in r) == (r["stage"] != "ok")
    assert [(r["strict"], r["batch"]) for r in lines[:6]] == [
        (s, b) for s in (False, True, True) for b in ("symbolic", "fixed")]
    assert lines[-1]["all_classes_vs_multi_max_abs_diff"] <= TOL


def test_kernel_artifact_chunks_and_pads(art, sigs):
    """engine='kernel': the custom op at a fixed batch of 8, chunked and padded
    by ServingModel; on the CPU the op runs its plain version."""
    model = ServingModel(art["kernel"], device=CPU)
    assert model.batch_size == 8 and model.meta["platforms"] == ["cuda"]
    assert model.meta["engine"] == "kernel"
    ops = [str(n.target) for n in model._programs[0].graph.nodes if n.op == "call_function"]
    assert "ptbxl.fused_ecgcnn_probs.default" in ops
    x = np.concatenate([sigs, sigs[:2]])  # 9 records: a chunk of 8, then 1 padded to 8
    ref = Predictor.from_checkpoint(CKPT, engine="kernel", device=CPU)
    np.testing.assert_allclose(model(x), ref(x), atol=TOL)


def test_kernel_artifact_multimodal(tmp_path):
    sigs, demos = mm_demo_pack()
    path = str(tmp_path / "mmk.ptbxlpt")
    export_serving_artifact(CKPT_MM, path, arch="multimodal", engine="pallas", batch_size=4,
                            device=CPU)
    model = ServingModel(path, device=CPU)
    ops = [str(n.target) for n in model._programs[0].graph.nodes if n.op == "call_function"]
    assert "ptbxl.fused_multimodal_probs.default" in ops and model.batch_size == 4
    ref = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="kernel", device=CPU)
    np.testing.assert_allclose(model(sigs, demo=demos), ref(sigs, demo=demos), atol=TOL)


def test_symbolic_batch_range_pads_and_splits(art, sigs):
    """The traced batch range (2 up on the CPU): one record is padded to 2, and a
    call above the range's top is split (here a top of 3 set by hand)."""
    model = ServingModel(art["highest"], device=CPU)
    assert model.meta["batch_range"] == [2, None]
    want = model(sigs)
    calls = []
    prog = model._programs[0]
    model._programs = [lambda x: calls.append(x.shape[0]) or prog(x)]
    np.testing.assert_allclose(model(sigs[:1]), want[:1], atol=TOL)
    assert calls == [2]
    model.meta["batch_range"] = [2, 3]
    np.testing.assert_allclose(model(sigs), want, atol=TOL)
    assert calls[1:] == [3, 3, 2]  # 3 + 3 + 1 padded to 2


def test_fixed_batch_artifact_chunks_and_pads(art, sigs):
    model = ServingModel(art["fixed4"], device=CPU)
    assert model.batch_size == 4
    np.testing.assert_allclose(model(sigs), ServingModel(art["highest"], device=CPU)(sigs),
                               atol=TOL)


def test_empty_input_on_every_path(art):
    empty = np.zeros((0, 12, 5000), np.float32)
    for name in ("highest", "fixed4", "kernel", "int8"):
        assert ServingModel(art[name], device=CPU)(empty).shape == (0, 5)
    p0, c0 = ServingModel(art["with_cam"], device=CPU)(empty)
    assert p0.shape == (0, 5) and c0.shape == (0, 5, 5000)


def test_rejects_garbage_and_truncation(art, tmp_path):
    bad = tmp_path / "bad.ptbxlpt"
    bad.write_bytes(b"not an artifact at all")
    with pytest.raises(ValueError, match="not a ptbxl_torch serving artifact"):
        ServingModel(str(bad), device=CPU)
    blob = open(art["highest"], "rb").read()
    for cut, what in ((len(blob) // 2, "payload"), (12, "no meta length"), (40, "meta")):
        trunc = tmp_path / f"trunc{cut}.ptbxlpt"
        trunc.write_bytes(blob[:cut])
        with pytest.raises(ValueError, match=f"truncated artifact \\({what}"):
            ServingModel(str(trunc), device=CPU)


def test_refuses_a_jax_artifact(tmp_path):
    """A JAX (PTBXLSRV1, StableHLO) artifact raises, saying so."""
    pytest.importorskip("jax")
    from ptbxl_tpu.serving import export_serving_artifact as jax_export

    path = str(tmp_path / "jax.stablehlo")
    jax_export(CKPT, path, platforms=("cpu",), batch_size=1)
    with pytest.raises(ValueError, match="does not load JAX artifacts"):
        ServingModel(path, device=CPU)
    with pytest.raises(ValueError, match="JAX"):
        serving._read_artifact(path, meta_only=True)


def test_serving_cli_export_and_info(tmp_path, capsys, sigs):
    out = str(tmp_path / "cli.ptbxlpt")
    assert serving._main(["export", CKPT, out, "--batch_size", "4", "--device", "cpu"]) == 0
    assert os.path.exists(out)
    assert serving._main(["info", out]) == 0
    captured = capsys.readouterr().out
    assert '"batch_size": 4' in captured and '"arch": "ecgcnn"' in captured
    assert ServingModel(out, device=CPU)(sigs[:2]).shape == (2, 5)


def test_int8_export_with_qparams_file(art, tmp_path, sigs):
    """Offline q-params (save_qparams) flow into the artifact; the CLI takes them too."""
    qp = str(tmp_path / "q.npz")
    tq.save_qparams(art["q"], qp)
    out = str(tmp_path / "i8.ptbxlpt")
    assert serving._main(["export", CKPT, out, "--precision", "int8", "--qparams", qp,
                          "--device", "cpu"]) == 0
    ref = Predictor.from_checkpoint(CKPT, precision="int8", qparams=qp, device=CPU)(sigs)
    np.testing.assert_allclose(ServingModel(out, device=CPU)(sigs), ref, atol=TOL)


def test_int8_rejects_cam_and_kernel(tmp_path):
    with pytest.raises(ValueError, match="int8"):
        export_serving_artifact(CKPT, str(tmp_path / "x"), precision="int8", with_cam=True,
                                device=CPU)
    with pytest.raises(ValueError, match="int8"):
        export_serving_artifact(CKPT, str(tmp_path / "x"), precision="int8", engine="pallas",
                                device=CPU)
    with pytest.raises(ValueError, match="kernel"):
        export_serving_artifact(CKPT, str(tmp_path / "x"), engine="kernel", with_cam=True,
                                device=CPU)


def test_int8_export_num_labels_mismatch_raises(tmp_path):
    with pytest.raises(ValueError, match="1 labels but num_labels=5"):
        export_serving_artifact(CKPT_AF, str(tmp_path / "x"), precision="int8", device=CPU)


def test_explicit_platforms_override_warns(tmp_path):
    path = str(tmp_path / "k.ptbxlpt")
    with pytest.warns(UserWarning, match="overridden"):
        export_serving_artifact(CKPT, path, engine="kernel", platforms=("cpu",), device=CPU)
    assert ServingModel(path, device=CPU).meta["platforms"] == ["cuda"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the default (platforms=None) stays silent
        export_serving_artifact(CKPT, path, engine="kernel", device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        export_serving_artifact(CKPT, path, platforms=("cpu",), batch_size=2, device=CPU)
    assert ServingModel(path, device=CPU).meta["platforms"] == ["cpu"]


def test_highest_runs_without_tf32_whatever_the_process_flags(art, sigs, monkeypatch):
    """TF32 is a process flag, not part of a program: a 'highest' artifact runs
    under highest_precision() though the caller switched TF32 on, and the
    caller's flags come back after the call."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(mm, "allow_tf32", True)
    model = ServingModel(art["highest"], device=CPU)
    seen = []
    prog = model._programs[0]
    model._programs = [lambda *a: seen.append((cudnn.allow_tf32, mm.allow_tf32)) or prog(*a)]
    got = model(sigs)
    assert seen == [(False, False)] and cudnn.allow_tf32 and mm.allow_tf32
    ref = Predictor.from_checkpoint(CKPT, engine="framework", device=CPU)(sigs)
    np.testing.assert_allclose(got, ref, atol=TOL)
    # a 'default' artifact leaves the flags as the caller set them
    dflt = ServingModel(art["default"], device=CPU)
    prog_d = dflt._programs[0]
    dflt._programs = [lambda *a: seen.append((cudnn.allow_tf32, mm.allow_tf32)) or prog_d(*a)]
    dflt(sigs[:1])
    assert seen[-1] == (True, True)


def test_data_parallel_artifact_two_devices(tmp_path, sigs):
    """One program a device; rows split in order; fewer devices raise."""
    path = str(tmp_path / "dp.ptbxlpt")
    export_serving_artifact(CKPT, path, data_parallel=True, batch_size=8, device=[CPU, CPU])
    model = ServingModel(path, device=[CPU, CPU])
    assert model.meta["n_devices"] == 2 and model.batch_size == 8
    assert len(model._programs) == 2 and model.meta["platforms"] == ["cpu"]
    ref = Predictor.from_checkpoint(CKPT, engine="framework", device=CPU)(sigs)
    np.testing.assert_allclose(model(sigs), ref, atol=TOL)
    with pytest.raises(ValueError, match="exported for 2 devices; only 1 visible"):
        ServingModel(path, device=[CPU])
    with pytest.raises(ValueError, match="divisible"):
        export_serving_artifact(CKPT, str(tmp_path / "x"), data_parallel=True, batch_size=5,
                                device=[CPU, CPU])
    with pytest.raises(ValueError, match="data_parallel"):
        export_serving_artifact(CKPT, str(tmp_path / "x"), data_parallel=True, engine="kernel",
                                device=[CPU, CPU])


def test_no_gpu_raises_without_device(art, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_serving_artifact(CKPT, str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingModel(art["highest"])


def test_demo_pack_files_exist():
    assert len(glob.glob(os.path.join(HERE, "data/demo/single/*.npz"))) == 7
