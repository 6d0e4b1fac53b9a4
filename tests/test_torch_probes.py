"""P1, P2 and P4's plain versions (ptbxl_torch/ops/kernels/probes.py,
``hybrid_ecgcnn.conv_layer_cf_plain``) against the JAX probes.

P1/P2: each operation against the JAX tools' own numpy references
(tools/probe_mosaic.py, tools/probe_mosaic2.py) on their inputs, and against
their Pallas kernels run in TPU interpret mode where Mosaic's interpreter
takes them (p3 and p4 pass a negative roll shift, which it refuses: the
TPU finding p3b answers).  P4: ``tools/probe_sublane_conv.py::make_layer``
in interpret mode at small shapes, both output layouts, against
``conv_layer_cf_plain`` and the ``wgmma`` block's emulated route at 1e-4
(bf16 operands, f32 sums in another order).
The probe tools themselves run on the host and pass every gate.
"""

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from ptbxl_torch.ops.kernels import _build  # noqa: E402
from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4  # noqa: E402
from ptbxl_torch.ops.kernels import probes as kp  # noqa: E402
from ptbxl_torch.tools import probe_mosaic, probe_mosaic2, probe_sublane_conv  # noqa: E402
from tests.torch_port_common import HERE  # noqa: E402

sys.path.insert(0, os.path.join(HERE, "tools"))
import probe_mosaic as jax_pm  # noqa: E402
import probe_mosaic2 as jax_pm2  # noqa: E402
import probe_sublane_conv as jax_psc  # noqa: E402

ALL = probe_mosaic.PROBES + probe_mosaic2.PROBES


@pytest.mark.parametrize("probe", ALL, ids=lambda p: p.name)
def test_plain_version_matches_the_jax_tools_reference(probe):
    """The JAX tools compute their references in numpy on the f32 inputs:
    exact for data movement and the rolls' one f32 add; the dots' TF32
    rounding (p1, p2) is within 2^-11 relative a product, summed over K=256
    terms; p9 and p6 differ from numpy's f32 sums in their order."""
    xs = probe.inputs(torch.device("cpu"))
    got = probe.plain(*xs)
    got = got if isinstance(got, tuple) else (got,)
    ref = probe.reference(*[x.numpy() for x in xs])
    ref = ref if isinstance(ref, tuple) else (ref,)
    tol = {"p1": 0.1, "p2": 0.1, "p9": 2e-4, "p6": 1e-5}.get(probe.name, 0.0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=tol, rtol=0)


def _interpret(fn):
    with pltpu.force_tpu_interpret_mode():
        return fn()


def test_jax_probe_inputs_are_the_ports():
    a, b = probe_mosaic.PROBES[0].inputs(torch.device("cpu"))
    np.testing.assert_array_equal(a.numpy(), np.asarray(
        jnp.asarray(np.random.default_rng(0).standard_normal((256, 2048)), jnp.float32)))
    np.testing.assert_array_equal(b.numpy(), np.random.default_rng(1).standard_normal(
        (256, 128)).astype(np.float32))


@pytest.mark.parametrize("name", ["p5_strided_slices", "p6_unaligned_lane_slice",
                                  "p7_unaligned_lane_concat", "p8_transpose"])
def test_jax_p1_probes_pass_in_interpret_mode(name):
    """The JAX kernels of the data-movement probes, interpreted, agree with the
    numpy references that the port's plain versions match."""
    out = _interpret(getattr(jax_pm, name))
    assert "e+00" in out and all(float(v) == 0.0 for v in
                                 [t.split("=")[1] for t in out.replace(",", "").split()
                                  if "err=" in t]), out


@pytest.mark.parametrize("name", ["p3b_roll_positive", "p5b_pool_sublane_reshape",
                                  "p5b2_pool_sublane_slices", "p5c_pool_lane_reshape"])
def test_jax_p2_probes_pass_in_interpret_mode(name):
    out = _interpret(getattr(jax_pm2, name))
    assert out == "err=0.00e+00", out


@pytest.mark.parametrize("form", ["tn", "nt"])
def test_dot_plain_matches_pallas_interpret(form):
    """p1/p2's kernel in interpret mode at a small shape against the plain
    version in FP32 (the interpreter's dot is the host's f32 product)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((32, 64) if form == "tn" else (64, 32)).astype(np.float32)
    b = rng.standard_normal((32, 16) if form == "tn" else (16, 32)).astype(np.float32)
    dims = (((0,), (0,)), ((), ())) if form == "tn" else (((1,), (1,)), ((), ()))

    def kernel(a_ref, b_ref, o_ref):
        o_ref[:] = jax.lax.dot_general(a_ref[:], b_ref[:], dimension_numbers=dims,
                                       preferred_element_type=jnp.float32,
                                       precision=jax.lax.Precision.HIGHEST)

    want = _interpret(lambda: np.asarray(jax_pm._call(
        kernel, jax.ShapeDtypeStruct((64, 16), jnp.float32), jnp.asarray(a), jnp.asarray(b))))
    plain = kp.tn_dot_plain if form == "tn" else kp.nt_dot_plain
    got = plain(torch.from_numpy(a), torch.from_numpy(b), "fp32").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_tf32_round_is_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12,
                      3.0e-40, float("inf")])
    want = [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0, 3.0e-40, float("inf")]
    got = kp.tf32_round(x)
    assert got[:5].tolist() == want[:5] and got[6] == want[6]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("t_in,cout,cpad", [(64, 32, 16), (31, 64, 32), (40, 128, 64),
                                           (20, 256, 128)])
@pytest.mark.parametrize("transpose_out", [True, False])
def test_conv_layer_cf_plain_matches_pallas_interpret(t_in, cout, cpad, transpose_out):
    """The Pallas kernel in interpret mode against the plain version and the
    ``wgmma`` block's tiled route on the channel-major input (the card's),
    each of the reference layers' Cpad -> Cout, both output layouts."""
    rng = np.random.default_rng(t_in)
    b_tile = 2
    x = rng.standard_normal((2, cpad, t_in + 14)).astype(np.float32)
    w = (rng.standard_normal((15 * cpad, cout)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.01).astype(np.float32)
    fn = jax_psc.make_layer(t_in, cpad - 4, cout, cpad, b_tile, transpose_out=transpose_out)
    want = _interpret(lambda: np.asarray(fn(jnp.asarray(w), jnp.asarray(bias), jnp.asarray(x))))
    got = k4.conv_layer_cf_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias), transpose_out)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    wp = k4.wg_weight(torch.from_numpy(w).view(15, cpad, cout))
    route = k4.wgmma_conv_block_plain(torch.from_numpy(x), wp, torch.from_numpy(bias), valid=True,
                                      channel_major=True, transpose_out=transpose_out)
    np.testing.assert_allclose(route.numpy(), want, atol=1e-4, rtol=0)
    # the wrapper takes the plain version for a CPU tensor
    same = k4.conv_layer_cf(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                            transpose_out)
    assert torch.equal(same, got)


def test_conv_layer_cf_checks_shapes():
    x = torch.zeros(1, 16, 30)
    with pytest.raises(ValueError, match="15\\*Cpad"):
        k4.conv_layer_cf(x, torch.zeros(15 * 12, 32), torch.zeros(32))
    with pytest.raises(ValueError, match="time-padded"):
        k4.conv_layer_cf(torch.zeros(1, 16, 10), torch.zeros(240, 32), torch.zeros(32))


def test_probe_tools_pass_on_the_host(capsys):
    assert probe_mosaic.main(["--device", "cpu", "--iters", "1"]) == 0
    assert probe_mosaic.main(["--device", "cpu", "--iters", "1"], probes=probe_mosaic2.PROBES) == 0
    out = capsys.readouterr().out
    assert out.count("[PASS]") == 13 and "[FAIL]" not in out and "host us" in out


def test_sublane_conv_tool_runs_on_the_host(monkeypatch, capsys):
    monkeypatch.setattr(probe_sublane_conv, "LAYERS", [(40, 12, 32, 16), (20, 32, 64, 32)])
    assert probe_sublane_conv.main(["--device", "cpu", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "p4" in out and "p3_im2col" in out and "cudnn" in out and "bound" in out
    assert probe_sublane_conv.bound(5000, 32, 16, 2048) == pytest.approx(
        ((2048 * 16 * 5014 + 2048 * 32 * 2500 + 15 * 16 * 32 + 32) * 4 / 3.35e12 * 1e3, "bytes"))


@pytest.mark.parametrize("case", ["cpu", "dtype", "contiguity"])
def test_launch_path_checks_in_one_pass(case):
    """The probes' launch path raises before any launch: a CPU tensor (the
    wrappers take the plain versions for those; ``_launch`` itself refuses
    them), a wrong dtype, a non-contiguous tensor."""
    x = torch.zeros(64, 128)
    err = RuntimeError
    if case == "dtype":
        x, err = x.double(), TypeError
    elif case == "contiguity":
        x, err = x.t(), TypeError
    before = kp.launches
    with pytest.raises(err, match="CUDA tensor" if case == "cpu" else "contiguous f32"):
        kp._launch("ptbxl_probe_transpose", (128, 64), (x,), (64, 128))
    assert kp.launches == before


def test_launch_path_counts_launches(monkeypatch):
    """One count a launch; the entry gets (device, inputs..., out, ints...,
    stream) with the entry bound once and the raw stream handle.  The device
    index, the C entry and the stream are stand-ins here (no card), put in
    at the launcher's seam (``_build.Library.entries``, ``_build.raw_stream``)."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(_build, "raw_stream", lambda idx: 1234)
    monkeypatch.setattr(kp.LIB, "entries",
                        {"ptbxl_probe_roll_add": lambda *a: calls.append(a) or 0})
    x = torch.zeros(8, 16)
    before = kp.launches
    out = kp._launch("ptbxl_probe_roll_add", (8, 16), (x,), (8, 16, -5, 3))
    assert kp.launches == before + 1 and out.shape == (8, 16)
    assert calls == [(0, x.data_ptr(), out.data_ptr(), 8, 16, -5, 3, 1234)]


def test_launcher_hands_the_entry_device_pointers_ints_and_stream(monkeypatch):
    """The one launcher under every kernel module (``_build.Library.launch``):
    the entry gets (device of the first tensor, a pointer a tensor and null
    for None in order, the ints as they are, the current stream), a call
    without a CUDA tensor raises before the entry is bound, and a non-zero
    code raises naming the entry and ``ptbxl_strerror``'s text.  The entries,
    device indices and stream are stand-ins (no card)."""
    calls = []
    lib = _build.Library("stand_in", {"ptbxl_stand_in": []})
    lib.entries = {"ptbxl_stand_in": lambda *a: calls.append(a) or 0,
                   "ptbxl_strerror": lambda err: b"an error text"}
    x, y = torch.zeros(4), torch.zeros(2)
    monkeypatch.setattr(_build, "raw_stream", lambda idx: 1000 + idx)
    with pytest.raises(RuntimeError, match="ptbxl_stand_in: the kernels need a CUDA tensor"):
        lib.launch("ptbxl_stand_in", x, None, y, 7)
    assert calls == []
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 3 if self is x else 5)
    lib.launch("ptbxl_stand_in", x, None, y, 7, -2)
    lib.launch("ptbxl_stand_in", None, y, x, 1)
    assert calls == [(3, x.data_ptr(), None, y.data_ptr(), 7, -2, 1003),
                     (5, None, y.data_ptr(), x.data_ptr(), 1, 1005)]
    lib.entries["ptbxl_stand_in"] = lambda *a: 700
    with pytest.raises(RuntimeError, match=r"ptbxl_stand_in: CUDA error 700 \(an error text\)"):
        lib.launch("ptbxl_stand_in", x, 1)
