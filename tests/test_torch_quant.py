"""The port's int8 post-training quantization (``ptbxl_torch/ops/quant.py`` and
``Predictor(precision='int8')``) against the JAX package's (``ptbxl_tpu/ops/
quant.py``), on the CPU.

Tolerances: the conv stack bit for bit given the same q-params and input
(layer sets whose bf16 layers feed an int8 layer: the requantization hides
the two packages' bf16 conv sum orders); ``int8_conv1d`` exact; JAX's
q-params through the port within 1e-4 of JAX's int8 forward on the demo
pack, at JAX's layer set (1, 3) and the port's shipped (3,) (6.0e-6 and
1.3e-5 measured); the port's own calibration, at both sets: activation scales within
1e-5 relative, at most 1e-4 of the int8 weights one step off, probabilities
within 1e-4 (8.3e-6 measured); the ``Predictor`` gates of
tests/test_quant.py:94-128.
"""

import glob
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ptbxl_torch.inference import Predictor  # noqa: E402
from ptbxl_torch.models.params_io import load_checkpoint  # noqa: E402
from ptbxl_torch.ops import quant as tq  # noqa: E402
from ptbxl_tpu.inference import Predictor as JaxPredictor  # noqa: E402
from ptbxl_tpu.models.params_io import load_npz  # noqa: E402
from ptbxl_tpu.ops import quant as jq  # noqa: E402
from tests.torch_port_common import CKPT, CKPT_AF, CKPT_MM, HERE, demo_signals, mm_demo_pack  # noqa: E402

CPU = torch.device("cpu")


def _tiny_folded(rng, n_blocks=2, chans=(8, 16), cin0=4):
    """tests/test_quant.py's tiny BN-folded stack."""
    folded = {"n_blocks": n_blocks}
    cin = cin0
    for i, cout in enumerate(chans):
        folded[f"w{i}"] = (rng.standard_normal((15, cin, cout)) / np.sqrt(15 * cin)).astype(np.float32)
        folded[f"b{i}"] = (0.1 * rng.standard_normal((cout,))).astype(np.float32)
        cin = cout
    folded["proj_w"] = rng.standard_normal((chans[-1], 8)).astype(np.float32)
    folded["proj_b"] = np.zeros(8, np.float32)
    folded["head_w"] = rng.standard_normal((8, 3)).astype(np.float32)
    folded["head_b"] = np.zeros(3, np.float32)
    return folded


def _jax_to_port(qj):
    """A JAX q-param dict as the port's (CPU tensors, the same dtypes)."""
    q = {"n_blocks": qj["n_blocks"], "int8_layers": tuple(qj["int8_layers"])}
    for k, v in qj.items():
        if hasattr(v, "shape"):
            a = np.asarray(v)
            q[k] = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                    if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a)))
    return q


@pytest.fixture(scope="module")
def sigs():
    return demo_signals()


@pytest.fixture(scope="module")
def state():
    return load_checkpoint(CKPT)[0]


@pytest.fixture(scope="module")
def p_hi():
    return Predictor.from_checkpoint(CKPT, engine="framework", device="cpu")


@pytest.fixture(scope="module")
def jax_demo_q(tmp_path_factory):
    """JAX's demo-pack q-params of the baseline, written by JAX's save_qparams."""
    variables, _ = load_npz(CKPT)
    q = jq.quantize_model(variables, arch="ecgcnn", calib_signals=jq.demo_pack_signals())
    path = str(tmp_path_factory.mktemp("q") / "jax_q.npz")
    jq.save_qparams(q, path)
    return q, path


@pytest.fixture(scope="module")
def jax_demo_q3(tmp_path_factory):
    """JAX's demo-pack q-params of the baseline at the port's shipped set (3,)."""
    variables, _ = load_npz(CKPT)
    q = jq.quantize_model(variables, arch="ecgcnn", calib_signals=jq.demo_pack_signals(),
                          int8_layers=(3,))
    path = str(tmp_path_factory.mktemp("q3") / "jax_q3.npz")
    jq.save_qparams(q, path)
    return q, path


@pytest.fixture(scope="module")
def port_demo_q(state):
    """The port's calibration of JAX's default layer set (1, 3) on the demo pack."""
    return tq.quantize_model(state, calib_signals=tq.demo_pack_signals(), int8_layers=(1, 3),
                             device=CPU)


@pytest.fixture(scope="module")
def robust_q(state):
    return tq.quantize_model(state, device=CPU)


# -- the pieces -------------------------------------------------------------------

def test_quantize_folded_roundtrip(rng):
    folded = _tiny_folded(rng)
    scales = {1: np.full(8, 0.05, np.float32)}  # layer 1 only
    q = tq.quantize_folded(folded, scales, int8_layers=(1,))
    assert q["int8_layers"] == (1,)
    assert q["w0"].dtype == torch.bfloat16  # the bf16 layer keeps its weights
    w1 = q["w1"].numpy()
    assert w1.dtype == np.int8 and np.abs(w1).max() <= 127
    sw = q["sw1"].numpy()
    wf = folded["w1"] * scales[1][None, :, None]
    err = np.abs(w1.astype(np.float32) * sw[None, None, :] - wf)
    assert err.max() <= sw.max() / 2 + 1e-7  # within half a step
    assert np.abs(w1).max() == 127  # absmax: the full range is used
    # the same numbers as JAX's quantize_folded
    qj = jq.quantize_folded(folded, scales, int8_layers=(1,))
    for k in ("w0", "w1", "sw1", "sx1", "b0", "b1", "proj_w", "head_w"):
        np.testing.assert_array_equal(q[k].float().numpy(), np.asarray(qj[k]).astype(np.float32))


def test_calibration_per_channel_shapes(rng):
    folded = _tiny_folded(rng)
    x = torch.from_numpy(rng.standard_normal((2, 64, 4)).astype(np.float32))
    scales = tq.calibrate_act_scales(folded, x, int8_layers=(0, 1))
    assert set(scales) == {0, 1}
    assert scales[0].shape == (4,) and scales[1].shape == (8,)
    assert (scales[0] > 0).all() and (scales[1] > 0).all()
    # absmax: scale * 127 is the channel's max |input|
    np.testing.assert_allclose(scales[0] * 127.0, x.abs().amax(dim=(0, 1)).numpy(), rtol=1e-5)
    want = jq.calibrate_act_scales(folded, jnp.asarray(x.numpy()), int8_layers=(0, 1))
    for i in (0, 1):
        np.testing.assert_allclose(scales[i], want[i], rtol=1e-5)


@pytest.mark.parametrize("layers", [(1, 3), (0, 1, 2, 3), (1, 2, 3), (0, 1, 3), (3,)])
@pytest.mark.parametrize("widths", ["tiny", "full"])
def test_conv_stack_bit_for_bit_against_jax(layers, widths):
    """The mixed int8/bf16 stack equals JAX's ``_conv_stack`` bit for bit on
    the same q-params and z-scored input (tiny: channels 4->8->16->16->32 at
    T=256, K padded 60 -> 64; full: 12->32->64->128->256 at T=1000)."""
    rng = np.random.default_rng(7)
    chans, cin0, t = ((8, 16, 16, 32), 4, 256) if widths == "tiny" else ((32, 64, 128, 256), 12, 1000)
    folded = _tiny_folded(rng, 4, chans, cin0)
    x = jq.zscore_per_lead_batch(jnp.asarray(rng.standard_normal((3, t, cin0)).astype(np.float32) * 3 + 1))
    qj = jq.quantize_folded(folded, jq.calibrate_act_scales(folded, x, layers), layers)
    arrs, nb, ls = jq.split_meta(qj)
    want = np.asarray(jax.jit(lambda a, h: jq._conv_stack(a, h, nb, ls))(arrs, x).astype(jnp.float32))
    got = tq._conv_stack(_jax_to_port(qj), torch.from_numpy(np.array(x)), nb, ls)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("layers", [(3,), (0, 3), (1, 3), (0, 1, 2, 3), ()])
def test_block_by_block_equals_the_stack(layers):
    """``conv_stack_inputs`` (``conv_stack_block`` chained from
    ``block0_operand``: the blocks ``bench_ceiling`` times one by one) ends in
    ``_conv_stack``'s output bit for bit, and ``dense_tail`` on it is the
    quantized forward's probabilities bit for bit."""
    rng = np.random.default_rng(11)
    folded = _tiny_folded(rng, 4, (8, 16, 16, 32), 4)
    x = torch.from_numpy(rng.standard_normal((3, 256, 4)).astype(np.float32) * 3 + 1)
    xz = tq.zscore_per_lead_batch_onepass(x)
    q = tq.quantize_folded(folded, tq.calibrate_act_scales(folded, xz, layers), layers)
    arrs, nb, ls = tq.split_meta(q)
    hs = tq.conv_stack_inputs(arrs, x, nb, ls)
    assert len(hs) == nb + 1
    assert hs[0].dtype == (torch.float32 if 0 in ls else torch.bfloat16)
    for i in range(1, nb):  # an int8 block takes int8 when the block before requantized
        assert hs[i].dtype == (torch.int8 if i in ls else torch.bfloat16), i
    want = tq._conv_stack(arrs, xz, nb, ls)
    assert torch.equal(hs[-1].transpose(1, 2), want)
    probs = tq.make_quantized_forward(nb, ls, arch="ecgcnn")(arrs, x)
    assert torch.equal(tq.dense_tail(arrs, hs[-1].transpose(1, 2)), probs)


@pytest.mark.parametrize("b,t,cin,cout", [
    (2, 40, 12, 32),   # layer 0's channels: K = 180 padded to 184
    (1, 37, 32, 64),   # one record: im2col's reshape is an overlapping view
    (1, 5, 16, 8),     # M = 5 rows padded to 17
    (3, 29, 64, 128),
    (2, 13, 128, 256),
])
def test_int8_conv1d_exact(b, t, cin, cout):
    """``int8_conv1d`` (im2col + ``torch._int_mm``) equals its plain version and
    an independent SAME conv in f64, exactly, on full-range int8 data."""
    g = torch.Generator().manual_seed(b * 1000 + t)
    xq = torch.randint(-127, 128, (b, t, cin), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (15, cin, cout), generator=g, dtype=torch.int8)
    wm = tq.int8_weight_matrix(w)
    assert wm.shape == (cout, -(-15 * cin // 8) * 8) and wm.is_contiguous()
    y = tq.int8_conv1d(xq, wm)
    assert y.dtype == torch.int32 and y.shape == (b, t, cout)
    torch.testing.assert_close(y, tq.int8_conv1d_plain(xq, wm), rtol=0, atol=0)
    ref = torch.nn.functional.conv1d(xq.double().transpose(1, 2), w.double().permute(2, 1, 0),
                                     padding=7).transpose(1, 2)
    torch.testing.assert_close(y, ref.to(torch.int32), rtol=0, atol=0)


def test_quantize_act_rounds_half_to_even():
    a = torch.tensor([[[0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0]]])
    got = tq.quantize_act(a, torch.ones(7))
    assert got.dtype == torch.int8
    assert got.flatten().tolist() == [0, 2, 2, 0, -2, 127, -127]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jq._quantize_act(jnp.asarray(a.numpy()), jnp.ones(7))))


def test_chunked_forward_equals_one_chunk(robust_q, sigs):
    """The records run in chunks under an im2col budget; the probs do not change."""
    arrs, nb, ls = tq.split_meta(robust_q)
    x = torch.from_numpy(np.ascontiguousarray(sigs.transpose(0, 2, 1)))
    whole = tq.make_quantized_forward(nb, ls, budget=None)(arrs, x)
    per_rec = 2500 * 480  # layer 1's columns of one record, the larger
    assert tq.chunk_records(5000, arrs, ls, budget=2 * per_rec) == 2
    chunked = tq.make_quantized_forward(nb, ls, budget=2 * per_rec)(arrs, x)
    # the f32 tail's sums may take another order at another batch size
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


# -- against JAX on the real checkpoints -------------------------------------------

def _jax_qparams_through_the_port(q, path, sigs, layers):
    want = JaxPredictor.from_checkpoint(CKPT, precision="int8", qparams=path)(sigs)
    got = Predictor.from_checkpoint(CKPT, precision="int8", qparams=path, device="cpu")(sigs)
    assert np.abs(got - want).max() <= 1e-4
    loaded = tq.load_qparams(path)
    assert loaded["n_blocks"] == 4 and loaded["int8_layers"] == layers
    for k, v in q.items():
        if hasattr(v, "shape"):
            a = np.asarray(v)
            assert str(loaded[k].dtype).replace("torch.", "") == a.dtype.name, k
            np.testing.assert_array_equal(loaded[k].float().numpy(), a.astype(np.float32))


def test_jax_qparams_through_the_port(jax_demo_q, sigs):
    """JAX save_qparams -> port load_qparams -> port forward, vs JAX's int8 forward."""
    _jax_qparams_through_the_port(*jax_demo_q, sigs, (1, 3))


def test_jax_qparams_through_the_port_shipped_set(jax_demo_q3, sigs):
    """The same at the port's shipped set (3,), whose three bf16 layers chain:
    JAX's (3,) q-params through the port within 1e-4 of JaxPredictor's."""
    _jax_qparams_through_the_port(*jax_demo_q3, sigs, (3,))


def _port_calibration_matches_jax(qj, qt, sigs, layers):
    assert qt["int8_layers"] == tuple(qj["int8_layers"]) == layers
    assert qt["n_blocks"] == qj["n_blocks"]
    assert list(k for k in qt if isinstance(qt[k], torch.Tensor)) == [
        k for k in qj if hasattr(qj[k], "shape")]  # the same keys in the same order
    for i in qt["int8_layers"]:
        for s in ("sx", "sw"):
            np.testing.assert_allclose(qt[f"{s}{i}"].numpy(), np.asarray(qj[f"{s}{i}"]),
                                       rtol=1e-5)
        a, b = qt[f"w{i}"].numpy().astype(np.int32), np.asarray(qj[f"w{i}"]).astype(np.int32)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-4
    bf16_layers = [i for i in range(4) if i not in layers]
    for k in [f"b{i}" for i in bf16_layers] + ["proj_w", "head_w"]:
        np.testing.assert_allclose(qt[k].float().numpy(), np.asarray(qj[k]).astype(np.float32),
                                   rtol=1e-5, atol=1e-6)
    for k in [f"w{i}" for i in bf16_layers]:  # bf16: a fold 1e-7 apart may round one step apart
        np.testing.assert_allclose(qt[k].float().numpy(), np.asarray(qj[k]).astype(np.float32),
                                   rtol=2 ** -7, atol=0)
    got = Predictor.from_checkpoint(CKPT, precision="int8", qparams=qt, device="cpu")(sigs)
    want = JaxPredictor.from_checkpoint(CKPT, precision="int8", int8_layers=layers,
                                        calib_signals=jq.demo_pack_signals())(sigs)
    assert np.abs(got - want).max() <= 1e-4


def test_port_calibration_matches_jax(jax_demo_q, port_demo_q, sigs):
    _port_calibration_matches_jax(jax_demo_q[0], port_demo_q, sigs, (1, 3))


def test_port_calibration_matches_jax_shipped_set(jax_demo_q3, state, sigs):
    """The port's own demo calibration at (3,) against JAX's, in the same bounds."""
    qt = tq.quantize_model(state, calib_signals=tq.demo_pack_signals(), int8_layers=(3,),
                           device=CPU)
    _port_calibration_matches_jax(jax_demo_q3[0], qt, sigs, (3,))


def test_port_qparams_load_in_jax(port_demo_q, tmp_path):
    path = str(tmp_path / "port_q.npz")
    assert tq.save_qparams(port_demo_q, path) == path
    assert not os.path.exists(path + ".tmp")
    qj = jq.load_qparams(path)
    assert qj["n_blocks"] == 4 and qj["int8_layers"] == (1, 3)
    for k, v in port_demo_q.items():
        if isinstance(v, torch.Tensor):
            a = np.asarray(qj[k])
            assert a.dtype.name == str(v.dtype).replace("torch.", ""), k
            np.testing.assert_array_equal(a.astype(np.float32), v.float().numpy())
    with np.load(path) as z:
        assert sorted(str(k) for k in z["__bf16_keys__"]) == ["w0", "w2"]


def test_qparams_save_load_roundtrip(robust_q, sigs, tmp_path):
    """save_qparams -> Predictor(qparams=path) equals the in-process q-params exactly."""
    path = str(tmp_path / "q.npz")
    tq.save_qparams(robust_q, path)
    q2 = tq.load_qparams(path)
    for k, v in robust_q.items():
        if isinstance(v, torch.Tensor):
            assert q2[k].dtype == v.dtype, k
            torch.testing.assert_close(q2[k], v, rtol=0, atol=0)
    live = Predictor.from_checkpoint(CKPT, precision="int8", qparams=robust_q, device="cpu")
    disk = Predictor.from_checkpoint(CKPT, precision="int8", qparams=path, device="cpu")
    np.testing.assert_array_equal(live(sigs), disk(sigs))


# -- the Predictor ----------------------------------------------------------------

def test_default_int8_layers():
    """The port ships the H100 sweep's set, the deep layer alone, for every model
    (PERF.md, tools/tune_int8.py); JAX ships its TPU sweep's (1, 3) for the ECGCNN."""
    assert tq.DEFAULT_INT8_LAYERS == (3,)
    assert tq.default_int8_layers("ecgcnn") == tq.default_int8_layers("multimodal") == (3,)
    assert jq.default_int8_layers("ecgcnn") == (1, 3)
    assert tq.default_int8_layers("multimodal") == jq.default_int8_layers("multimodal")


def test_default_calib_signals_is_the_robust_preset():
    x = tq.default_calib_signals()
    assert x.shape == (71, 5000, 12) and x.dtype == np.float32
    np.testing.assert_array_equal(x, jq.default_calib_signals())


def test_int8_predictor_baseline_gate(p_hi, robust_q, sigs):
    """Robust (default) calibration within the battery gate of the f32 path on
    the demo pack; demo-pack calibration within 5e-3."""
    ref = p_hi(sigs)
    p_q = Predictor.from_checkpoint(CKPT, precision="int8", device="cpu")
    assert p_q.engine == "framework" and p_q.int8_layers == (3,)
    got = p_q(sigs)
    np.testing.assert_array_equal(
        got, Predictor.from_checkpoint(CKPT, precision="int8", qparams=robust_q, device="cpu")(sigs))
    assert np.abs(got - ref).max() < 4e-2
    p_demo = Predictor.from_checkpoint(CKPT, precision="int8", device="cpu",
                                       calib_signals=tq.demo_pack_signals())
    assert np.abs(p_demo(sigs) - ref).max() < 5e-3


def test_int8_predictor_multimodal_gate():
    sigs, demos = mm_demo_pack()
    ref = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", engine="framework",
                                    device="cpu")(sigs, demo=demos)
    p_q = Predictor.from_checkpoint(CKPT_MM, arch="multimodal", precision="int8", device="cpu")
    assert p_q.int8_layers == (3,)
    assert np.abs(p_q(sigs, demo=demos) - ref).max() < 4e-2


def test_int8_predictor_af_gate(sigs):
    ref = Predictor.from_checkpoint(CKPT_AF, num_labels=1, engine="framework", device="cpu")(sigs)
    got = Predictor.from_checkpoint(CKPT_AF, num_labels=1, precision="int8", device="cpu")(sigs)
    assert got.shape == (7, 1) and np.abs(got - ref).max() < 4e-2


@pytest.mark.parametrize("engine", ["kernel", "pallas"])
def test_int8_rejects_the_kernel_engine(engine):
    with pytest.raises(ValueError, match="int8"):
        Predictor.from_checkpoint(CKPT, precision="int8", engine=engine, device="cpu")


def test_int8_auto_resolves_to_framework(robust_q):
    p = Predictor.from_checkpoint(CKPT, precision="int8", engine="auto", qparams=robust_q,
                                  device="cpu")
    assert p.engine == "framework" and not p._use_kernel(1)


def test_int8_layers_override(p_hi, sigs):
    p_q = Predictor.from_checkpoint(CKPT, precision="int8", int8_layers=(2, 3), device="cpu")
    assert p_q.int8_layers == (2, 3)
    assert np.abs(p_hi(sigs[:2]) - p_q(sigs[:2])).max() < 2e-2


def test_int8_custom_calib_signals_both_layouts(sigs):
    a = Predictor.from_checkpoint(CKPT, precision="int8", calib_signals=sigs, device="cpu")
    b = Predictor.from_checkpoint(CKPT, precision="int8", calib_signals=sigs.transpose(0, 2, 1),
                                  device="cpu")
    np.testing.assert_allclose(a(sigs), b(sigs), atol=1e-6)


def test_int8_num_labels_mismatch_raises(tmp_path):
    """A head of another size raises, naming both sizes: the checkpoint's
    (the model's own check), and q-params of another head."""
    with pytest.raises(ValueError, match=r"ckpt \(1, 256\) vs model \(5, 256\)"):
        Predictor.from_checkpoint(CKPT_AF, precision="int8", device="cpu")
    af_q = tq.quantize_model(load_checkpoint(CKPT_AF)[0], calib_signals=demo_signals()[:2],
                             device="cpu")
    with pytest.raises(ValueError, match="1 labels but num_labels=5"):
        Predictor.from_checkpoint(CKPT, precision="int8", qparams=af_q, device="cpu")


def test_int8_layers_out_of_range_raises(rng, state):
    folded = _tiny_folded(rng)  # 2 blocks
    with pytest.raises(ValueError, match=r"int8_layers \[4\]"):
        tq.calibrate_act_scales(folded, torch.zeros(1, 32, 4), int8_layers=(0, 4))
    with pytest.raises(ValueError, match="out of range"):
        tq.quantize_folded(folded, {}, int8_layers=(-1,))
    with pytest.raises(ValueError, match="0..3"):
        tq.quantize_model(state, calib_signals=demo_signals()[:1], int8_layers=(4,), device="cpu")


def test_int8_data_parallel_matches_one_device(robust_q, sigs):
    """One copy of the q-params on each of two CPU devices; rows split in order."""
    one = Predictor.from_checkpoint(CKPT, precision="int8", qparams=robust_q, device="cpu")
    dp = Predictor.from_checkpoint(CKPT, precision="int8", qparams=robust_q, data_parallel=True,
                                   chunk_size=8, device=["cpu", "cpu"])
    assert dp._replicas is dp._quant
    assert [d for d, _ in dp._replicas] == [CPU, CPU]
    assert all(a.device == CPU for _, run in dp._replicas for a in run.args[0].values())
    np.testing.assert_allclose(dp(sigs), one(sigs), atol=1e-6)


def test_int8_needs_a_device_or_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.from_checkpoint(CKPT, precision="int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tq.quantize_model(load_checkpoint(CKPT)[0])


def test_demo_pack_signals():
    x = tq.demo_pack_signals()
    assert x.shape == (7, 5000, 12) and x.dtype == np.float32
    np.testing.assert_array_equal(x, jq.demo_pack_signals())
    assert len(glob.glob(os.path.join(HERE, "data/demo/single/*.npz"))) == 7
