"""ECGFounder's Net1D in the port (``ptbxl_torch/models/ecgfounder.py``, served
by ``Predictor(arch="ecgfounder")``) against the repository's plain reference
of it, ``benchmark/reference/ecgfounder.py``, at a small size on the CPU:
widths [16, 32, 32] in [2, 1, 2] blocks, k=16, groups 8 wide, 3 labels, a
stem of 13 channels (so the first stage's 3 zero channels split unevenly, 1
before and 2 after), at T=5000 (lengths 2500, 1250, 625, 313: an odd length
into a strided block) and at T=1001 (an odd length into the stem).  Every
leaf is the seeded init moved by 0.1 N(0, 1), so no bias or gate is
trivial.  At the published widths the shapes, lengths and counts are checked
without a forward pass."""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.reference import ecgfounder as reference  # noqa: E402
from ptbxl_torch.inference import Predictor  # noqa: E402
from ptbxl_torch.models import ecgfounder as program  # noqa: E402
from ptbxl_torch.models.ecgfounder import Net1D, same_pads, widths  # noqa: E402
from ptbxl_torch.models.factory import build_ecgfounder  # noqa: E402
from ptbxl_torch.utils import profiling  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "benchmark/configs/ecgfounder.json").read_text())
SMALL = dict(num_labels=3, in_channels=12, base_filters=13, filter_list=[16, 32, 32],
             m_blocks_list=[2, 1, 2], kernel_size=16, stride=2, groups_width=8)
CFG = {**PUBLISHED, **{k: v for k, v in SMALL.items() if k != "in_channels"}}
# f32 on both sides, sums in other orders (GEMM and conv2d against conv1d):
# ~1e-7 relative on logits of order 1, so 1e-5 holds with a wide margin
TOL = 1e-5


def _state(seed=0):
    model = build_ecgfounder(**SMALL, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}


def _model(state, **kw):
    model = Net1D(**SMALL, **kw)
    model.load_state_dict(state)
    return model.eval()


def _records(n, t=5000, seed=0):
    return np.random.default_rng(seed).standard_normal((n, t, 12)).astype(np.float32)


def _gap(state, t=5000, n=3):
    x = torch.from_numpy(_records(n, t))
    z = reference.zscore(x, PUBLISHED["zscore_eps"])
    with torch.no_grad():
        got = _model(state)(z)
        want = reference.logits(state, CFG, x)
    assert got.shape == want.shape == (n, 3)
    return float((got - want).abs().max())


@pytest.mark.parametrize("t", [5000, 1001])
def test_module_matches_the_reference(t):
    assert _gap(_state(), t) <= TOL


def test_default_is_bf16_within_its_tolerance():
    # bf16 activations (8 bits of mantissa, 2^-9 relative a rounding) through
    # five blocks of three convs each: logits within 5e-2 of the f32 reference,
    # where the pad and gate faults below move them by more than 1e-1
    state = _state()
    x = torch.from_numpy(_records(3))
    z = reference.zscore(x, PUBLISHED["zscore_eps"])
    with torch.no_grad():
        got = _model(state, precision="default", dtype=torch.bfloat16)(z)
        want = reference.logits(state, CFG, x)
    assert got.dtype == torch.bfloat16
    gap = float((got.float() - want).abs().max())
    assert 0 < gap <= 5e-2


def _pad_swapped(monkeypatch):
    real = program.same_pads

    def same_pads(length, kernel, stride):
        out, left, right = real(length, kernel, stride)
        return out, right, left  # 8 | 7 in place of 7 | 8

    monkeypatch.setattr(program, "same_pads", same_pads)


def _gate_left_out(monkeypatch):
    monkeypatch.setattr(program.Block, "gate", lambda self, out, dtype: torch.ones_like(out[:, 0]))


def _pool_minus_inf(monkeypatch):
    def pool_same(x, stride):
        xp = F.pad(x, (0, 0, 0, stride - 1), value=float("-inf"))
        n = xp.shape[1] // stride
        return xp[:, :n * stride].unflatten(1, (n, stride)).amax(dim=2)

    monkeypatch.setattr(program, "pool_same", pool_same)


@pytest.mark.parametrize("fault", [_pad_swapped, _gate_left_out, _pool_minus_inf],
                         ids=["pad_8_7", "no_gate", "pool_pad_minus_inf"])
def test_a_planted_fault_fails_the_tolerance(fault, monkeypatch):
    state = _state()
    assert _gap(state) <= TOL
    fault(monkeypatch)
    assert _gap(state) > 10 * TOL


def _lengths(t, stages):
    """The stem's output length, then each stage's (every one at stride 2)."""
    out = [same_pads(t, 16, 2)[0]]
    for _ in range(stages):
        out.append(same_pads(out[-1], 16, 2)[0])
    return out


def test_published_stage_lengths():
    assert _lengths(5000, 7) == [2500, 1250, 625, 313, 157, 79, 40, 20]
    assert same_pads(2500, 16, 1) == (2500, 7, 8)
    assert same_pads(2500, 16, 2) == (1250, 7, 7)
    assert same_pads(625, 16, 2) == (313, 7, 8)
    # the shortcut's pool: a zero after an odd length enters the last max
    x = torch.tensor([1.0, 3.0, -2.0, 4.0, -5.0])[None, :, None]
    assert program.pool_same(x, 2).flatten().tolist() == [3.0, 4.0, 0.0]
    assert program.pool_same(x[:, :4], 2).flatten().tolist() == [3.0, 4.0]


@pytest.mark.parametrize("source", ["module", "reference"])
def test_published_widths_match_the_configuration(source):
    cfg_params = {k: list(s) for k, s in PUBLISHED["params"]}
    if source == "module":
        with torch.device("meta"):
            model = Net1D()
        got = {k: list(v.shape) for k, v in model.state_dict().items()}
    else:
        got = {k: list(s) for k, s in reference.param_shapes(PUBLISHED)}
    assert list(got) == list(cfg_params) and got == cfg_params
    assert sum(int(np.prod(s)) for s in got.values()) == 30_752_646


def test_widths_round_trip_the_configuration():
    with torch.device("meta"):
        state = Net1D().state_dict()
    sizes = widths(state)  # what Predictor builds from these shapes
    assert sizes == {"num_labels": PUBLISHED["num_labels"], "in_channels": PUBLISHED["leads"],
                     **{k: PUBLISHED[k] for k in ("base_filters", "filter_list", "m_blocks_list",
                                                  "kernel_size", "groups_width")}}
    with torch.device("meta"):
        again = Net1D(**sizes).state_dict()
    assert {k: v.shape for k, v in again.items()} == {k: v.shape for k, v in state.items()}


@pytest.mark.parametrize("precision, atol", [("highest", 2.5e-6), ("default", 1.25e-2)])
def test_predictor_matches_the_reference_across_chunks(precision, atol):
    # 5 records in chunks of 2, the last padded; probabilities move by at most
    # a quarter of the logits' tolerance (the sigmoid's slope)
    state = _state()
    p = Predictor(state, arch="ecgfounder", precision=precision, chunk_size=2, device="cpu")
    assert p.engine == "framework" and p._num_labels == 3
    assert p.model.dtype == (torch.float32 if precision == "highest" else torch.bfloat16)
    x = _records(5, seed=5)
    want = reference.probs(state, CFG, x).numpy()
    got = p(x)
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(p(x.transpose(0, 2, 1)), got, rtol=0, atol=0)
    # the parameters are held in the compute dtype: the module's own rounding
    assert {v.dtype for v in p.model.state_dict().values()} == {p.model.dtype}
    z = reference.zscore(torch.from_numpy(x), PUBLISHED["zscore_eps"])
    with torch.no_grad():
        own = _model(state, precision=precision, dtype=p.model.dtype)(z)
        np.testing.assert_array_equal(p.model(z).float().numpy(), own.float().numpy())


@pytest.mark.parametrize("kw", [{"engine": "kernel"}, {"engine": "pallas"},
                                {"precision": "int8"}], ids=["kernel", "pallas", "int8"])
def test_unsupported_settings_raise(kw):
    with pytest.raises(ValueError, match="ecgfounder"):
        Predictor(_state(), arch="ecgfounder", device="cpu", **kw)


def test_from_checkpoint_raises():
    with pytest.raises(ValueError, match="ecgfounder"):
        Predictor.from_checkpoint("missing.pth", arch="ecgfounder", device="cpu")


def test_encoder_and_stage_spans_are_recorded_with_their_counts():
    p = Predictor(_state(), arch="ecgfounder", chunk_size=2, device="cpu")
    x = _records(5, t=1001)
    profiling.clear()
    p(x)
    assert not profiling.spans()  # nothing without a session
    with profile(activities=[ProfilerActivity.CPU]):
        p(x)
    got = profiling.spans()
    profiling.clear()
    enc = [s for s in got if s.name == "ecgfounder.encoder"]
    stages = [s for s in got if s.name == "ecgfounder.stage"]
    assert [dict(s.counts) for s in enc] == [{"rows": 2, "samples": 2 * 1001}] * 3
    lengths = _lengths(1001, 3)[1:]  # 251, 126, 63
    want = [{"rows": 2, "channels": c, "length": t, "blocks": m}
            for c, t, m in zip(SMALL["filter_list"], lengths, SMALL["m_blocks_list"])]
    assert [dict(s.counts) for s in stages] == want * 3
    by_id = {s.id: s for s in got}
    assert all(by_id[s.parent].name == "ecgfounder.encoder" for s in stages)
    assert all(by_id[s.parent].name == "predictor.framework" for s in enc)


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_graphed_forward_is_the_eager_forward_on_the_card(precision):
    """On one GPU ``Predictor`` replays Net1D's pieces as CUDA graphs: the
    eager forward's kernels on its shapes, so the same probabilities for every
    shape (chunks of 2 and the bucketed call of 1), after the capture too, and
    the same spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    p = Predictor(_state(), arch="ecgfounder", precision=precision, chunk_size=2,
                  device="cuda")
    assert p.model.graphed
    x = _records(5, seed=5)
    got = [p(x), p(x[:1]), p(x)]
    assert len(p.model._graphs) == 2
    with profile(activities=[ProfilerActivity.CPU]):
        p(x)
    spans = profiling.spans()
    profiling.clear()
    p.model.graphed = False
    assert not p.model._graphs
    want = [p(x), p(x[:1])]
    for g, w in zip(got, [want[0], want[1], want[0]]):
        np.testing.assert_array_equal(g, w)
    stages = [dict(s.counts) for s in spans if s.name == "ecgfounder.stage"]
    lengths = _lengths(5000, 3)[1:]
    assert stages == [{"rows": 2, "channels": c, "length": t, "blocks": m} for c, t, m in
                      zip(SMALL["filter_list"], lengths, SMALL["m_blocks_list"])] * 3
