"""ST-MEM's ViT encoder in the port (``ptbxl_torch/models/st_mem.py``, served
by ``Predictor(arch="st_mem")``) against the repository's plain reference of
it, ``benchmark/reference/st_mem.py``, at a small size on the CPU: the module
at width 64, depth 2, 4 heads, MLP 128; ``Predictor``, which reads its heads
as 64 wide, at width 128 (2 heads); both with the published front end and
patching (12 leads of 2250 samples at 250 Hz in patches of 75, 384 tokens).
Every leaf is the seeded init moved by 0.1 N(0, 1), so no LayerNorm gain,
bias or embedding is trivial."""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.reference import st_mem as reference  # noqa: E402
from ptbxl_torch.inference import Predictor  # noqa: E402
from ptbxl_torch.models.factory import build_st_mem  # noqa: E402
from ptbxl_torch.models.st_mem import STMEM, widths  # noqa: E402
from ptbxl_torch.utils import profiling  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "benchmark/configs/st_mem.json").read_text())
SMALL = dict(width=64, depth=2, heads=4, mlp=128, patch=75, samples=2250, leads=12)
SERVED = dict(SMALL, width=128, heads=2)  # what Predictor builds: heads of 64
CFG = {**PUBLISHED, **{k: v for k, v in SMALL.items() if k != "samples"}}
CFG_SERVED = {**CFG, "width": SERVED["width"], "heads": SERVED["heads"]}
T = 5000  # 10 s at 500 Hz, resampled to 2500 and cut to 2250


def _state(depth=SMALL["depth"], seed=0, sizes=SMALL):
    model = build_st_mem(**{**sizes, "depth": depth}, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}


def _model(state, depth=SMALL["depth"]):
    model = STMEM(**{**SMALL, "depth": depth})
    model.load_state_dict(state)
    return model.eval()


def _records(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, T, 12)).astype(np.float32)


def test_module_matches_the_reference():
    # Both run in f32 from the same f32 resampling positions and the same
    # two-pass z-score; they differ only in the order of sums (SDPA's fused
    # softmax against the explicit one, LayerNorm's kernels), ~1e-7 relative
    # on logits of order 1, so 1e-5 holds with a hundredfold margin.
    state = _state()
    x = torch.from_numpy(_records(3))
    with torch.no_grad():
        got = _model(state)(x)
        want = reference.logits(state, CFG, x)
    assert got.shape == (3, 5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n, chunk_size", [(5, 2), (3, 8)], ids=["spans_chunks", "pads"])
def test_predictor_highest_matches_the_reference(n, chunk_size):
    # 5 records in chunks of 2 (the last padded to 2); 3 records in one
    # chunk padded to 4.  Probabilities move by at most a quarter of the
    # logits' 1e-5 (the sigmoid's slope).
    state = _state(sizes=SERVED)
    p = Predictor(state, arch="st_mem", precision="highest", chunk_size=chunk_size,
                  device="cpu")
    x = _records(n, seed=n)
    want = reference.probs(state, CFG_SERVED, x).numpy()
    np.testing.assert_allclose(p(x), want, rtol=0, atol=2.5e-6)
    np.testing.assert_allclose(p(x.transpose(0, 2, 1)), want, rtol=0, atol=2.5e-6)


@pytest.mark.parametrize("source", ["module", "reference"])
def test_published_widths_match_the_configuration(source):
    cfg_params = {k: list(s) for k, s in PUBLISHED["params"]}
    if source == "module":
        with torch.device("meta"):
            model = STMEM(heads=PUBLISHED["heads"])
        got = {k: list(v.shape) for k, v in model.state_dict().items()}
        sizes = widths(model.state_dict())  # what Predictor builds from these shapes
        assert {k: sizes[k] for k in ("width", "depth", "heads", "mlp", "patch", "leads")} == {
            k: PUBLISHED[k] for k in ("width", "depth", "heads", "mlp", "patch", "leads")}
        assert sizes["samples"] == PUBLISHED["model_samples"]
    else:
        got = {k: list(s) for k, s in reference.param_shapes(PUBLISHED)}
    assert got == cfg_params
    assert sum(int(np.prod(s)) for s in got.values()) == 85_152_773


@pytest.mark.parametrize("key, row, changes", [
    ("sep_embed", None, False), ("pos_embed", 0, False), ("pos_embed", -1, False),
    ("pos_embed", 1, True)], ids=["sigma", "P0", "P31", "P1"])
def test_sep_tokens_are_left_out_of_the_mean(key, row, changes):
    # at depth 0 a SEP token reaches the logits only through the mean
    state = _state(depth=0)
    x = torch.from_numpy(_records(2))
    moved = {k: v.clone() for k, v in state.items()}
    g = torch.Generator().manual_seed(7)
    if row is None:
        moved[key] += torch.randn(moved[key].shape, generator=g)
    else:
        moved[key][row] += torch.randn(moved[key].shape[1:], generator=g)
    with torch.no_grad():
        before, after = _model(state, 0)(x), _model(moved, 0)(x)
    assert (after - before).abs().max().item() > 1e-3 if changes else torch.equal(after, before)


@pytest.mark.parametrize("kw", [{"engine": "kernel"}, {"engine": "pallas"},
                                {"precision": "int8"}], ids=["kernel", "pallas", "int8"])
def test_unsupported_settings_raise(kw):
    with pytest.raises(ValueError, match="st_mem"):
        Predictor(_state(sizes=SERVED), arch="st_mem", device="cpu", **kw)


def test_default_runs_bf16_on_the_framework_engine():
    p = Predictor(_state(sizes=SERVED), arch="st_mem", precision="default", device="cpu")
    assert p.engine == "framework" and p.model.dtype == torch.bfloat16
    x = _records(2)
    # bf16 activations through two blocks: within 2e-2 of the f32 reference
    want = reference.probs(p.model.state_dict(), CFG_SERVED, x).numpy()
    np.testing.assert_allclose(p(x), want, rtol=0, atol=2e-2)


def test_encoder_and_attention_spans_are_recorded_with_their_counts():
    p = Predictor(_state(sizes=SERVED), arch="st_mem", chunk_size=2, device="cpu")
    x = _records(5)
    profiling.clear()
    p(x)
    assert not profiling.spans()  # nothing without a session
    with profile(activities=[ProfilerActivity.CPU]):
        p(x)
    got = profiling.spans()
    profiling.clear()
    tokens = 12 * 32
    enc = [s for s in got if s.name == "st_mem.encoder"]
    attn = [s for s in got if s.name == "st_mem.attention"]
    assert [dict(s.counts) for s in enc] == [{"rows": 2, "tokens": 2 * tokens}] * 3
    assert [dict(s.counts) for s in attn] == [
        {"rows": 2, "tokens": 2 * tokens, "heads": SERVED["heads"]}] * (3 * SERVED["depth"])
    by_id = {s.id: s for s in got}
    assert all(by_id[s.parent].name == "st_mem.encoder" for s in attn)
    assert all(by_id[s.parent].name == "predictor.framework" for s in enc)


@pytest.mark.card
@pytest.mark.parametrize("precision, atol", [("highest", 1e-5), ("default", 2e-2)])
def test_published_widths_on_the_card(precision, atol):
    """At the published widths on the H100, 600 records (two chunks, the
    second padded) against the f32 reference: ``highest`` within the f32
    cells' 1e-5 (f32 GEMMs with TF32 off, f32 attention), ``default`` (bf16)
    within the ``st_mem.bulk_bf16`` cell's limit, 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the published widths are timed there)")
    from benchmark import synth
    from benchmark.kinds.closed_st_mem import layer_norm_gains

    seed = 3000000051
    w = layer_norm_gains(synth.weights(PUBLISHED["params"], seed, "cuda"), seed, "cuda")
    x = synth.records(600, T, seed, "cuda")
    p = Predictor(w, arch="st_mem", precision=precision, device="cuda")
    want = reference.probs(w, PUBLISHED, x, device="cuda").numpy()
    np.testing.assert_allclose(p(x), want, rtol=0, atol=atol)
