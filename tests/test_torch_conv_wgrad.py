"""The f32 conv weight gradient of the train step (ptbxl_torch/ops/conv_wgrad.py over
ptbxl_torch/ops/kernels/conv_wgrad.py and ptbxl_torch/csrc/conv_wgrad.cu).

On the host: the plain version against the JAX package's conv gradient
(``jax.vjp`` of its ``ConvBlock.conv_only``) at each ECGCNN block's channel
counts; the kernel's 3xTF32 arithmetic (split operands, sums restarted every
stage, tap = 12 - 4j + r) emulated and held against f64 over a reduction as long
as block 0's at B=64; the wrapper's checks; which convs take the kernel; the
autograd route's dx and the ``train.step`` span's ``wgrad`` count, with a
counting stand-in for the kernel.  The ``card`` tests hold the kernel to f64 and
to itself bit for bit, and count it in train steps: ``python -m pytest
tests/test_torch_conv_wgrad.py -m card --noconftest -q`` on a machine with an
NVIDIA GPU.  JAX is imported only by the test that needs it.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from ptbxl_torch.models.ecg_cnn import ECGCNN  # noqa: E402
from ptbxl_torch.ops import conv_wgrad as route  # noqa: E402
from ptbxl_torch.ops.kernels import conv_wgrad as cw  # noqa: E402
from ptbxl_torch.training.loop import make_train_step  # noqa: E402
from ptbxl_torch.training.train_state import create_train_state  # noqa: E402
from ptbxl_torch.utils import profiling  # noqa: E402
from ptbxl_torch.utils.device import highest_precision  # noqa: E402

# (Cin, Cout, T at full length) of the ECGCNN's four blocks
BLOCKS = [(12, 32, 5000), (32, 64, 2500), (64, 128, 1250), (128, 256, 625)]
# |dW - f64| over the largest sum of |dy| |x|.  Random signs cancel most of a TF32
# product's error over a long sum: TF32 alone reads ~2^-18 at block 0's 320,000
# terms, the 3xTF32 emulation ~2^-24, the card's kernel ~2^-25 there and at
# most ~2^-22.5 on short ragged sums (its tensor-core sums truncate)
GATE = 2.0 ** -20


def _model(device="cpu", **kw):
    return ECGCNN(num_labels=5, generator=torch.Generator().manual_seed(0), **kw).to(device)


def _pair(seed, b, cin, cout, t, device="cpu"):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cin, t)).astype(np.float32))
    dy = torch.from_numpy((1e-3 * rng.standard_normal((b, cout, t))).astype(np.float32))
    return x.to(device), dy.to(device)


def _f64(x, dy):
    """dW in f64 by the framework's own weight gradient, and the scale of its sums."""
    shape = (dy.shape[1], x.shape[1], cw.K)
    want = torch.nn.grad.conv1d_weight(x.double(), shape, dy.double(), padding=cw.PAD)
    scale = torch.nn.grad.conv1d_weight(x.double().abs(), shape, dy.double().abs(),
                                        padding=cw.PAD)
    return want, float(scale.abs().max())


# -- the plain version against JAX --------------------------------------------------

@pytest.mark.parametrize("cin,cout,_t", BLOCKS)
def test_plain_matches_jax_conv_gradient(cin, cout, _t):
    """Each block's channel counts at small B and T: the plain dW against the
    kernel gradient of the JAX package's ``ConvBlock.conv_only`` (its conv,
    ``precision='highest'``) for the same cotangent."""
    import jax
    import jax.numpy as jnp

    from ptbxl_tpu.models.ecg_cnn import ConvBlock

    x, dy = _pair(cin, 3, cin, cout, 41)
    blk = ConvBlock(features=cout)
    xj = jnp.asarray(x.numpy().transpose(0, 2, 1))  # JAX's [B, T, Cin]
    params = blk.init(jax.random.PRNGKey(0), xj, method=ConvBlock.conv_only)
    _, pull = jax.vjp(lambda p: blk.apply(p, xj, method=ConvBlock.conv_only), params)
    (grads,) = pull(jnp.asarray(dy.numpy().transpose(0, 2, 1)))
    want = np.asarray(grads["params"]["conv"]["kernel"]).transpose(2, 1, 0)  # [Cout, Cin, 15]
    got = cw.conv_wgrad(x, dy)
    assert got.shape == (cout, cin, cw.K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,cin,cout,t", [(2, 12, 32, 1), (1, 5, 32, 14), (3, 20, 96, 37)])
def test_plain_matches_f64_at_ragged_shapes(b, cin, cout, t):
    """T shorter than the taps, a channel count off the 16-row tiles."""
    x, dy = _pair(t, b, cin, cout, t)
    want, scale = _f64(x, dy)
    assert float((cw.conv_wgrad_plain(x, dy).double() - want).abs().max()) <= GATE * scale


# -- the kernel's arithmetic, emulated --------------------------------------------

@pytest.mark.parametrize("stage_cols", [32, 64])
def test_emulated_3xtf32_holds_a_block0_length_reduction(stage_cols):
    """64 records of 5000 samples at block 0's channels: the 320,000-term sums of
    the split operands, restarted every stage (4 or 8 k8 steps) and added in
    f32, within the card's gate of f64, where one TF32 product is not."""
    x, dy = _pair(7, 64, 12, 32, 5000)
    want, scale = _f64(x, dy)
    got = cw.conv_wgrad_tf32x3_plain(x, dy, stage_cols)
    assert float((got.double() - want).abs().max()) <= GATE / 4 * scale
    one = cw.conv_wgrad_plain(cw.tf32_round(x), cw.tf32_round(dy))  # big*big alone
    assert float((one.double() - want).abs().max()) > 2 * GATE * scale


@pytest.mark.parametrize("cin,cout,_t", BLOCKS)
def test_emulated_tiling_matches_plain_at_each_block(cin, cout, _t):
    """The kernel's tap order (tap = 12 - 4j + r over t' in [0, T + 12)) and its
    16-row input tiles give every tap of every channel: the emulation against the
    plain version at each block's channels, an odd T."""
    x, dy = _pair(cout, 2, cin, cout, 45)
    want, scale = _f64(x, dy)
    got = cw.conv_wgrad_tf32x3_plain(x, dy)
    assert float((got.double() - want).abs().max()) <= GATE * scale
    assert float((cw.conv_wgrad_plain(x, dy).double() - want).abs().max()) <= GATE * scale


# -- the plan and the wrapper --------------------------------------------------------

@pytest.mark.parametrize("cin,cout,t,slices", [(12, 32, 5000, 264), (32, 64, 2500, 66),
                                               (64, 128, 1250, 16), (128, 256, 625, 4)])
def test_plan_fills_one_wave_at_the_cells_shapes(cin, cout, t, slices):
    """B=64: about 264 CTAs (two on each of the H100's SMs), each m64 x n128."""
    got, ws = cw.plan(64, t, cin, cout)
    tiles = -(-cin // 16) * (cout // 32)
    assert got == slices and got * tiles <= cw.SLOTS and ws == got * tiles * 64 * 128


def test_plan_never_cuts_finer_than_the_k_tiles():
    assert cw.plan(1, 1, 12, 32)[0] == 1  # one record, one K-tile
    assert cw.plan(3, 60, 12, 32)[0] == 6  # ceil(72 / 64) = 2 K-tiles a record
    assert cw.plan(64, 5000, 1024, 1024)[0] == 1  # more tiles than slots


@pytest.mark.parametrize("case", ["rank", "batch", "length", "dtype", "devices"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, dy = _pair(0, 2, 12, 32, 20)
    bad = {"rank": (x[0], dy), "batch": (x, dy[:1]), "length": (x, dy[..., :-1]),
           "dtype": (x.double(), dy), "devices": (x, dy.to("meta"))}[case]
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        cw.conv_wgrad(*bad)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    before = cw.launches
    x, dy = _pair(1, 2, 12, 32, 20)
    assert torch.equal(cw.conv_wgrad(x, dy), cw.conv_wgrad_plain(x, dy))
    assert cw.launches == before


# -- which convs take the kernel -------------------------------------------------------

def _operands(dtype=torch.float32, k=15, cout=64, grad=True):
    x = SimpleNamespace(is_cuda=True, dtype=dtype)
    w = SimpleNamespace(dtype=dtype, shape=(cout, 32, k), requires_grad=grad)
    return x, w


@pytest.fixture
def tf32(request):
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = request.param
    yield request.param
    cudnn.allow_tf32 = saved


@pytest.mark.parametrize("tf32", [False], indirect=True)
def test_f32_highest_with_grad_takes_the_kernel(tf32):
    assert route.takes_wgrad_kernel(*_operands(), (7,))
    assert route.takes_wgrad_kernel(*_operands(), 7)


DECLINED = {
    "bf16": lambda: (*_operands(torch.bfloat16), (7,)),
    "k=9": lambda: (*_operands(k=9), (7,)),
    "padding 0": lambda: (*_operands(), (0,)),
    "Cout 48": lambda: (*_operands(cout=48), (7,)),
    "no weight grad": lambda: (*_operands(grad=False), (7,)),
}


@pytest.mark.parametrize("tf32", [False], indirect=True)
@pytest.mark.parametrize("case", list(DECLINED))
def test_other_convs_keep_cudnn(case, tf32):
    assert not route.takes_wgrad_kernel(*DECLINED[case]())


@pytest.mark.parametrize("tf32", [True], indirect=True)
def test_tf32_default_keeps_cudnn(tf32):
    assert not route.takes_wgrad_kernel(*_operands(), (7,))


@pytest.mark.parametrize("tf32", [False], indirect=True)
def test_no_grad_and_cpu_keep_cudnn(tf32):
    with torch.no_grad():
        assert not route.takes_wgrad_kernel(*_operands(), (7,))
    x = torch.zeros(1, 32, 8)
    w = torch.zeros(64, 32, 15, requires_grad=True)
    assert not route.takes_wgrad_kernel(x, w, (7,))


def test_route_backward_gives_autograds_dx_bit_for_bit():
    """The Function's forward is ``F.conv1d``'s and its dx
    ``torch.nn.grad.conv1d_input``'s: the same bits as autograd through
    ``F.conv1d``; its dW the wrapper's (here the plain version)."""
    x, dy = _pair(3, 3, 32, 64, 101)
    w = torch.randn(64, 32, 15, generator=torch.Generator().manual_seed(0))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    ya = route._KernelWgradConv.apply(xa, wa)
    ya.backward(dy)
    yb = F.conv1d(xb, wb, padding=7)
    yb.backward(dy)
    assert torch.equal(ya, yb) and torch.equal(xa.grad, xb.grad)
    assert torch.equal(wa.grad, cw.conv_wgrad_plain(x, dy))


def test_route_skips_dx_where_the_input_needs_none():
    x, dy = _pair(4, 2, 12, 32, 30)
    w = torch.zeros(32, 12, 15, requires_grad=True)
    route._KernelWgradConv.apply(x, w).backward(dy)
    assert x.grad is None and w.grad is not None


# -- the train.step span's count, with a counting stand-in for the kernel ------------

def _counting_kernel(monkeypatch):
    """Every conv on the host takes the route; the kernel is the plain version
    counted as the card's wrapper counts its launches."""
    monkeypatch.setattr(route, "takes_wgrad_kernel", lambda x, w, padding: True)

    def counted(x, dy):
        cw.launches += 1
        return cw.conv_wgrad_plain(x, dy)

    monkeypatch.setattr(route, "conv_wgrad", counted)


def _step_counts(model, n=2, t=64):
    state = create_train_state(model, 1.5e-3, 1e-4)
    step = make_train_step()
    rng = np.random.default_rng(0)
    batches = [{"ecg": rng.standard_normal((4, t, 12)).astype(np.float32),
                "y": (rng.uniform(size=(4, 5)) < 0.3).astype(np.float32),
                "mask": np.ones(4, np.float32)} for _ in range(n)]
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for b in batches:
            step(state, b)
    got = [s.counts["wgrad"] for s in sorted(profiling.spans(), key=lambda s: s.start_ns)
           if s.name == "train.step"]
    profiling.clear()
    return got


def test_span_counts_the_routed_weight_gradients(monkeypatch):
    _counting_kernel(monkeypatch)
    assert _step_counts(_model()) == [4, 4]


def test_span_counts_the_phase_models_last_block_alone(monkeypatch):
    """``phase_train``: blocks 0-2 (even lengths) take the phase path, which
    never comes to the route; the last block (odd length) does."""
    _counting_kernel(monkeypatch)
    assert _step_counts(_model(phase_train=True), t=40) == [1, 1]


def test_routed_step_matches_autograds_step(monkeypatch):
    """One ECGCNN train step on the host through the route (dW the plain
    version) against the same step through autograd: the same loss, gradients
    within f32 rounding."""
    def run():
        model = _model()
        state = create_train_state(model, 1.5e-3, 1e-4)
        rng = np.random.default_rng(1)
        b = {"ecg": torch.from_numpy(rng.standard_normal((4, 64, 12)).astype(np.float32)),
             "y": torch.from_numpy((rng.uniform(size=(4, 5)) < 0.3).astype(np.float32)),
             "mask": torch.ones(4)}
        grads = {}
        for name, p in model.named_parameters():
            p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
        _, loss = make_train_step()(state, b)
        return float(loss), grads

    want_loss, want = run()
    _counting_kernel(monkeypatch)
    got_loss, got = run()
    assert got_loss == want_loss and got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)


# -- the card ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the conv_wgrad kernel")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("shape", [(64, *blk) for blk in BLOCKS]
                         + [(3, 12, 32, 37), (5, 64, 128, 1001), (2, 20, 96, 9)])
def test_card_kernel_within_gate_and_bit_equal(shape, card):
    """The cell's four B=64 shapes and ragged ones (T % 4 != 0 lands rows by
    4-byte copies; Cin off the tiles): within the gate of f64, and two launches
    equal bit for bit."""
    b, cin, cout, t = shape
    x, dy = _pair(t, b, cin, cout, t, "cuda")
    before = cw.launches
    got, again = cw.conv_wgrad(x, dy), cw.conv_wgrad(x, dy)
    assert cw.launches == before + 2
    want, scale = _f64(x, dy)
    assert float((got.double() - want).abs().max()) <= GATE * scale
    assert torch.equal(got, again)


@pytest.mark.card
def test_card_kernel_takes_a_transposed_view(card):
    """Block 0's input is the z-scored ``[B, T, 12]`` batch seen as ``[B, 12, T]``."""
    x, dy = _pair(5, 4, 12, 32, 500, "cuda")
    view = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    assert torch.equal(cw.conv_wgrad(view, dy), cw.conv_wgrad(x, dy))


@pytest.mark.card
def test_card_route_dx_is_cudnns(card):
    """dx from ``torch.nn.grad.conv1d_input`` under the deterministic scope is
    autograd's own dgrad bit for bit."""
    from ptbxl_torch.utils.device import deterministic_algorithms

    x, dy = _pair(6, 8, 64, 128, 1250, "cuda")
    w = torch.randn(128, 64, 15, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    with highest_precision(), deterministic_algorithms():
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        assert route.takes_wgrad_kernel(xa, wa, (7,))
        route.conv1d_same(xa, wa, (7,), True).backward(dy)
        xb = x.clone().requires_grad_()
        F.conv1d(xb, w.clone().requires_grad_(), padding=7).backward(dy)
    assert torch.equal(xa.grad, xb.grad)


def _card_counts(**kw):
    state = create_train_state(_model("cuda", **kw), 1.5e-3, 1e-4)
    step = make_train_step()
    rng = np.random.default_rng(0)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            b = {"ecg": torch.from_numpy(rng.standard_normal((8, 5000, 12)).astype(np.float32)),
                 "y": torch.from_numpy((rng.uniform(size=(8, 5)) < 0.3).astype(np.float32)),
                 "mask": torch.ones(8)}
            step(state, {k: v.cuda() for k, v in b.items()})
        torch.cuda.synchronize()
    steps = sorted((s for s in profiling.spans() if s.name == "train.step"),
                   key=lambda s: s.start_ns)
    profiling.clear()
    return [s.counts["graph"] for s in steps], [s.counts["wgrad"] for s in steps]


@pytest.mark.card
@pytest.mark.parametrize("case,want", [("f32", 4), ("bf16", 0), ("phase_train", 1)])
def test_card_train_step_span_counts_the_kernel(case, want, card):
    """4 in the f32 ECGCNN's steps, eager, captured and replayed; 0 in bf16
    (precision 'default'); 1 on a ``phase_train`` model (its last block)."""
    kw = {"f32": {}, "bf16": {"precision": "default", "dtype": torch.bfloat16},
          "phase_train": {"phase_train": True}}[case]
    graphs, wgrad = _card_counts(**kw)
    assert graphs == [0, 0, 1, 1] and wgrad == [want] * 4
