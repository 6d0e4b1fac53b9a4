"""P3's conv layer (``conv_layer`` in ptbxl_torch/ops/kernels/hybrid_ecgcnn.py) and
the port of tools/probe_layer_perf.py, against the JAX probe's ``xla_layer``
and its Pallas kernel (``make_pallas_layer``, both modes, in TPU interpret
mode).

tools/probe_layer_perf.py is imported by path (``tools`` is no package).  On
the CPU the port's wrapper takes its plain version; the CUDA kernels (the
``wgmma`` conv block for ``im2col``, K2's conv block for ``direct``) are
held against it on the card by chip_smoke.py.  The ``wgmma`` block's tiled
route is emulated here (``wgmma_conv_block_plain(..., valid=True)``).
"""

import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from ptbxl_torch.ops.kernels import hybrid_ecgcnn as k4  # noqa: E402
from ptbxl_torch.tools import probe_layer_perf as port_probe  # noqa: E402
from tests.torch_port_common import HERE  # noqa: E402

# bf16 products are exact in f32, so the two sides differ only in the order of
# f32 sums of up to 15 * 128 = 1,920 products, on outputs of size O(10)
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_layer_perf_jax", os.path.join(HERE, "tools", "probe_layer_perf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layer(t_in, cin, cout, b=2):
    rng = np.random.default_rng(cin)
    x = rng.standard_normal((b, t_in + 14, cin)).astype(np.float32)
    w = (rng.standard_normal((15 * cin, cout)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.01).astype(np.float32)
    return x, w, bias


def test_layers_are_the_probes(jax_probe):
    assert port_probe.LAYERS == jax_probe.LAYERS


@pytest.mark.parametrize("mode", k4.MODES)
@pytest.mark.parametrize("layer", [0, 1, 2, 3])
def test_plain_matches_xla_layer(jax_probe, layer, mode):
    t_in, cin, cout = jax_probe.LAYERS[layer]
    x, w, bias = _layer(t_in, cin, cout)
    want = np.asarray(jax_probe.xla_layer(t_in, cin, cout)(jnp.asarray(w), jnp.asarray(bias),
                                                           jnp.asarray(x)))
    got = k4.conv_layer_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                              mode).numpy()
    assert got.shape == want.shape == (2, t_in // 2, cout)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("mode", k4.MODES)
def test_odd_length_floors_the_pool(jax_probe, mode):
    x, w, bias = _layer(501, 64, 128)
    want = np.asarray(jax_probe.xla_layer(501, 64, 128)(jnp.asarray(w), jnp.asarray(bias),
                                                        jnp.asarray(x)))
    got = k4.conv_layer_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                              mode).numpy()
    assert got.shape == (2, 250, 128)
    np.testing.assert_allclose(got, want, atol=TOL)


# each reference layer's Cin -> Cout at a small T (one odd: the floor)
SMALL = [(64, 12, 32), (48, 32, 64), (33, 64, 128), (20, 128, 256)]


@pytest.mark.parametrize("mode", k4.MODES)
@pytest.mark.parametrize("t_in,cin,cout", SMALL)
def test_plain_and_wgmma_route_match_pallas_interpret(jax_probe, t_in, cin, cout, mode):
    """The probe's Pallas kernel (b_tile=2) in TPU interpret mode against the
    plain version of its mode and against the ``wgmma`` block's tiled route,
    which the card runs for both (1e-4: the same bf16 products, f32 sums in
    another order)."""
    x, w, bias = _layer(t_in, cin, cout)
    fn = jax_probe.make_pallas_layer(t_in, cin, cout, mode, 2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(w), jnp.asarray(bias), jnp.asarray(x)))
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias)
    got = k4.conv_layer_plain(xt, wt, bt, mode).numpy()
    route = k4.wgmma_conv_block_plain(xt, k4.wg_weight(wt.view(15, cin, cout)), bt,
                                      valid=True).numpy()
    assert got.shape == route.shape == want.shape == (2, t_in // 2, cout)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(route, want, atol=TOL, rtol=0)


def test_cpu_wrapper_dispatches_to_plain():
    x, w, bias = (torch.from_numpy(a) for a in _layer(625, 128, 256))
    before = k4.launches_layer
    for mode in k4.MODES:
        torch.testing.assert_close(k4.conv_layer(x, w, bias, mode),
                                   k4.conv_layer_plain(x, w, bias, mode), rtol=0, atol=0)
    assert k4.launches_layer == before  # the counter moves only for kernel launches


def test_bad_arguments_raise():
    x, w, bias = (torch.from_numpy(a) for a in _layer(1250, 64, 128))
    with pytest.raises(ValueError, match="mode"):
        k4.conv_layer(x, w, bias, "winograd")
    with pytest.raises(ValueError, match=r"15\*Cin"):
        k4.conv_layer(x, w[:-1], bias)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        k4.conv_layer(x.to("meta"), w.to("meta"), bias.to("meta"))


def test_cudnn_yardstick_matches_xla_layer(jax_probe):
    """The probe's library column (a bf16 conv in the framework, which rounds
    its output to bf16 before the f32 bias: 2^-8 relative, on outputs O(10))."""
    t_in, cin, cout = jax_probe.LAYERS[2]
    x, w, bias = _layer(t_in, cin, cout)
    want = np.asarray(jax_probe.xla_layer(t_in, cin, cout)(jnp.asarray(w), jnp.asarray(bias),
                                                           jnp.asarray(x)))
    got = port_probe.cudnn_layer(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-2)


def test_bounds_at_the_probes_batch():
    """B=2048: layers 0 and 1 move more bytes than the card streams in their
    FLOP time, layers 2 and 3 are operations (H100: 3.35 TB/s, 989 TFLOP/s)."""
    got = [port_probe.bound(*layer, 2048) for layer in port_probe.LAYERS]
    assert [b for _, b in got] == ["bytes", "bytes", "operations", "operations"]
    np.testing.assert_allclose([ms for ms, _ in got], [0.343, 0.392, 0.636, 1.272], atol=1e-3)


def test_probe_run_on_the_host():
    """``run`` at B=1 on the CPU: every layer, every column (host clocks)."""
    rows = port_probe.run(1, torch.device("cpu"), iters=1)
    assert [r["layer"] for r in rows] == [list(layer) for layer in port_probe.LAYERS]
    for r in rows:
        for col in ("im2col", "direct", "cudnn"):
            assert r[f"{col}_ms"] > 0 and r[f"{col}_tflops"] > 0
