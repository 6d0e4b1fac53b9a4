"""The port's BatchSource / device_prefetch (ptbxl_torch/data/pipeline.py) and ADC
conversion (ptbxl_torch/ops/adc_convert.py) against ptbxl_tpu's."""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ptbxl_tpu.data.pipeline import BatchSource as JaxBatchSource  # noqa: E402
from ptbxl_tpu.ops.adc_convert import adc_lt_to_physical_batch as jax_adc_lt  # noqa: E402

from ptbxl_torch.data.pipeline import BatchSource, device_prefetch  # noqa: E402
from ptbxl_torch.ops.adc_convert import adc_lt_to_physical_batch  # noqa: E402
from tests.torch_port_common import InMemoryECG, InMemoryECGDemo  # noqa: E402


@pytest.mark.parametrize("demo", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_equal_jax(shuffle, demo):
    ds = (InMemoryECGDemo if demo else InMemoryECG)(n=21, t=40, seed=3)
    port = BatchSource(ds, 8, shuffle=shuffle, seed=5)
    ref = JaxBatchSource(ds, 8, shuffle=shuffle, seed=5, use_adc_cache=False)
    assert port.steps_per_epoch == ref.steps_per_epoch == 3
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w) == ({"ecg", "y", "mask"} | ({"demo"} if demo else set()))
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_padding_wraps_the_epoch_order():
    ds = InMemoryECG(n=10, t=16, seed=1)
    batches = list(BatchSource(ds, 4, shuffle=False).epoch(0))
    last = batches[-1]
    np.testing.assert_array_equal(last["mask"], [1, 1, 0, 0])
    # records 8, 9, then the order wrapped: 0, 1 (distinct records, not repeats)
    np.testing.assert_array_equal(last["ecg"], ds.x[[8, 9, 0, 1]].transpose(0, 2, 1))
    assert last["ecg"].shape == (4, 16, 12) and last["ecg"].flags["C_CONTIGUOUS"]


def test_shuffle_is_deterministic_per_epoch():
    ds = InMemoryECG(n=12, t=8, seed=2)
    src = BatchSource(ds, 4, shuffle=True, seed=7)
    y = lambda e: np.concatenate([b["y"] for b in src.epoch(e)])  # noqa: E731
    np.testing.assert_array_equal(y(0), y(0))
    assert not np.array_equal(y(0), y(1))
    np.testing.assert_array_equal(np.sort(y(0), axis=0), np.sort(ds.y.astype(np.float32), axis=0))


def test_prefetch_moves_batches_in_order():
    ds = InMemoryECGDemo(n=9, t=8, seed=4)
    host = list(BatchSource(ds, 4, shuffle=True, seed=1).epoch(0))
    got = list(device_prefetch(iter(host), device="cpu"))
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert set(g) == set(h)
        for k in h:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), h[k])


def test_prefetch_reraises_producer_error():
    def host():
        yield {"mask": np.ones(2, np.float32)}
        raise OSError("disk gone")

    it = device_prefetch(host(), device="cpu")
    assert next(it)["mask"].shape == (2,)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_abandoned_consumer_releases_producer():
    pulled = []

    def endless():
        while True:
            pulled.append(1)
            yield {"mask": np.ones(2, np.float32)}

    before = set(threading.enumerate())
    it = device_prefetch(endless(), device="cpu", depth=2)
    next(it)
    it.close()  # the consumer stops early
    deadline = time.time() + 10
    while time.time() < deadline and any(t.is_alive() for t in set(threading.enumerate()) - before):
        time.sleep(0.05)
    assert not any(t.is_alive() for t in set(threading.enumerate()) - before)
    n = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == n  # nothing is pulled after the release


def test_adc_convert_matches_jax():
    rng = np.random.default_rng(0)
    adc = rng.integers(-3000, 3000, size=(3, 12, 50)).astype(np.int16)
    adc[0, 2, 5] = -32768  # the WFDB missing-sample sentinel
    gain = rng.uniform(100, 1000, (3, 12)).astype(np.float32)
    base = rng.integers(-50, 50, (3, 12)).astype(np.float32)
    want = np.asarray(jax_adc_lt(jnp.asarray(adc), jnp.asarray(gain), jnp.asarray(base)))
    got = adc_lt_to_physical_batch(torch.from_numpy(adc), torch.from_numpy(gain),
                                   torch.from_numpy(base)).numpy()
    assert got.shape == (3, 50, 12) and got.dtype == np.float32
    assert np.isnan(got[0, 5, 2]) and np.isnan(want[0, 5, 2])
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
