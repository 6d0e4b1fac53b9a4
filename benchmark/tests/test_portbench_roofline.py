"""The yardstick's operations and bytes against hand counts."""

import pytest

from benchmark import roofline, run

CFG = run.load_json(run.ROOT / "benchmark/configs/ecgcnn.json")
MM = run.load_json(run.ROOT / "benchmark/configs/multimodal.json")


def test_conv_flops_by_block():
    # 2 Cin Cout K T_out: 2*12*32*15*5000, 2*32*64*15*2500, 2*64*128*15*1250, 2*128*256*15*625
    assert roofline.conv_flops(CFG) == [57.6e6, 153.6e6, 307.2e6, 614.4e6]


def test_forward_and_train_flops():
    dense = 2 * 256 * 256 + 2 * 256 * 5
    assert roofline.dense_flops(CFG) == dense
    assert roofline.forward_flops(CFG, 1) == pytest.approx(1132.8e6 + dense)
    assert roofline.train_flops(CFG, 1) == pytest.approx(3 * 1132.8e6 - 57.6e6 + 3 * dense)
    extra = 2 * 5 * 64 + 2 * 64 * 64 + 2 * 64 * 512
    assert roofline.dense_flops(MM) == dense + extra


def test_param_count_and_bytes():
    assert roofline.param_count(CFG) == 719_397 + 2 * (32 + 64 + 128 + 256)
    rows = 512
    expect = rows * (5000 * 12 * 4 + 5 * 4) + 4 * roofline.param_count(CFG)
    assert roofline.forward_bytes(CFG, rows) == expect


def test_bound_is_operations_at_512_and_never_below_either_peak():
    b = roofline.forward_bound_s(CFG, 512)
    assert b == pytest.approx(roofline.forward_flops(CFG, 512) / 989e12)
    assert b * 1e3 == pytest.approx(0.5866, abs=1e-3)  # PERF.md's K2 bound at B=512
    assert roofline.forward_bound_s(CFG, 1) >= roofline.forward_bytes(CFG, 1) / 3.35e12
    assert roofline.bound_s(CFG, [512, 512]) == pytest.approx(2 * b)
