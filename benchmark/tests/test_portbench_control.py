"""The control on the card: the reference in TF32 (in fp8 for the bf16
cell) in the program's place fails the check, at a size a test run can
hold, while the program passes it."""

import pytest

from benchmark import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
SMALL = {
    "ecgcnn.bulk": {"call_records": 1024, "pool_records": 1024},
    "ecgcnn.bulk_bf16": {"call_records": 1024, "pool_records": 1024},
    "multimodal.bulk": {"call_records": 1024, "pool_records": 1024},
    "ecgcnn.train": {"pool_records": 256},
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_the_check(name, card):
    res, checks = run.run_cell(BENCH, name, 3000000031, 1.0, False, card,
                               {"traffic": SMALL[name]}, control=True)
    assert res["correct"], res["checks"]
    assert any(res["control"][k] > lim for k, (_, lim) in checks.items())
