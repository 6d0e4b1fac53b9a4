"""The port's numpy compute_metrics (ptbxl_torch/training/metrics.py) against
ptbxl_tpu/training/metrics.py (scikit-learn), edge cases included."""

import warnings

import numpy as np
import pytest

pytest.importorskip("sklearn")

from ptbxl_tpu.training.metrics import compute_metrics as sk_metrics  # noqa: E402

from ptbxl_torch.training.metrics import compute_metrics  # noqa: E402

RTOL = 1e-12  # the same rational numbers, summed in another order


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    y = (rng.uniform(size=(40, 5)) > 0.6).astype(np.float32)
    p = rng.uniform(size=(40, 5)).astype(np.float32)
    if name == "tied":  # scores on a coarse grid: many ties across labels
        p = np.round(p * 4) / 4
    elif name == "single_class":  # one all-positive column: AUROC nan
        y[:, 2] = 1.0
    elif name == "all_negative":  # one all-negative column: AUROC nan, AP 0
        y[:, 1] = 0.0
    elif name == "one_label":  # the AF task: [N, 1]
        y, p = y[:, :1], p[:, :1]
    elif name == "one_label_1d":
        y, p = y[:, 0], p[:, 0]
    elif name == "one_label_all_negative":
        y, p = np.zeros((40, 1), np.float32), p[:, :1] * 0.4  # no positive predicted either
    elif name == "perfect":
        p = np.where(y > 0, 0.9, 0.1).astype(np.float32)
    return y, p


@pytest.mark.parametrize("name", ["random", "tied", "single_class", "all_negative", "one_label",
                                  "one_label_1d", "one_label_all_negative", "perfect"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_matches_sklearn(name, threshold):
    y, p = _case(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = sk_metrics(y, p, threshold=threshold)
    got = compute_metrics(y, p, threshold=threshold)
    assert set(got) == set(want)
    for k, v in want.items():
        if np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)


def test_edge_values():
    y, p = _case("all_negative")
    m = compute_metrics(y, p)
    assert np.isnan(m["auroc_macro"])
    per_label = [compute_metrics(y[:, j], p[:, j])["auprc_macro"] for j in range(5)]
    assert per_label[1] == 0.0  # no positives: AP 0 for that label
    np.testing.assert_allclose(m["auprc_macro"], np.mean(per_label), rtol=RTOL)
