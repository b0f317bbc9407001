"""The rank-based AUC of the SCM evaluation against sklearn's."""

import numpy as np
import pytest

from dualmessagepassing_tpu.train.scm_driver import roc_auc


@pytest.mark.parametrize("seed,n,ties", [(0, 50, False), (1, 400, True),
                                         (2, 7, True), (3, 1000, False)])
def test_roc_auc_matches_sklearn(seed, n, ties):
    metrics = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(seed)
    labels = rng.random(n) < 0.3
    labels[:2] = [True, False]
    scores = rng.normal(size=n) + labels
    if ties:
        scores = np.round(scores, 1)
    assert roc_auc(labels, scores) == pytest.approx(
        metrics.roc_auc_score(labels, scores), abs=1e-12)


def test_roc_auc_edge_cases():
    assert roc_auc([True, False], [1.0, 0.0]) == 1.0
    assert roc_auc([True, False], [0.0, 1.0]) == 0.0
    assert roc_auc([True, False, True, False], [1.0] * 4) == 0.5
    assert np.isnan(roc_auc([True, True], [0.1, 0.2]))
