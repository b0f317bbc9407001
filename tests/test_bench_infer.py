"""Wiring tests for bench.py's inference (serving) workloads.

The numbers only mean something on the GPU (device-trace clock); these
CPU tests pin that the forward-only step builders construct, compile,
and advance — so BENCH_WORKLOAD=scm_infer / unc_infer cannot silently
rot between GPU runs. Reference latency surface being mirrored:
SubgraphCountingMatching/train.py:939-940 (eval forward time/sample)
and UnsupervisedNodeClassification .../main.py:184-209 (embedding
export in eval mode).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_scm_infer_builds_and_advances(monkeypatch):
    monkeypatch.setenv("BENCH_AMP", "1")
    from bench import build_scm_infer

    advance, state0, flops = build_scm_infer(2)
    out = advance(state0)
    pred = np.asarray(out[0])
    assert pred.shape == (2, 1)
    assert np.isfinite(pred).all()
    assert flops > 0 or np.isnan(flops)  # cost_analysis may be absent on CPU


def test_unc_infer_builds_and_advances(monkeypatch):
    monkeypatch.setenv("BENCH_AMP", "1")
    from bench import build_unc_infer

    v, e = 64, 512
    advance, state0, flops = build_unc_infer(v, e)
    emb = np.asarray(advance(state0)[0])
    assert emb.shape == (v, 50)
    assert np.isfinite(emb).all()


def test_unc_infer_is_deterministic(monkeypatch):
    """Eval mode: no dropout, BN running stats — two advances agree."""
    monkeypatch.setenv("BENCH_AMP", "0")
    from bench import build_unc_infer

    advance, state0, _ = build_unc_infer(64, 512)
    a = np.asarray(advance(state0)[0])
    b = np.asarray(advance(state0)[0])
    np.testing.assert_array_equal(a, b)
