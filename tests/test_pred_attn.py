"""Tests for attention predict nets + static-shape init_mem."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualmessagepassing_tpu.models.pred_attn import (
    DIAMNet,
    DotAttention,
    init_mem_static,
    window_selection,
)

from tests.test_scm_model import make_pair_batch, small_config


def oracle_windows(l, mem_len, circular=False):
    """Reference init_mem window logic (pred.py:656-758), python loops."""
    if circular:
        pad = math.ceil((l + 1) / 2) - 1
        virtual = [j % l for j in range(l + pad)]
    else:
        virtual = list(range(l))
    lv = len(virtual)
    wins = []
    if lv <= mem_len:
        for k in range(mem_len):
            j = k - (mem_len - lv)
            wins.append([virtual[j]] if j >= 0 else [])
    else:
        stride = lv // mem_len
        kernel = lv - (mem_len - 1) * stride
        for k in range(mem_len):
            wins.append(virtual[k * stride: k * stride + kernel])
    return wins


@pytest.mark.parametrize("l,mem_len,circular", [
    (10, 4, False), (3, 4, False), (4, 4, False), (16, 4, False),
    (10, 4, True), (3, 4, True), (7, 3, True),
])
def test_window_selection_matches_oracle(l, mem_len, circular):
    L = 20
    sel, mem_mask = window_selection(jnp.asarray([l]), L, mem_len, circular)
    sel = np.asarray(sel)[0]
    mem_mask = np.asarray(mem_mask)[0]
    wins = oracle_windows(l, mem_len, circular)
    for k, win in enumerate(wins):
        want = np.zeros(L)
        for j in win:
            want[j] += 1
        np.testing.assert_array_equal(sel[k], want, err_msg=f"slot {k}")
        assert mem_mask[k] == (len(win) > 0)


def test_init_mem_pooling_values(rng):
    x = rng.normal(size=(2, 10, 4)).astype(np.float32)
    mask = np.ones((2, 10), bool)
    mask[1, 7:] = False  # sample 1 has length 7
    xm = jnp.asarray(x), jnp.asarray(mask)

    mem, mem_mask = init_mem_static(xm[0], xm[1], 4, "mean")
    mem = np.asarray(mem)
    for b, l in ((0, 10), (1, 7)):
        wins = oracle_windows(l, 4)
        for k, win in enumerate(wins):
            want = x[b, win].mean(0) if win else np.zeros(4)
            np.testing.assert_allclose(mem[b, k], want, rtol=1e-5,
                                       atol=1e-6, err_msg=f"b{b} k{k}")

    mem_max, _ = init_mem_static(xm[0], xm[1], 4, "max")
    mem_max = np.asarray(mem_max)
    wins = oracle_windows(7, 4)
    for k, win in enumerate(wins):
        want = x[1, win].max(0)
        np.testing.assert_allclose(mem_max[1, k], want, rtol=1e-5)


def test_dot_attention_masks(rng):
    q = jnp.asarray(rng.normal(size=(2, 3, 8)).astype(np.float32))
    k = jnp.asarray(rng.normal(size=(2, 5, 8)).astype(np.float32))
    km = jnp.asarray(np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool))
    attn = DotAttention(hidden_dim=8, num_heads=2, scale=0.5,
                        score_func="sparsemax", add_gate=True,
                        param_init="identity")
    params = attn.init(jax.random.PRNGKey(0), q, k, k, key_mask=km)
    out = attn.apply(params, q, k, k, key_mask=km)
    assert out.shape == (2, 3, 8)
    # changing a masked key must not change the output
    k2 = k.at[0, 4].set(100.0)
    out2 = attn.apply(params, q, k2, k, key_mask=km)
    np.testing.assert_allclose(np.asarray(out)[0], np.asarray(out2)[0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pred_net,extra", [
    ("SumAttnPredictNet", {}),
    ("MeanMemAttnPredictNet", {"pred_mem_init": "mean"}),
    ("DIAMNet", {"pred_mem_init": "mean"}),
    ("DIAMNet", {"pred_mem_init": "circular_attn"}),
])
def test_model_with_attn_pred_nets(rng, pred_net, extra):
    from dualmessagepassing_tpu import build_model

    pattern, graph = make_pair_batch(rng)
    cfg = small_config(pred_net=pred_net, pred_mem_len=3, **extra)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0), pattern, graph)
    out = model.apply(params, pattern, graph)
    assert out["pred_c"].shape == (2, 1)
    assert out["pred_v"].shape == (2, 8)
    assert np.all(np.isfinite(np.asarray(out["pred_c"])))

    def loss(p):
        o = model.apply(p, pattern, graph)
        return jnp.mean((o["pred_c"] - 1.0) ** 2) + jnp.mean(o["pred_v"] ** 2)

    g = jax.grad(loss)(params)
    assert all(np.all(np.isfinite(np.asarray(x))) for x in jax.tree.leaves(g))


def test_lstm_mem_init(rng):
    """lstm mem_init: final LSTM hidden per window vs explicitly sliced
    windows through the same cell params."""
    from dualmessagepassing_tpu import nn as fnn
    from dualmessagepassing_tpu.models.pred_attn import WindowLSTMMem

    B, L, D, M, F = 2, 10, 4, 3, 6
    x = jnp.asarray(rng.normal(size=(B, L, D)), jnp.float32)
    mask = np.ones((B, L), bool)
    mask[1, 7:] = False
    mod = WindowLSTMMem(F, M)
    variables = mod.init(jax.random.PRNGKey(0), x, jnp.asarray(mask))
    mem, mem_mask = mod.apply(variables, x, jnp.asarray(mask))
    assert mem.shape == (B, M, F)
    assert np.asarray(mem_mask).all()

    # oracle: same cell params applied to each hand-sliced window
    cell_params = variables["params"]["cell"]
    cell = fnn.OptimizedLSTMCell(F)
    for b, l in ((0, 10), (1, 7)):
        wins = oracle_windows(l, M)
        for k, win in enumerate(wins):
            carry = cell.initialize_carry(jax.random.PRNGKey(0), (D,))
            for j in win:
                carry, _ = cell.apply({"params": cell_params}, carry,
                                      np.asarray(x)[b, j])
            want = np.asarray(carry[1])
            np.testing.assert_allclose(np.asarray(mem)[b, k], want,
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"b{b} k{k}")


def test_model_with_lstm_mem(rng):
    from dualmessagepassing_tpu import build_model

    pattern, graph = make_pair_batch(rng)
    for pred_net, init in [("SumMemAttnPredictNet", "lstm"),
                           ("DIAMNet", "circular_lstm")]:
        cfg = small_config(pred_net=pred_net, pred_mem_len=3,
                           pred_mem_init=init)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0), pattern, graph)
        out = model.apply(params, pattern, graph)
        assert np.all(np.isfinite(np.asarray(out["pred_c"])))
