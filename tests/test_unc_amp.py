"""UNC bf16 mixed precision (unc.model.apply_unc_forward + amp plumbing).

Pins: the f32 default path is unchanged; the amp backbone forward is bf16
end to end (node/edge streams); gradients of the FULL unsupervised loss
align with f32; the numerically-sensitive pieces stay f32 (BatchNorm
statistics, scatter accumulators, r_bar counts); and train_unc(amp=True)
completes end to end (single-device and ep-sharded).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dualmessagepassing_tpu.unc.model import (
    UNCTrainModel, apply_unc_forward, init_unc_variables)
from dualmessagepassing_tpu.utils.amp import compute_dtype_scope

from test_ep_unc import make_padded_sub


def _setup(rng, backbone="DMPNN"):
    sub = make_padded_sub(rng)
    sub_dev = {k: jnp.asarray(v) for k, v in sub.items()}
    kw = dict(num_nodes=40, num_rels=3, h_dim=16, nlabel=0,
              num_hidden_layers=2, dropout=0.0, reg_param=0.01,
              backbone=backbone, sorted_edges=True)
    model = UNCTrainModel(**kw)
    variables = init_unc_variables(model, jax.random.PRNGKey(0), sub_dev)
    return model, sub_dev, variables


@pytest.mark.parametrize("backbone", ["DMPNN", "CompGCN", "RGCN", "RGIN"])
def test_unc_amp_forward_bf16_end_to_end(rng, backbone):
    model, sub_dev, variables = _setup(rng, backbone)
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    (out32, _), _ = apply_unc_forward(model, params, stats, sub_dev,
                                      jax.random.PRNGKey(1), amp=False,
                                      train=False)
    # peek INSIDE the amp scope: the backbone streams must be bf16 (the
    # public helper casts them back to f32 for the loss)
    from dualmessagepassing_tpu.utils.amp import cast_floats

    with compute_dtype_scope(jnp.bfloat16):
        fwd_vars = {"params": cast_floats(params, jnp.bfloat16)}
        if stats:
            fwd_vars["batch_stats"] = stats
        (raw, _), _ = model.apply(fwd_vars, sub_dev, train=False,
                                  mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(1)})
    assert raw[0].dtype == jnp.bfloat16, backbone
    if len(raw) > 1:
        assert raw[1].dtype == jnp.bfloat16, backbone

    (out16, _), _ = apply_unc_forward(model, params, stats, sub_dev,
                                      jax.random.PRNGKey(1), amp=True,
                                      train=False)
    assert out16[0].dtype == jnp.float32   # cast back for the loss
    a = np.asarray(out32[0], np.float32)
    b = np.asarray(out16[0], np.float32)
    denom = max(np.abs(a).max(), 1e-6)
    assert np.abs(a - b).max() / denom < 0.06, backbone


def test_unc_amp_gradients_align(rng):
    model, sub_dev, variables = _setup(rng)
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def loss(p, amp):
        (out, _), _ = apply_unc_forward(model, p, stats, sub_dev,
                                        jax.random.PRNGKey(1), amp=amp)
        return model.apply(
            {"params": p}, out, sub_dev["edge_type"], sub_dev["edge_mask"],
            sub_dev["samples"], sub_dev["labels"], sub_dev["sample_mask"],
            sub_dev["node_mask"], method=UNCTrainModel.unsupervised_loss)

    g32 = jax.grad(lambda p: loss(p, False))(params)
    g16 = jax.grad(lambda p: loss(p, True))(params)
    for a, b in zip(jax.tree.leaves(g32), jax.tree.leaves(g16)):
        assert b.dtype == jnp.float32          # master grads
        a = np.asarray(a, np.float64).ravel()
        b = np.asarray(b, np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        # skip numerically-zero f32 gradients (e.g. the fc0 bias ahead of
        # BatchNorm — BN subtracts the mean, so its true grad is 0 and
        # both sides are rounding noise)
        if na > 1e-6 and nb > 1e-6:
            assert a @ b / (na * nb) > 0.98


def test_unc_amp_batch_stats_stay_f32(rng):
    model, sub_dev, variables = _setup(rng)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    assert stats, "DMPNN update MLPs carry BatchNorm"
    (_, _), new_stats = apply_unc_forward(model, params, stats, sub_dev,
                                          jax.random.PRNGKey(1), amp=True,
                                          train=True)
    for leaf in jax.tree.leaves(new_stats):
        assert leaf.dtype == jnp.float32


def test_train_unc_amp_end_to_end(rng):
    from dualmessagepassing_tpu.unc.driver import train_unc

    src = rng.integers(0, 25, 120)
    dst = (src + rng.integers(1, 25, 120)) % 25
    rel = rng.integers(0, 2, 120)
    t = np.stack([src, rel, dst], axis=1).astype(np.int64)
    embs, coverage = train_unc(
        t, 25, 2, h_dim=8, n_layers=1, lr=1e-2, reg_param=0.01,
        negative_rate=2, graph_batch_size=40, graph_split_size=0.9,
        sampler="randomwalk", sample_depth=2, sample_width=5,
        n_epochs=2, v_max=25, e_max=125, seed=0, amp=True,
        log=lambda s: None)
    assert embs.shape == (25, 8)
    assert coverage > 0.9
    assert np.isfinite(embs).all()


def test_train_unc_amp_halo_end_to_end(rng):
    """amp composes with the owner-sharded halo path (bf16 all_to_all +
    halo table, f32 loss) on the 8-way virtual mesh."""
    from dualmessagepassing_tpu.unc.driver import train_unc

    src = rng.integers(0, 25, 120)
    dst = (src + rng.integers(1, 25, 120)) % 25
    rel = rng.integers(0, 2, 120)
    t = np.stack([src, rel, dst], axis=1).astype(np.int64)
    embs, coverage = train_unc(
        t, 25, 2, h_dim=8, n_layers=1, lr=1e-2, reg_param=0.01,
        negative_rate=2, graph_batch_size=40, graph_split_size=0.9,
        sampler="randomwalk", sample_depth=2, sample_width=5,
        n_epochs=2, v_max=25, e_max=125, seed=0, ep_devices=8,
        ep_mode="halo", amp=True, log=lambda s: None)
    assert embs.shape == (25, 8)
    assert coverage > 0.9
    assert np.isfinite(embs).all()


def test_train_unc_amp_ep_end_to_end(rng):
    """bf16 compute composes with the edge-partitioned shard_map in one
    driver run."""
    from dualmessagepassing_tpu.unc.driver import train_unc

    src = rng.integers(0, 25, 120)
    dst = (src + rng.integers(1, 25, 120)) % 25
    rel = rng.integers(0, 2, 120)
    t = np.stack([src, rel, dst], axis=1).astype(np.int64)
    embs, coverage = train_unc(
        t, 25, 2, h_dim=8, n_layers=1, lr=1e-2, reg_param=0.01,
        negative_rate=2, graph_batch_size=40, graph_split_size=0.9,
        sampler="randomwalk", sample_depth=2, sample_width=5,
        n_epochs=2, v_max=25, e_max=125, seed=0, ep_devices=8,
        amp=True, log=lambda s: None)
    assert embs.shape == (25, 8)
    assert coverage > 0.9
    assert np.isfinite(embs).all()


def test_train_unc_h64_amp_end_to_end(rng):
    """h_dim >= 64 makes the [V, 2H+1] endpoint table wider than 128
    columns; the amp pipeline runs end to end at that width."""
    from dualmessagepassing_tpu.unc.driver import train_unc

    src = rng.integers(0, 30, 150)
    dst = (src + rng.integers(1, 30, 150)) % 30
    rel = rng.integers(0, 2, 150)
    t = np.stack([src, rel, dst], axis=1).astype(np.int64)
    embs, coverage = train_unc(
        t, 30, 2, h_dim=64, n_layers=1, lr=1e-2, reg_param=0.01,
        negative_rate=2, graph_batch_size=50, graph_split_size=0.9,
        sampler="randomwalk", sample_depth=2, sample_width=5,
        n_epochs=1, v_max=30, e_max=150, seed=0, amp=True,
        log=lambda s: None)
    assert embs.shape == (30, 64)
    assert np.isfinite(embs).all()
