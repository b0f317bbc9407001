"""Edge-partitioned execution of the REAL UNC model (parallel/ep_unc.py).

Round-2 VERDICT #2 acceptance: edge-parallel forward == single-device
UNCTrainModel.apply on the same subgraph (1e-5), and a full train step with
Adam + DistMult loss + regularizers matching single-device loss/params.
Runs on the 8-device virtual CPU mesh (conftest).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from dualmessagepassing_tpu.unc.data import (
    WholeGraph,
    compute_edgenorm,
    negative_sampling,
    pad_subgraph,
    sample_subgraph_by_randomwalks,
)
from dualmessagepassing_tpu.unc.model import UNCTrainModel, init_unc_variables
from dualmessagepassing_tpu.parallel.ep_unc import (
    make_ep_apply,
    make_ep_train_step,
    pad_e_max,
    shard_sub,
)


def make_padded_sub(rng, n=40, e=120, r=3, v_max=48, e_max=None, s_max=32):
    src = rng.integers(0, n, e)
    dst = (src + rng.integers(1, n, e)) % n
    rel = rng.integers(0, r, e)
    triplets = np.stack([src, rel, dst], axis=1).astype(np.int64)
    g = WholeGraph(n, r, triplets)
    seeds = np.unique(triplets[:6, [0, 2]].reshape(-1))
    sub = sample_subgraph_by_randomwalks(g, seeds, depth=2, width=6, rng=rng)
    pos = triplets[:4].copy()
    neg = negative_sampling(pos, n, 2, rng)
    samples = np.concatenate([pos, neg])
    # remap to subgraph-local ids where possible (clamp for the test)
    lut = {int(v): i for i, v in enumerate(sub["nid"])}
    samples[:, 0] = [lut.get(int(x), 0) for x in samples[:, 0]]
    samples[:, 2] = [lut.get(int(x), 0) for x in samples[:, 2]]
    labels = np.zeros(len(samples), np.float32)
    labels[: len(pos)] = 1.0
    norm = compute_edgenorm(sub)
    if e_max is None:
        e_max = pad_e_max(len(sub["senders"]), 8)
    return pad_subgraph(sub, samples, labels, v_max, e_max, s_max,
                        edge_norm=norm)


def mesh8():
    return Mesh(np.array(jax.devices()[:8]), axis_names=("ep",))


@pytest.mark.parametrize("backbone", ["DMPNN", "CompGCN", "RGCN", "RGIN"])
def test_ep_forward_matches_single_device(rng, backbone):
    sub = make_padded_sub(rng)
    sub_dev = {k: jnp.asarray(v) for k, v in sub.items()}
    kw = dict(num_nodes=40, num_rels=3, h_dim=16, nlabel=0,
              num_hidden_layers=2, dropout=0.0, reg_param=0.01,
              backbone=backbone)
    ref_model = UNCTrainModel(**kw)
    variables = init_unc_variables(ref_model, jax.random.PRNGKey(0), sub_dev)
    ref_out, _ = ref_model.apply(variables, sub_dev, train=False)

    mesh = mesh8()
    ep_model = UNCTrainModel(ep_axis="ep", **kw)
    sharded = shard_sub(mesh, sub)
    with mesh:
        ep_out, _ = make_ep_apply(ep_model, mesh)(variables, sharded)
    for a, b in zip(ref_out, ep_out):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)


def _setup_models(rng):
    sub = make_padded_sub(rng)
    sub_dev = {k: jnp.asarray(v) for k, v in sub.items()}
    kw = dict(num_nodes=40, num_rels=3, h_dim=16, nlabel=0,
              num_hidden_layers=2, dropout=0.0, reg_param=0.01,
              backbone="DMPNN")
    ref_model = UNCTrainModel(**kw)
    variables = init_unc_variables(ref_model, jax.random.PRNGKey(0), sub_dev)
    ep_model = UNCTrainModel(ep_axis="ep", **kw)
    return sub, sub_dev, ref_model, ep_model, variables


def test_ep_gradients_match_single_device(rng):
    """jax.grad of the FULL unsupervised loss (DistMult BCE + w_rel /
    embedding / edge_fc-alignment regs, BatchNorm ON) through the shard_map
    step equals the single-device gradient leaf-for-leaf."""
    from dualmessagepassing_tpu.parallel.ep_unc import _shard_map, sub_specs
    from jax.sharding import PartitionSpec as P

    sub, sub_dev, ref_model, ep_model, variables = _setup_models(rng)
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def ref_loss(p):
        vs = {"params": p, **({"batch_stats": stats} if stats else {})}
        (out, _), _m = ref_model.apply(
            vs, sub_dev, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)})
        return ref_model.apply(
            vs, out, sub_dev["edge_type"], sub_dev["edge_mask"],
            sub_dev["samples"], sub_dev["labels"], sub_dev["sample_mask"],
            sub_dev["node_mask"], method=UNCTrainModel.unsupervised_loss)

    g_ref = jax.grad(ref_loss)(params)

    mesh = mesh8()
    sharded = shard_sub(mesh, sub)

    def ep_loss(p):
        def inner(p, bs, s, rng_):
            vs = {"params": p, **({"batch_stats": bs} if bs else {})}
            (out, _), _m = ep_model.apply(
                vs, s, train=True, mutable=["batch_stats"],
                rngs={"dropout": rng_})
            return ep_model.apply(
                vs, out, s["edge_type"], s["edge_mask"], s["samples"],
                s["labels"], s["sample_mask"], s["node_mask"],
                method=UNCTrainModel.unsupervised_loss)

        return _shard_map(inner, mesh,
                          in_specs=(P(), P(), sub_specs(sharded), P()),
                          out_specs=P())(p, stats, sharded,
                                         jax.random.PRNGKey(1))

    with mesh:
        g_ep = jax.grad(ep_loss)(params)
    for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_ep)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_ep_train_step_matches_single_device(rng):
    """Full unsupervised train step under edge partitioning.

    SGD params must match single-device exactly (1e-6). Under Adam only the
    loss trajectory is compared: pre-BatchNorm biases have ~zero true
    gradient (BN cancels them), so Adam's m/sqrt(v) normalization amplifies
    1e-7 cross-machine float noise into visibly different (and equally
    meaningless) updates for those leaves."""
    from dualmessagepassing_tpu.unc.driver import make_unc_train_step

    sub, sub_dev, ref_model, ep_model, variables = _setup_models(rng)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    mesh = mesh8()
    sharded = shard_sub(mesh, sub)

    # --- SGD: exact param equivalence over 2 steps -----------------------
    tx = optax.sgd(1e-1)
    opt = tx.init(params)
    ref_step = make_unc_train_step(ref_model, tx)
    ep_step = make_ep_train_step(ep_model, tx, mesh)
    rp, ro, rs = params, opt, stats
    ep_p, ep_o, ep_s = params, opt, stats
    for k in range(2):
        key = jax.random.PRNGKey(100 + k)
        rp, ro, rs, rl = ref_step(rp, ro, rs, sub_dev, key)
        with mesh:
            ep_p, ep_o, ep_s, el = ep_step(ep_p, ep_o, ep_s, sharded, key)
        np.testing.assert_allclose(float(rl), float(el), atol=1e-5)
    for pa, pb in zip(jax.tree.leaves(rp), jax.tree.leaves(ep_p)):
        np.testing.assert_allclose(np.asarray(pa), np.asarray(pb), atol=1e-5)
    # BN running stats agree (psum-completed global statistics). Looser
    # tolerance: 1e-5-level param drift after step 1 feeds step-2
    # activations, so the EMA stats compound to ~1e-4 differences.
    for sa, sb in zip(jax.tree.leaves(rs), jax.tree.leaves(ep_s)):
        np.testing.assert_allclose(np.asarray(sa), np.asarray(sb),
                                   rtol=2e-3, atol=1e-4)

    # --- Adam: loss trajectory agrees over 3 steps -----------------------
    tx = optax.adam(1e-2)
    opt = tx.init(params)
    ref_step = make_unc_train_step(ref_model, tx)
    ep_step = make_ep_train_step(ep_model, tx, mesh)
    rp, ro, rs = params, opt, stats
    ep_p, ep_o, ep_s = params, opt, stats
    for k in range(3):
        key = jax.random.PRNGKey(200 + k)
        rp, ro, rs, rl = ref_step(rp, ro, rs, sub_dev, key)
        with mesh:
            ep_p, ep_o, ep_s, el = ep_step(ep_p, ep_o, ep_s, sharded, key)
        np.testing.assert_allclose(float(rl), float(el), atol=1e-4)


def test_train_unc_ep_devices_end_to_end(rng):
    """train_unc(ep_devices=8) runs the full pipeline (sampling, AOT
    precompile, train loop, coverage-weighted export) edge-partitioned on
    the 8-way virtual mesh. Step-level numerical equivalence is covered by
    the tests above; this guards the driver wiring."""
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
        log=lambda s: None)
    assert embs.shape == (25, 8)
    assert coverage > 0.9
    assert np.isfinite(embs).all()


def test_shard_sub_requires_divisible_envelope(rng):
    sub = make_padded_sub(rng)
    # drop one pad row from every edge array -> e_max no longer divisible
    from dualmessagepassing_tpu.parallel.ep_unc import EDGE_KEYS
    sub = {k: (v[:-1] if k in EDGE_KEYS else v) for k, v in sub.items()}
    with pytest.raises(ValueError):
        shard_sub(mesh8(), sub)

