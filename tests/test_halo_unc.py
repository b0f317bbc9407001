"""Owner-sharded halo-exchange execution of the REAL UNC model
(parallel/halo_unc.py + UNCTrainModel(node_sharding="owner")).

Acceptance mirrors tests/test_ep_unc.py: owner-sharded forward ==
single-device UNCTrainModel.apply on the same subgraph, gradients of the
FULL unsupervised loss match leaf-for-leaf, and SGD/Adam train steps track
the single-device trajectory — all on the 8-device virtual CPU mesh.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from dualmessagepassing_tpu.unc.model import UNCTrainModel, init_unc_variables
from dualmessagepassing_tpu.parallel.halo_unc import (
    build_halo_sub,
    halo_envelope,
    halo_sub_specs,
    make_halo_apply,
    make_halo_train_step,
    shard_halo_sub,
    unshard_halo_edges,
    unshard_halo_nodes,
    _shard_map,
    _squeeze_local,
)

from test_ep_unc import make_padded_sub


N_SHARDS = 8


def mesh8():
    return Mesh(np.array(jax.devices()[:8]), axis_names=("ep",))


def build(rng, method="degree", **sub_kw):
    sub = make_padded_sub(rng, **sub_kw)
    v_max = len(sub["nid"])
    e_max = len(sub["senders"])
    vp, ep, b = halo_envelope(v_max, e_max, N_SHARDS)
    dev, meta = build_halo_sub(sub, N_SHARDS, vp, ep, b, method=method)
    return sub, dev, meta


@pytest.mark.parametrize("backbone", ["DMPNN", "CompGCN", "RGCN", "RGIN"])
def test_halo_forward_matches_single_device(rng, backbone):
    sub, dev, meta = build(rng)
    sub_dev = {k: jnp.asarray(v) for k, v in sub.items()}
    kw = dict(num_nodes=40, num_rels=3, h_dim=16, nlabel=0,
              num_hidden_layers=2, dropout=0.0, reg_param=0.01,
              backbone=backbone)
    ref_model = UNCTrainModel(**kw)
    variables = init_unc_variables(ref_model, jax.random.PRNGKey(0), sub_dev)
    ref_out, _ = ref_model.apply(variables, sub_dev, train=False)

    mesh = mesh8()
    halo_model = UNCTrainModel(ep_axis="ep", node_sharding="owner", **kw)
    sharded = shard_halo_sub(mesh, dev)
    with mesh:
        halo_out, _ = make_halo_apply(halo_model, mesh)(variables, sharded)

    e_mask = np.asarray(sub["edge_mask"])
    e_max = len(e_mask)
    # node stream
    h = unshard_halo_nodes(meta, halo_out[0])
    np.testing.assert_allclose(h, np.asarray(ref_out[0]),
                               atol=1e-5, rtol=1e-5)
    # edge stream (where present): compare real edges only
    if len(ref_out) > 1:
        z = unshard_halo_edges(meta, halo_out[1], e_max)
        np.testing.assert_allclose(z[e_mask], np.asarray(ref_out[1])[e_mask],
                                   atol=1e-5, rtol=1e-5)
    # replicated per-relation means
    if len(ref_out) > 2:
        np.testing.assert_allclose(np.asarray(halo_out[2]),
                                   np.asarray(ref_out[2]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method", ["degree", "range"])
def test_halo_forward_partitioners(rng, method):
    sub, dev, meta = build(rng, method=method)
    sub_dev = {k: jnp.asarray(v) for k, v in sub.items()}
    kw = dict(num_nodes=40, num_rels=3, h_dim=16, nlabel=0,
              num_hidden_layers=2, dropout=0.0, reg_param=0.01,
              backbone="DMPNN")
    ref_model = UNCTrainModel(**kw)
    variables = init_unc_variables(ref_model, jax.random.PRNGKey(0), sub_dev)
    ref_out, _ = ref_model.apply(variables, sub_dev, train=False)
    mesh = mesh8()
    halo_model = UNCTrainModel(ep_axis="ep", node_sharding="owner", **kw)
    with mesh:
        halo_out, _ = make_halo_apply(halo_model, mesh)(
            variables, shard_halo_sub(mesh, dev))
    np.testing.assert_allclose(unshard_halo_nodes(meta, halo_out[0]),
                               np.asarray(ref_out[0]), atol=1e-5, rtol=1e-5)


def _setup(rng):
    sub, dev, meta = build(rng)
    sub_dev = {k: jnp.asarray(v) for k, v in sub.items()}
    kw = dict(num_nodes=40, num_rels=3, h_dim=16, nlabel=0,
              num_hidden_layers=2, dropout=0.0, reg_param=0.01,
              backbone="DMPNN")
    ref_model = UNCTrainModel(**kw)
    variables = init_unc_variables(ref_model, jax.random.PRNGKey(0), sub_dev)
    halo_model = UNCTrainModel(ep_axis="ep", node_sharding="owner", **kw)
    return sub, sub_dev, dev, meta, ref_model, halo_model, variables


def test_halo_gradients_match_single_device(rng):
    """grad of the FULL unsupervised loss (DistMult BCE over all_gathered
    node rows + the three regularizers, BatchNorm ON) through the halo
    shard_map equals the single-device gradient leaf-for-leaf."""
    sub, sub_dev, dev, meta, ref_model, halo_model, variables = _setup(rng)
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
    sharded = shard_halo_sub(mesh, dev)

    def halo_loss(p):
        def inner(p, bs, d, rng_):
            s = _squeeze_local(d)
            vs = {"params": p, **({"batch_stats": bs} if bs else {})}
            (out, _), _m = halo_model.apply(
                vs, s, train=True, mutable=["batch_stats"],
                rngs={"dropout": rng_})
            return halo_model.apply(
                vs, out, s["edge_type"], s["edge_mask"], s["samples"],
                s["labels"], s["sample_mask"], s["node_mask"],
                method=UNCTrainModel.unsupervised_loss)

        return _shard_map(inner, mesh,
                          in_specs=(P(), P(), halo_sub_specs(sharded), P()),
                          out_specs=P())(p, stats, sharded,
                                         jax.random.PRNGKey(1))

    with mesh:
        g_halo = jax.grad(halo_loss)(params)
    for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_halo)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_halo_train_step_matches_single_device(rng):
    """SGD params exact over 2 steps; Adam loss trajectory over 3 (same
    rationale as the ep_unc twin test)."""
    from dualmessagepassing_tpu.unc.driver import make_unc_train_step

    sub, sub_dev, dev, meta, ref_model, halo_model, variables = _setup(rng)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    mesh = mesh8()
    sharded = shard_halo_sub(mesh, dev)

    tx = optax.sgd(1e-1)
    opt = tx.init(params)
    ref_step = make_unc_train_step(ref_model, tx)
    halo_step = make_halo_train_step(halo_model, tx, mesh)
    rp, ro, rs = params, opt, stats
    hp, ho, hs = params, opt, stats
    for k in range(2):
        key = jax.random.PRNGKey(100 + k)
        rp, ro, rs, rl = ref_step(rp, ro, rs, sub_dev, key)
        with mesh:
            hp, ho, hs, hl = halo_step(hp, ho, hs, sharded, key)
        np.testing.assert_allclose(float(rl), float(hl), atol=1e-5)
    for pa, pb in zip(jax.tree.leaves(rp), jax.tree.leaves(hp)):
        np.testing.assert_allclose(np.asarray(pa), np.asarray(pb), atol=1e-5)
    for sa, sb in zip(jax.tree.leaves(rs), jax.tree.leaves(hs)):
        np.testing.assert_allclose(np.asarray(sa), np.asarray(sb),
                                   rtol=2e-3, atol=1e-4)

    tx = optax.adam(1e-2)
    opt = tx.init(params)
    ref_step = make_unc_train_step(ref_model, tx)
    halo_step = make_halo_train_step(halo_model, tx, mesh)
    rp, ro, rs = params, opt, stats
    hp, ho, hs = params, opt, stats
    for k in range(3):
        key = jax.random.PRNGKey(200 + k)
        rp, ro, rs, rl = ref_step(rp, ro, rs, sub_dev, key)
        with mesh:
            hp, ho, hs, hl = halo_step(hp, ho, hs, sharded, key)
        np.testing.assert_allclose(float(rl), float(hl), atol=1e-4)


def test_train_unc_halo_end_to_end(rng):
    """train_unc(ep_devices=8, ep_mode='halo') runs the full pipeline
    (sampling, halo partitioning, AOT precompile, train loop, export)
    owner-sharded on the 8-way virtual mesh."""
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
        ep_mode="halo", log=lambda s: None)
    assert embs.shape == (25, 8)
    assert coverage > 0.9
    assert np.isfinite(embs).all()


def test_build_halo_sub_invariants(rng):
    sub, dev, meta = build(rng)
    v_max = len(sub["nid"])
    vp, b = meta["vp"], meta["b"]
    # every real edge placed exactly once
    placed = np.concatenate(meta["edge_perm"])
    np.testing.assert_array_equal(np.sort(placed),
                                  np.flatnonzero(sub["edge_mask"]))
    # owned slices partition the node rows
    all_rows = meta["owned_slice"][meta["owned_slice"] >= 0]
    np.testing.assert_array_equal(np.sort(all_rows), np.arange(v_max))
    # local receivers are owned rows; local senders address the table
    n = N_SHARDS
    for s in range(n):
        em = dev["edge_mask"][s]
        assert (dev["receivers"][s][em] < vp).all()
        assert (dev["senders"][s][em] <= vp + n * b).all()
        # receiver-sortedness survives partitioning (sorted_edges safety)
        # — including the pad tail (the drivers run sorted_edges=True on
        # the FULL padded stream, so pads must not break monotonicity)
        rcv = dev["receivers"][s][em]
        assert (np.diff(rcv) >= 0).all()
        assert (np.diff(dev["receivers"][s]) >= 0).all()
    # sample remap round-trips through (owner, rank)
    real = sub["sample_mask"]
    orig = np.asarray(sub["samples"])[real]
    pk = dev["samples"][real]
    back_src = meta["owned_slice"][pk[:, 0] // vp, pk[:, 0] % vp]
    np.testing.assert_array_equal(back_src, orig[:, 0])


def test_halo_envelope_overflow_raises(rng):
    sub = make_padded_sub(rng)
    with pytest.raises(ValueError):
        build_halo_sub(sub, N_SHARDS, vp=6, ep=2, b=6)  # ep too small


def test_bfs_partitioner_correct_and_reduces_boundary(rng):
    """On a ring-of-cliques graph the BFS region-growing partitioner must
    (a) produce a correct owner-sharded forward (== single device) and
    (b) export strictly fewer boundary rows than the locality-blind
    degree partitioner."""
    import dualmessagepassing_tpu.unc.data as UD

    # 8 cliques of 6 nodes, one bridge edge between consecutive cliques
    n_cliq, cs = 8, 6
    n = n_cliq * cs
    srcs, dsts = [], []
    for c in range(n_cliq):
        base = c * cs
        for i in range(cs):
            for j in range(cs):
                if i != j:
                    srcs.append(base + i)
                    dsts.append(base + j)
        srcs.append(base)
        dsts.append(((c + 1) % n_cliq) * cs)
    rel = np.zeros(len(srcs), np.int64)
    t = np.stack([np.asarray(srcs), rel, np.asarray(dsts)], 1).astype(np.int64)
    g = UD.WholeGraph(n, 1, t)
    sub = UD.sample_subgraph_by_randomwalks(
        g, np.arange(n), depth=2, width=6, rng=rng)
    samples = t[:4].copy()
    lut = {int(v): i for i, v in enumerate(sub["nid"])}
    samples[:, 0] = [lut.get(int(x), 0) for x in samples[:, 0]]
    samples[:, 2] = [lut.get(int(x), 0) for x in samples[:, 2]]
    labels = np.ones(len(samples), np.float32)
    padded = UD.pad_subgraph(sub, samples, labels, n, len(sub["senders"]) + 8,
                             8, edge_norm=UD.compute_edgenorm(sub))

    vp, ep, b = halo_envelope(n, len(padded["senders"]), N_SHARDS)

    def boundary_rows(method):
        dev, meta = build_halo_sub(padded, N_SHARDS, vp, ep, b,
                                   method=method)
        return dev, meta, int(dev["send_mask"].sum())

    dev_b, meta_b, rows_bfs = boundary_rows("bfs")
    _dev_d, _meta_d, rows_deg = boundary_rows("degree")
    assert rows_bfs < rows_deg, (rows_bfs, rows_deg)

    # correctness of the bfs-partitioned forward
    sub_dev = {k: jnp.asarray(v) for k, v in padded.items()}
    kw = dict(num_nodes=n, num_rels=1, h_dim=8, nlabel=0,
              num_hidden_layers=2, dropout=0.0, reg_param=0.01,
              backbone="DMPNN")
    ref_model = UNCTrainModel(**kw)
    variables = init_unc_variables(ref_model, jax.random.PRNGKey(0), sub_dev)
    ref_out, _ = ref_model.apply(variables, sub_dev, train=False)
    mesh = mesh8()
    halo_model = UNCTrainModel(ep_axis="ep", node_sharding="owner", **kw)
    with mesh:
        halo_out, _ = make_halo_apply(halo_model, mesh)(
            variables, shard_halo_sub(mesh, dev_b))
    np.testing.assert_allclose(unshard_halo_nodes(meta_b, halo_out[0]),
                               np.asarray(ref_out[0]), atol=1e-5, rtol=1e-5)

