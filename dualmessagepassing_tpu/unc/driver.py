"""UNC training driver: batch loop, loss-increase early stop, embedding
export with coverage-weighted moving average.

Reference: /root/reference/UnsupervisedNodeClassification/Model/DMPNN/src/
main.py:48-218.  The jitted train step operates on a fixed (v_max, e_max,
s_max) envelope; host-side sampling (unc/data.py) feeds it.  Adam +
cosine-annealing LR (eta_min 3e-6), clip 1.0 (main.py:110-113,166).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .data import (
    WholeGraph,
    add_pair_keys,
    compute_edgenorm,
    convert_subgraph_nids,
    edge_dropout,
    negative_sampling,
    pad_subgraph,
    sample_subgraph_by_neighbors,
    sample_subgraph_by_randomwalks,
)
from .model import UNCTrainModel, init_unc_variables


def make_unc_optimizer(lr: float, total_steps: int, grad_norm: float = 1.0):
    sched = optax.cosine_decay_schedule(lr, max(total_steps, 1), alpha=3e-6 / lr)
    return optax.chain(
        optax.clip_by_global_norm(grad_norm),
        optax.scale_by_adam(),
        optax.scale_by_schedule(lambda s: -sched(s)),
    )


def make_unc_train_step(model: UNCTrainModel, tx,
                        amp: bool = False) -> Callable:
    """amp=True: bf16 backbone forward/backward with f32 master params
    and f32 loss (unc.model.apply_unc_forward)."""
    from .model import apply_unc_forward

    @jax.jit
    def step(params, opt_state, batch_stats, sub, dropout_rng):
        def loss_fn(p):
            (out, pred), new_stats = apply_unc_forward(
                model, p, batch_stats, sub, dropout_rng, amp=amp)
            loss = model.apply(
                {"params": p}, out, sub["edge_type"], sub["edge_mask"],
                sub["samples"], sub["labels"], sub["sample_mask"],
                sub["node_mask"],
                method=UNCTrainModel.unsupervised_loss)
            return loss, new_stats

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, (new_stats if batch_stats else batch_stats), loss

    return step


def make_unc_embed_step(model: UNCTrainModel) -> Callable:
    @jax.jit
    def embed(variables, sub):
        (out, _pred) = model.apply(variables, sub, train=False)
        return out[0]

    return embed


def sample_batch(graph: WholeGraph, edges: np.ndarray, sampler: str,
                 depth: int, width: int, split_size: float,
                 negative_rate: int, v_max: int, e_max: int, s_max: int,
                 rng, send_keys: bool = True) -> Dict[str, np.ndarray]:
    """generate_sampled_graph_and_labels_unsupervised + padding
    (utils.py:399-434)."""
    neg = negative_sampling(edges, graph.num_nodes, negative_rate, rng)
    seeds = np.unique(np.concatenate(
        [edges[:, 0], edges[:, 2], neg[:, 0], neg[:, 2]]))
    if sampler == "neighbor":
        sub = sample_subgraph_by_neighbors(graph, seeds, depth, width, rng)
    else:
        sub = sample_subgraph_by_randomwalks(graph, seeds, depth, width, rng)
    samples = np.concatenate([edges, neg])
    samples = samples.copy()
    samples[:, 0] = convert_subgraph_nids(samples[:, 0], sub["nid"])
    samples[:, 2] = convert_subgraph_nids(samples[:, 2], sub["nid"])
    sub = edge_dropout(sub, split_size, rng)
    labels = np.zeros(len(samples), np.float32)
    labels[: len(edges)] = 1.0
    norm = compute_edgenorm(sub)
    return pad_subgraph(sub, samples, labels, v_max, e_max, s_max,
                        edge_norm=norm, send_keys=send_keys)


def make_unc_supervised_step(model: UNCTrainModel, tx, multi: bool,
                             amp: bool = False) -> Callable:
    from .model import apply_unc_forward

    @jax.jit
    def step(params, opt_state, batch_stats, sub, matched_labels,
             matched_index, matched_mask, dropout_rng):
        def loss_fn(p):
            (out, pred), new_stats = apply_unc_forward(
                model, p, batch_stats, sub, dropout_rng, amp=amp)
            loss = model.apply(
                {"params": p}, out, sub["edge_type"], sub["edge_mask"], pred,
                matched_labels, matched_index, matched_mask, multi,
                method=UNCTrainModel.supervised_loss)
            return loss, new_stats

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, (new_stats if batch_stats else batch_stats), loss

    return step


def train_unc_supervised(
    triplets: np.ndarray,
    num_nodes: int,
    num_rels: int,
    train_indices,        # labeled node -> incident edge indices
    train_labels,         # labeled node -> label (or label array if multi)
    nlabel: int,
    multi: bool = False,
    *,
    h_dim: int = 50,
    n_layers: int = 1,
    lr: float = 1e-2,
    reg_param: float = 1e-2,
    dropout: float = 0.2,
    graph_batch_size: int = 10000,
    label_batch_size: int = 512,
    graph_split_size: float = 0.5,
    sampler: str = "randomwalk",
    sample_depth: int = 3,
    sample_width: int = 10,
    n_epochs: int = 10,
    grad_norm: float = 1.0,
    backbone: str = "DMPNN",
    node_attri: Optional[np.ndarray] = None,
    v_max: Optional[int] = None,
    e_max: Optional[int] = None,
    seed: int = 0,
    prefetch: int = 2,
    amp: bool = False,
    log: Callable[[str], None] = print,
):
    """Semi-supervised UNC training (main.py supervised branch +
    generate_sampled_graph_and_labels_supervised, utils.py:352-396).
    Returns (node_embeddings, coverage)."""
    from .data import labeled_edges_sampling, match_labels_to_subgraph

    rng = np.random.default_rng(seed)
    graph = WholeGraph(num_nodes, num_rels, triplets)
    ntrain = len(train_indices)
    if v_max is None:
        v_max = num_nodes
    if e_max is None:
        e_max = min(v_max * sample_width, graph.num_edges)

    model = UNCTrainModel(
        num_nodes=num_nodes, num_rels=num_rels, h_dim=h_dim,
        nlabel=nlabel, num_hidden_layers=n_layers, dropout=dropout,
        reg_param=reg_param, node_attri=node_attri, backbone=backbone,
        multi=multi, sorted_edges=True)

    def make_batch(edges, brng=None):
        brng = rng if brng is None else brng
        labeled_edges, sampled_nodes = labeled_edges_sampling(
            train_indices, ntrain, True, label_batch_size, rng=brng)
        labeled_samples = (triplets[labeled_edges] if len(labeled_edges)
                           else np.zeros((0, 3), np.int64))
        seeds = np.unique(np.concatenate(
            [edges[:, 0], edges[:, 2],
             labeled_samples[:, 0], labeled_samples[:, 2]]))
        if sampler == "neighbor":
            sub = sample_subgraph_by_neighbors(graph, seeds, sample_depth,
                                               sample_width, brng)
        else:
            sub = sample_subgraph_by_randomwalks(graph, seeds, sample_depth,
                                                 sample_width, brng)
        labels, index = match_labels_to_subgraph(
            sub["nid"], sampled_nodes, train_labels, nlabel, multi)
        sub = edge_dropout(sub, graph_split_size, brng)
        norm = compute_edgenorm(sub)
        padded = pad_subgraph(sub, np.zeros((0, 3), np.int64),
                              np.zeros(0, np.float32), v_max, e_max, 1,
                              edge_norm=norm)
        # pad matched arrays to the label envelope
        lmax = label_batch_size
        n_m = min(len(index), lmax)
        mi = np.zeros(lmax, np.int64)
        mi[:n_m] = index[:n_m]
        mm = np.arange(lmax) < n_m
        if multi:
            ml = np.zeros((lmax, nlabel), np.float32)
            if n_m:
                ml[:n_m] = labels[:n_m]
        else:
            ml = np.zeros(lmax, np.int64)
            if n_m:
                ml[:n_m] = labels[:n_m]
        return padded, ml, mi, mm

    first, ml, mi, mm = make_batch(triplets[: graph_batch_size])
    first_dev = {k: jnp.asarray(v) for k, v in first.items()}
    log("initializing parameters (jit)...")
    variables = init_unc_variables(model, jax.random.PRNGKey(seed), first_dev)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    n_batches = math.ceil(len(triplets) / graph_batch_size)
    tx = make_unc_optimizer(lr, n_epochs * n_batches, grad_norm)
    opt_state = tx.init(params)
    step = make_unc_supervised_step(model, tx, multi, amp=amp)
    # compile before the sampler threads start (as train_unc does)
    log("compiling train step (AOT)...")
    step.lower(params, opt_state, batch_stats, first_dev, jnp.asarray(ml),
               jnp.asarray(mi), jnp.asarray(mm),
               jax.random.PRNGKey(seed)).compile()
    log("compile done; training...")
    from concurrent.futures import ThreadPoolExecutor

    prev_loss = float("inf")
    k = 0
    # base key built ONCE: an eager PRNGKey() per step costs two ~0.6 ms
    # threefry programs on the device stream (bench.py profile)
    base_key = jax.random.PRNGKey(seed)
    with ThreadPoolExecutor(max_workers=max(prefetch, 1)) as tpool:
        for epoch in range(n_epochs):
            losses = []
            order = rng.permutation(len(triplets))
            batch_list = [triplets[order[i: i + graph_batch_size]]
                          for i in range(0, len(order), graph_batch_size)]
            child_rngs = rng.spawn(len(batch_list))
            window = max(2 * prefetch, 1)
            futures = {i: tpool.submit(make_batch, batch_list[i],
                                       child_rngs[i])
                       for i in range(min(window, len(batch_list)))}
            for i in range(len(batch_list)):
                padded, ml, mi, mm = futures.pop(i).result()
                nxt = i + window
                if nxt < len(batch_list):
                    futures[nxt] = tpool.submit(make_batch, batch_list[nxt],
                                                child_rngs[nxt])
                sub = {kk: jnp.asarray(v) for kk, v in padded.items()}
                params, opt_state, batch_stats, loss = step(
                    params, opt_state, batch_stats, sub, jnp.asarray(ml),
                    jnp.asarray(mi), jnp.asarray(mm),
                    jax.random.fold_in(base_key, k))
                k += 1
                losses.append(float(loss))
            loss = sum(losses) / max(len(losses), 1)
            log(f"Epoch {epoch:05d} | Loss {loss:.4f}")
            if loss > prev_loss:
                break
            prev_loss = loss
    return {"params": params, "batch_stats": batch_stats}, model


def train_unc(
    triplets: np.ndarray,
    num_nodes: int,
    num_rels: int,
    *,
    h_dim: int = 50,
    n_layers: int = 1,
    lr: float = 1e-2,
    reg_param: float = 1e-2,
    negative_rate: int = 5,
    dropout: float = 0.2,
    graph_batch_size: int = 10000,
    graph_split_size: float = 0.5,
    sampler: str = "randomwalk",
    sample_depth: int = 3,
    sample_width: int = 10,
    n_epochs: int = 50,
    grad_norm: float = 1.0,
    backbone: str = "DMPNN",
    seed_nodes: Optional[set] = None,
    node_attri: Optional[np.ndarray] = None,
    v_max: Optional[int] = None,
    e_max: Optional[int] = None,
    seed: int = 0,
    prefetch: int = 2,
    ep_devices: Optional[int] = None,
    ep_mode: str = "psum",
    ep_partition: str = "degree",   # halo node partitioner: degree|range|bfs
    halo_edge_slack: float = 1.5,   # per-shard edge envelope headroom
    halo_boundary: Optional[int] = None,  # boundary rows/shard (default Vp)
    checkpoint_dir: Optional[str] = None,  # per-epoch full-state save/resume
    amp: bool = False,
    # single-device endpoint-gather layout (exact-equivalence tested):
    endpoint_gather: str = "split",  # "fused": ONE gather over the [2E]
                                     # endpoint stream (one cotangent
                                     # scatter per layer instead of two)
    log: Callable[[str], None] = print,
):
    """Full UNC pipeline -> (node_embeddings [N, h], coverage fraction).

    Mirrors main.py:48-218 including the loss-increase early stop and the
    coverage-weighted moving-average embedding export:
        emb[nid] = emb[nid] * (1 - c) + h * c,
        c = (subdeg + 1) / (deg + 1)             (main.py:196-209)

    `ep_devices=N` runs the REAL model edge-partitioned over the first N
    devices. Two shardings (both numerically equivalent to single-device,
    tests/test_ep_unc.py / tests/test_halo_unc.py):
      * ep_mode="psum" (parallel/ep_unc.py): edge/dual-node state sharded
        over an 'ep' mesh axis, node state replicated, per-layer [V, H]
        psum aggregation — right when V << E per shard;
      * ep_mode="halo" (parallel/halo_unc.py): node state owner-sharded,
        edges placed at their receiver's owner (local aggregation), one
        boundary all_to_all per layer — scales node state and traffic.
    """
    rng = np.random.default_rng(seed)
    graph = WholeGraph(num_nodes, num_rels, triplets)

    if seed_nodes:
        pool = np.asarray([
            i for i, t in enumerate(triplets)
            if int(t[0]) in seed_nodes or int(t[2]) in seed_nodes])
        train_edges = triplets[pool]
    else:
        train_edges = triplets
        n_batches = math.ceil(len(train_edges) / graph_batch_size)
        n_epochs = math.ceil(
            n_epochs * n_batches * graph_batch_size / num_nodes)

    # static envelope: seeds <= batch*(2 + 2*neg) capped at N; edges <= V*width
    if v_max is None:
        v_max = num_nodes
    if e_max is None:
        e_max = min(v_max * sample_width, graph.num_edges)
    s_max = graph_batch_size * (1 + negative_rate)

    ep_mesh = None
    halo = False
    if ep_devices:
        from jax.sharding import Mesh

        from ..parallel.ep_unc import (make_ep_apply, make_ep_train_step,
                                       pad_e_max, shard_sub)

        e_max = pad_e_max(e_max, ep_devices)
        ep_mesh = Mesh(np.asarray(jax.devices()[:ep_devices]), ("ep",))
        halo = ep_mode == "halo"
        if halo:
            from ..parallel.halo_unc import (build_halo_sub, halo_envelope,
                                             make_halo_apply,
                                             make_halo_train_step,
                                             shard_halo_sub,
                                             unshard_halo_nodes)

            vp_env, ep_env, b_env = halo_envelope(
                v_max, e_max, ep_devices, edge_slack=halo_edge_slack,
                boundary=halo_boundary)

    # pad_subgraph sorts edges by receiver -> the sorted-scatter hint is
    # always valid here; the halo builder preserves per-shard
    # receiver-sortedness.
    mkw = dict(
        num_nodes=num_nodes, num_rels=num_rels, h_dim=h_dim,
        nlabel=0, num_hidden_layers=n_layers, dropout=dropout,
        reg_param=reg_param, node_attri=node_attri, backbone=backbone,
        sorted_edges=True)
    if ep_devices and endpoint_gather == "fused":
        raise ValueError(
            "endpoint_gather='fused' is a single-device cotangent lever "
            "(the sharded paths carry no global pair-sort keys); drop it "
            "or drop ep_devices")
    model = UNCTrainModel(ep_axis="ep" if ep_mesh is not None else None,
                          node_sharding="owner" if halo else "replicated",
                          **mkw)
    # init outside shard_map: an ep_axis-free twin has identical params
    init_model = UNCTrainModel(**mkw) if ep_mesh is not None else model

    def host_prepare(padded):
        """Numpy-only batch finishing (halo partitioning, pair keys) —
        runs INSIDE the sampler threads so it stays off the device
        critical path."""
        if halo:
            dev, _meta = build_halo_sub(padded, ep_devices, vp_env, ep_env,
                                        b_env, method=ep_partition)
            return dev
        if endpoint_gather == "fused":
            padded = add_pair_keys(padded)
        return padded

    def to_device(prepared):
        if halo:
            return shard_halo_sub(ep_mesh, prepared)
        if ep_mesh is not None:
            return shard_sub(ep_mesh, prepared)
        return {k: jnp.asarray(v) for k, v in prepared.items()}

    n_batches = math.ceil(len(train_edges) / graph_batch_size)
    total_steps = n_epochs * n_batches
    tx = make_unc_optimizer(lr, total_steps, grad_norm)

    def batches(edges, bsz, shuffle):
        order = rng.permutation(len(edges)) if shuffle else np.arange(len(edges))
        for i in range(0, len(order), bsz):
            yield edges[order[i: i + bsz]]

    # init
    # sender-sort keys feed the single-device cotangent fast path only
    # (unc.model guards on ep_axis is None) — skip the per-batch host
    # argsort + two dead e_max arrays under sharding / forward-only
    send_keys = ep_devices is None
    first = sample_batch(graph, train_edges[: graph_batch_size], sampler,
                         sample_depth, sample_width, graph_split_size,
                         negative_rate, v_max, e_max, s_max, rng,
                         send_keys=send_keys)
    first_dev = {k: jnp.asarray(v) for k, v in first.items()}
    log("initializing parameters (jit)...")
    variables = init_unc_variables(init_model, jax.random.PRNGKey(seed),
                                   first_dev)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    opt_state = tx.init(params)
    if halo:
        step = make_halo_train_step(model, tx, ep_mesh, amp=amp)
    elif ep_mesh is not None:
        step = make_ep_train_step(model, tx, ep_mesh, amp=amp)
    else:
        step = make_unc_train_step(model, tx, amp=amp)
    # compile before the sampler threads start, so compile time is
    # reported apart from the first step
    log("compiling train step (AOT)...")
    step.lower(params, opt_state, batch_stats,
               to_device(host_prepare(first)),
               jax.random.PRNGKey(seed)).compile()
    log("compile done; training...")

    prev_loss = float("inf")
    k_step = 0
    start_epoch = 0
    # Full-state checkpoint per epoch (beyond the reference, which never
    # checkpoints UNC training — SURVEY §5.3/§5.4): params + optimizer
    # state + BN stats + loop clocks, in checkpoint_dir/latest.npz.
    # Resume restores everything except the numpy sampling RNG (sampling
    # is stochastic per epoch by design).
    ckpt_path = None
    if checkpoint_dir:
        import os as _os

        from ..train.checkpoint import (checkpoint_exists, restore_params,
                                        save_params)

        ckpt_path = _os.path.join(_os.path.abspath(checkpoint_dir),
                                  "latest")
        if checkpoint_exists(ckpt_path):
            saved = restore_params(ckpt_path, like={
                "params": params, "opt_state": opt_state,
                "batch_stats": batch_stats, "epoch": 0, "k_step": 0,
                "prev_loss": 0.0})
            params = jax.tree_util.tree_map(jnp.asarray, saved["params"])
            opt_state = jax.tree_util.tree_map(jnp.asarray,
                                               saved["opt_state"])
            batch_stats = jax.tree_util.tree_map(jnp.asarray,
                                                 saved["batch_stats"])
            start_epoch = int(saved["epoch"]) + 1
            k_step = int(saved["k_step"])
            prev_loss = float(saved["prev_loss"])
            log(f"resumed from {ckpt_path} at epoch {start_epoch}")
    # Host-side sampling is the long pole at large scale (Yelp: 1.7-2.4 s
    # per batch vs ~0.5 s device step). Two sampler threads run ahead of
    # the device (the native random-walk kernel releases the GIL through
    # ctypes), so epoch wall-clock approaches n_batches * sample/2 instead
    # of n_batches * sample. Each batch gets its own spawned Generator —
    # the shared Generator is not thread-safe.
    from concurrent.futures import ThreadPoolExecutor

    base_key = jax.random.PRNGKey(seed)  # once; see train_unc note
    with ThreadPoolExecutor(max_workers=max(prefetch, 1)) as pool:
        for epoch in range(start_epoch, n_epochs):
            batch_list = list(batches(train_edges, graph_batch_size,
                                      shuffle=True))
            child_rngs = rng.spawn(len(batch_list))

            def sample_and_prepare(edges_i, brng):
                return host_prepare(sample_batch(
                    graph, edges_i, sampler, sample_depth, sample_width,
                    graph_split_size, negative_rate, v_max, e_max, s_max,
                    brng, send_keys=send_keys))

            def submit(i):
                return pool.submit(sample_and_prepare, batch_list[i],
                                   child_rngs[i])

            # sliding window caps sampled-but-unconsumed batches in memory
            window = max(2 * prefetch, 1)
            futures = {i: submit(i)
                       for i in range(min(window, len(batch_list)))}
            pending = []
            for i in range(len(batch_list)):
                sub = futures.pop(i).result()
                nxt = i + window
                if nxt < len(batch_list):
                    futures[nxt] = submit(nxt)
                sub = to_device(sub)
                step_key = jax.random.fold_in(base_key, k_step)
                k_step += 1
                params, opt_state, batch_stats, loss = step(
                    params, opt_state, batch_stats, sub, step_key)
                # the loss is read every step (a host sync); the sampler
                # threads carry the sampling/compute overlap
                pending.append(float(loss))
            loss = sum(pending) / max(len(pending), 1)
            log(f"Epoch {epoch:05d} | Loss {loss:.4f}")
            if ckpt_path:
                save_params(ckpt_path, {
                    "params": jax.device_get(params),
                    "opt_state": jax.device_get(opt_state),
                    "batch_stats": jax.device_get(batch_stats),
                    "epoch": epoch, "k_step": k_step,
                    "prev_loss": float(min(loss, prev_loss))})
            if loss > prev_loss:
                break
            prev_loss = loss

    # final inference pass with moving-average export (main.py:184-209)
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    if halo:
        halo_fwd = make_halo_apply(model, ep_mesh)

        def embed_step(vs, padded):
            dev, meta = build_halo_sub(padded, ep_devices, vp_env, ep_env,
                                       b_env, method=ep_partition)
            out, _ = halo_fwd(vs, shard_halo_sub(ep_mesh, dev))
            return unshard_halo_nodes(meta, out[0])
    elif ep_mesh is not None:
        ep_fwd = make_ep_apply(model, ep_mesh)

        def embed_step(vs, padded):
            return ep_fwd(vs, shard_sub(ep_mesh, padded))[0][0]
    else:
        _embed = make_unc_embed_step(model)

        def embed_step(vs, padded):
            return _embed(vs, {k: jnp.asarray(v) for k, v in padded.items()})
    if node_attri is not None:
        node_emb = np.asarray(node_attri, np.float32).copy()
        if node_emb.shape[1] != h_dim:
            node_emb = np.zeros((num_nodes, h_dim), np.float32)
    else:
        node_emb = np.asarray(params["model"]["node_emb"], np.float32).copy()
    sampled = set()
    for edges in batches(triplets, graph_batch_size * 4, shuffle=False):
        subp = sample_batch(graph, edges, sampler, sample_depth, sample_width,
                            graph_split_size, negative_rate, v_max, e_max,
                            graph_batch_size * 4 * (1 + negative_rate), rng,
                            send_keys=False)   # forward-only export
        h = np.asarray(embed_step(variables, subp))
        nm = subp["node_mask"]
        nid = subp["nid"][nm]
        sub_in_deg = np.bincount(subp["receivers"][subp["edge_mask"]],
                                 minlength=len(subp["nid"]))[nm]
        coef = (sub_in_deg + 1.0) / (graph.in_deg[nid] + 1.0)
        node_emb[nid] = (node_emb[nid] * (1 - coef[:, None])
                         + h[nm] * coef[:, None])
        sampled.update(int(x) for x in nid)
    coverage = len(sampled) / num_nodes
    log(f"{coverage * 100:.1f}% node embeddings are saved.")
    return node_emb, coverage
