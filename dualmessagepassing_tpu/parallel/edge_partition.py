"""Edge-partitioned message passing for single large graphs.

This is the north-star scale-out mode (SURVEY §2.4, §5.7-5.8): the
reference's only answer to graphs beyond a step budget is subgraph
*sampling* (UNC utils.py:279-434); here the graph itself is sharded.

Design (the graph analog of sequence parallelism):
  * primal edges — and therefore the dual-node (edge-stream) state, which
    dominates memory at E x H — are sharded across the 'ep' mesh axis;
  * node features are replicated (V << E for the target workloads: Yelp
    30.5M edges over 82K nodes; the 100M-edge config has ~100K nodes);
  * a layer computes local per-edge messages and a local partial
    segment-sum into the full [V, H] slot table, then one psum over 'ep'
    completes the aggregation — the only collective per layer;
  * degree tables are partial-counted and psummed once, then reused.

Under `shard_map` every step is explicit; XLA overlaps the psum with the
independent edge-stream update that follows it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import LEAKY_RELU_A


def pad_to_multiple(edges: Dict[str, np.ndarray], n_shards: int
                    ) -> Dict[str, np.ndarray]:
    """Pad flat edge arrays so E divides n_shards (mask marks real)."""
    e = len(edges["senders"])
    target = -(-e // n_shards) * n_shards
    pad = target - e

    def pad1(x, fill=0):
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                          x.dtype)])

    out = {k: pad1(v) for k, v in edges.items()}
    out["edge_mask"] = np.concatenate(
        [edges.get("edge_mask", np.ones(e, bool)), np.zeros(pad, bool)])
    return out


def make_edge_parallel_dmp_apply(
    mesh: Mesh,
    num_nodes: int,
    num_layers: int = 1,
    activation: str = "tanh_between",
) -> Callable:
    """Edge-partitioned multi-layer dual message passing forward.

    Parameters are a list (one dict per layer) of the DMP weight matrices
    {in,out,src,dst,nloop,eloop}_weight [+ nbias, ebias] (the math of
    DMPLayer, models/dmpnn.py).  Inputs:
      node_feat [V, H] (replicated), edge_feat [E, H] (sharded on 'ep'),
      senders/receivers/rev_flag/edge_mask [E] (sharded on 'ep').
    Returns (node_out [V, H] replicated, edge_out [E, H] sharded).
    """
    def layer(params, node_feat, e_feat, senders, receivers, rev, e_mask,
              out_deg):
        rev = rev[:, None]
        em = e_mask[:, None]
        hw_src = node_feat @ params["src_weight"]
        hw_dst = node_feat @ params["dst_weight"]
        edge_msg = jnp.where(
            rev,
            hw_dst[senders] - hw_src[receivers],
            hw_dst[receivers] - hw_src[senders])
        node_msg = jnp.where(rev, e_feat @ params["out_weight"],
                             -(e_feat @ params["in_weight"]))
        node_msg = jnp.where(em, node_msg, 0.0)
        # local partial aggregation, completed by one psum over 'ep'
        partial = jnp.zeros((num_nodes, node_msg.shape[-1]),
                            node_msg.dtype).at[receivers].add(node_msg)
        agg = jax.lax.psum(partial, "ep")

        n_out = node_feat @ params["nloop_weight"] + agg
        if "nbias" in params:
            n_out = n_out + params["nbias"]
        n_out = jax.nn.leaky_relu(n_out, LEAKY_RELU_A)

        d = jnp.log2(1.0 + out_deg)[receivers][:, None]
        add = 2.0 * (1.0 + d) * (
            e_feat @ (params["src_weight"] - params["dst_weight"]))
        e_out = e_feat @ params["eloop_weight"] + edge_msg + add
        if "ebias" in params:
            e_out = e_out + params["ebias"]
        e_out = jax.nn.leaky_relu(e_out, LEAKY_RELU_A)
        return n_out, e_out

    def forward(layer_params, node_feat, edge_feat, senders, receivers,
                rev_flag, edge_mask):
        # degrees: one psum, reused by every layer
        partial_deg = jnp.zeros((num_nodes,), jnp.float32).at[senders].add(
            edge_mask.astype(jnp.float32))
        out_deg = jax.lax.psum(partial_deg, "ep")
        h, e = node_feat, edge_feat
        for i, params in enumerate(layer_params):
            h, e = layer(params, h, e, senders, receivers, rev_flag,
                         edge_mask, out_deg)
            if activation == "tanh_between" and i < len(layer_params) - 1:
                h, e = jnp.tanh(h), jnp.tanh(e)
        return h, e

    ep = P("ep")
    rep = P()
    return jax.shard_map(
        forward, mesh=mesh,
        in_specs=(rep, rep, ep, ep, ep, ep, ep),
        out_specs=(rep, ep),
        check_vma=False,
    )


def init_edge_parallel_params(key, num_layers: int, hidden: int,
                              neigenv: float = 4.0, eeigenv: float = 4.0):
    """Xavier-uniform + eigenvalue reparam, same as DMPLayer init."""
    from ..utils.init import scaled, xavier_uniform

    params = []
    for i in range(num_layers):
        keys = jax.random.split(jax.random.fold_in(key, i), 6)
        mk_n = scaled(xavier_uniform(1.0), 1.0 / neigenv)
        mk_e = scaled(xavier_uniform(1.0), 1.0 / eeigenv)
        params.append({
            "in_weight": mk_n(keys[0], (hidden, hidden)),
            "out_weight": mk_n(keys[1], (hidden, hidden)),
            "nloop_weight": mk_n(keys[2], (hidden, hidden)),
            "src_weight": mk_e(keys[3], (hidden, hidden)),
            "dst_weight": mk_e(keys[4], (hidden, hidden)),
            "eloop_weight": mk_e(keys[5], (hidden, hidden)),
            "nbias": jnp.zeros((hidden,)),
            "ebias": jnp.zeros((hidden,)),
        })
    return params


def shard_flat_edges(mesh: Mesh, arrays: Dict[str, Any]) -> Dict[str, Any]:
    """device_put edge arrays with 'ep' sharding on axis 0."""
    ep = NamedSharding(mesh, P("ep"))
    return {k: jax.device_put(jnp.asarray(v), ep) for k, v in arrays.items()}


def make_edge_parallel_train_step(
    mesh: Mesh,
    num_nodes: int,
    num_layers: int,
    lr: float = 1e-2,
):
    """Full edge-partitioned DistMult training step.

    Demonstrates the 100M-edge scale-out shape end to end: forward under
    shard_map (edge state sharded over 'ep', one psum per layer), DistMult
    scoring on replicated node outputs, BCE loss, and gradients — shard_map's
    transpose inserts the reverse collectives automatically, so replicated
    parameter grads come out already all-reduced. SGD update for
    demonstration; swap any optax transformation in production.

    Returns jitted (params, node_feat, edge_feat, edge arrays, samples,
    labels) -> (params, loss).
    """
    fwd = make_edge_parallel_dmp_apply(mesh, num_nodes, num_layers)

    def loss_fn(params, node_feat, edge_feat, senders, receivers, rev_flag,
                edge_mask, samples, labels, w_relation):
        h, _e = fwd(params, node_feat, edge_feat, senders, receivers,
                    rev_flag, edge_mask)
        s = h[samples[:, 0]]
        r = w_relation[samples[:, 1]]
        o = h[samples[:, 2]]
        score = jnp.sum(s * r * o, axis=1)
        bce = (jnp.maximum(score, 0) - score * labels
               + jnp.log1p(jnp.exp(-jnp.abs(score))))
        return jnp.mean(bce)

    @jax.jit
    def train_step(params, w_relation, node_feat, edge_feat, senders,
                   receivers, rev_flag, edge_mask, samples, labels):
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 9))(
            params, node_feat, edge_feat, senders, receivers, rev_flag,
            edge_mask, samples, labels, w_relation)
        g_params, g_rel = grads
        params = jax.tree.map(lambda p, g: p - lr * g, params, g_params)
        w_relation = w_relation - lr * g_rel
        return params, w_relation, loss

    return train_step
