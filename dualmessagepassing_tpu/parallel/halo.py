"""Owner-sharded edge partitioning with boundary (halo) exchange.

The full-psum path (parallel/edge_partition.py) replicates node state and
all-reduces the entire [V, H] table once per layer — O(V*H) collective
traffic per device regardless of partition locality. This module is the
scalable variant (SURVEY §2.4 "graph partitioning / halo exchange"):

  * nodes are partitioned into owner-contiguous ranges (degree-balanced
    greedy, or METIS-style locality when the graph has it);
  * every edge lives on the shard that OWNS ITS RECEIVER, so the
    segment-sum aggregation is fully local — no collective at all;
  * the only cross-shard data dependency is sender features owned by
    other shards (the halo). The halo exchange is ONE all_to_all per
    layer of [n_shards, B_max, H] gathered boundary rows — O(B*H)
    traffic, where B is the boundary size the partitioner minimizes.

Crossover vs the full psum: all_to_all sends n*B_max*H floats per device
per layer; a ring all-reduce of the replicated table moves ~2*V*H. The
halo path wins when the per-shard boundary is below ~2V/n — always true
for community-structured graphs, never for uniform power-law wiring
where every shard references every hub (ARCHITECTURE.md §8.2b,
scripts/halo_bench.py).

The layer math is the DMP layer of edge_partition.py (same params);
forward equivalence against the replicated path is pinned by
tests/test_halo.py.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import LEAKY_RELU_A


from .ep_unc import _shard_map  # version-compat shim (one copy)


def assign_owners(senders: np.ndarray, receivers: np.ndarray,
                  num_nodes: int, n_shards: int,
                  method: str = "degree") -> np.ndarray:
    """owner[v] for every node.

    "degree": greedy load balance — nodes in descending in-degree order go
    to the shard with the fewest owned edges (balances the local
    segment-sum work); contiguous runs of the original ids stay together
    only by accident, so boundaries are whatever the wiring gives.
    "range": contiguous equal-node ranges of the ORIGINAL ids — minimizes
    boundaries when the generator wires locally (community graphs).
    """
    if method == "range":
        per = -(-num_nodes // n_shards)
        return (np.arange(num_nodes) // per).astype(np.int32)
    in_deg = np.bincount(receivers, minlength=num_nodes)
    order = np.argsort(-in_deg, kind="stable")
    owner = np.zeros(num_nodes, np.int32)
    load = np.zeros(n_shards, np.int64)
    for v in order:
        s = int(np.argmin(load))
        owner[v] = s
        load[s] += in_deg[v]
    return owner


def build_halo_partition(senders: np.ndarray, receivers: np.ndarray,
                         rev_flag: np.ndarray, num_nodes: int,
                         n_shards: int, method: str = "degree"
                         ) -> Dict[str, Any]:
    """Host-side partition + exchange plan. All arrays carry a leading
    shard axis so they shard over 'ep' with one device_put.

    Returns (n = n_shards, Vp = padded owned nodes/shard, Ep = padded
    edges/shard, B = padded boundary rows per (shard, owner) pair):
      owner, perm              renumbering: new_id = rank within owner
      owned_slice [n, Vp]      original node id of each owned row (pad -1)
      local_senders [n, Ep]    index into the shard's local table
                               (0..Vp-1 owned, Vp + o*B + j halo)
      local_receivers [n, Ep]  index into the owned slice (Vp = dump row)
      edge_mask [n, Ep]
      rev_flag [n, Ep]
      send_idx [n, n, B]       rows of MY owned slice to send to shard t
      send_mask [n, n, B]
      out_deg [n, Vp]          global out-degree of owned nodes
      edge_perm [E]            original edge index of each packed slot
    """
    E = len(senders)
    owner = assign_owners(senders, receivers, num_nodes, n_shards, method)
    # owner-contiguous renumbering
    counts = np.bincount(owner, minlength=n_shards)
    Vp = int(counts.max())
    rank = np.zeros(num_nodes, np.int64)
    for s in range(n_shards):
        idx = np.flatnonzero(owner == s)
        rank[idx] = np.arange(len(idx))
    owned_slice = np.full((n_shards, Vp), -1, np.int64)
    for s in range(n_shards):
        idx = np.flatnonzero(owner == s)
        owned_slice[s, : len(idx)] = idx

    e_shard = owner[receivers]
    e_counts = np.bincount(e_shard, minlength=n_shards)
    Ep = int(e_counts.max()) if E else 1

    # boundary sets: unique senders per (dst shard, src owner)
    need: List[List[np.ndarray]] = []
    B = 1
    for s in range(n_shards):
        es = np.flatnonzero(e_shard == s)
        row = []
        for o in range(n_shards):
            if o == s:
                row.append(np.zeros(0, np.int64))
                continue
            snd = senders[es]
            uniq = np.unique(snd[owner[snd] == o])
            row.append(uniq)
            B = max(B, len(uniq))
        need.append(row)

    send_idx = np.zeros((n_shards, n_shards, B), np.int64)
    send_mask = np.zeros((n_shards, n_shards, B), bool)
    for o in range(n_shards):
        for t in range(n_shards):
            ids = need[t][o]
            send_idx[o, t, : len(ids)] = rank[ids]
            send_mask[o, t, : len(ids)] = True

    # pad senders address the ZERO dump row (Vp + n*B) of the
    # [owned; halo; dump] table — Vp alone is the first HALO row, i.e.
    # another shard's real boundary features leaking into masked edges
    local_senders = np.full((n_shards, Ep), Vp + n_shards * B, np.int64)
    local_receivers = np.full((n_shards, Ep), Vp, np.int64)
    edge_mask = np.zeros((n_shards, Ep), bool)
    rev_out = np.zeros((n_shards, Ep), rev_flag.dtype)
    edge_perm = np.zeros(E, np.int64)
    off = 0
    for s in range(n_shards):
        es = np.flatnonzero(e_shard == s)
        k = len(es)
        snd, rcv = senders[es], receivers[es]
        lr = rank[rcv]
        halo = np.zeros(k, np.int64)
        own_s = owner[snd]
        for o in range(n_shards):
            m = own_s == o
            if not m.any():
                continue
            if o == s:
                halo[m] = rank[snd[m]]
            else:
                pos = np.searchsorted(need[s][o], snd[m])
                halo[m] = Vp + o * B + pos
        local_senders[s, :k] = halo
        local_receivers[s, :k] = lr
        edge_mask[s, :k] = True
        rev_out[s, :k] = rev_flag[es]
        edge_perm[off: off + k] = es
        off += k

    out_deg_global = np.bincount(senders, minlength=num_nodes).astype(
        np.float32)
    out_deg = np.zeros((n_shards, Vp), np.float32)
    for s in range(n_shards):
        idx = owned_slice[s]
        valid = idx >= 0
        out_deg[s, valid] = out_deg_global[idx[valid]]

    return {
        "owner": owner, "rank": rank, "owned_slice": owned_slice,
        "local_senders": local_senders, "local_receivers": local_receivers,
        "edge_mask": edge_mask, "rev_flag": rev_out,
        "send_idx": send_idx, "send_mask": send_mask,
        "out_deg": out_deg, "edge_perm": edge_perm,
        "Vp": Vp, "Ep": Ep, "B": B, "n": n_shards,
    }


def shard_halo_arrays(mesh: Mesh, part: Dict[str, Any],
                      node_feat: np.ndarray, edge_feat: np.ndarray
                      ) -> Dict[str, jnp.ndarray]:
    """device_put plan + features with 'ep' sharding on the shard axis.

    node_feat [V, H] (original ids) is packed into [n, Vp, H] owned
    slices; edge_feat [E, H] into [n, Ep, H] via edge_perm.
    """
    n, Vp, Ep, B = part["n"], part["Vp"], part["Ep"], part["B"]
    H = node_feat.shape[1]
    owned_feat = np.zeros((n, Vp, H), node_feat.dtype)
    for s in range(n):
        idx = part["owned_slice"][s]
        valid = idx >= 0
        owned_feat[s][valid] = node_feat[idx[valid]]
    e_feat = np.zeros((n, Ep, H), edge_feat.dtype)
    packed = edge_feat[part["edge_perm"]]
    off = 0
    for s in range(n):
        k = int(part["edge_mask"][s].sum())
        e_feat[s, :k] = packed[off: off + k]
        off += k
    ep = NamedSharding(mesh, P("ep"))
    out = {
        "owned_feat": owned_feat, "edge_feat": e_feat,
        "local_senders": part["local_senders"],
        "local_receivers": part["local_receivers"],
        "edge_mask": part["edge_mask"], "rev_flag": part["rev_flag"],
        "send_idx": part["send_idx"], "send_mask": part["send_mask"],
        "out_deg": part["out_deg"],
    }
    return {k: jax.device_put(jnp.asarray(v), ep) for k, v in out.items()}


ARG_ORDER = ("owned_feat", "edge_feat", "local_senders", "local_receivers",
             "edge_mask", "rev_flag", "send_idx", "send_mask", "out_deg")


def make_halo_dmp_apply(mesh: Mesh, num_layers: int = 1,
                        activation: str = "tanh_between") -> Callable:
    """Owner-sharded multi-layer DMP forward (same layer math and params
    as make_edge_parallel_dmp_apply; one all_to_all per layer instead of
    one full-[V,H] psum).

    Call positionally with the dict from shard_halo_arrays:
      fwd(layer_params, *[arrays[k] for k in ARG_ORDER])
        -> (owned_out [n, Vp, H] 'ep'-sharded, edge_out [n, Ep, H])
    """

    def forward(layer_params, owned_feat, edge_feat, local_senders,
                local_receivers, edge_mask, rev_flag, send_idx, send_mask,
                out_deg):
        # leading shard axis is size 1 inside shard_map
        owned = owned_feat[0]          # [Vp, H]
        e = edge_feat[0]               # [Ep, H]
        snd = local_senders[0]
        rcv = local_receivers[0]
        em = edge_mask[0][:, None]
        rev = rev_flag[0][:, None]
        sidx = send_idx[0]             # [n, B]
        smask = send_mask[0][..., None]
        odeg = out_deg[0]
        Vp, H = owned.shape
        n, B = sidx.shape

        def exchange(x):
            send = jnp.where(smask, x[sidx], 0.0)          # [n, B, H]
            recv = jax.lax.all_to_all(send, "ep", split_axis=0,
                                      concat_axis=0, tiled=False)
            return recv.reshape(n * B, H)

        def layer(params, owned, e):
            halo = exchange(owned)
            # local table: [owned ; halo ; dump row for masked slots]
            table = jnp.concatenate(
                [owned, halo, jnp.zeros((1, H), owned.dtype)])
            hw_src = table @ params["src_weight"]
            hw_dst = table @ params["dst_weight"]
            # receivers are owned; gather their table rows directly
            edge_msg = jnp.where(
                rev,
                hw_dst[snd] - hw_src[rcv],
                hw_dst[rcv] - hw_src[snd])
            node_msg = jnp.where(rev, e @ params["out_weight"],
                                 -(e @ params["in_weight"]))
            node_msg = jnp.where(em, node_msg, 0.0)
            # aggregation is FULLY LOCAL: every edge's receiver is owned
            agg = jnp.zeros((Vp + 1, H), node_msg.dtype
                            ).at[rcv].add(node_msg)[:Vp]

            n_out = owned @ params["nloop_weight"] + agg
            if "nbias" in params:
                n_out = n_out + params["nbias"]
            n_out = jax.nn.leaky_relu(n_out, LEAKY_RELU_A)

            d_own = jnp.log2(1.0 + odeg)
            d = jnp.concatenate([d_own, jnp.zeros((1,), d_own.dtype)]
                                )[jnp.minimum(rcv, Vp)][:, None]
            add = 2.0 * (1.0 + d) * (
                e @ (params["src_weight"] - params["dst_weight"]))
            e_out = e @ params["eloop_weight"] + edge_msg + add
            if "ebias" in params:
                e_out = e_out + params["ebias"]
            e_out = jax.nn.leaky_relu(e_out, LEAKY_RELU_A)
            # zero masked rows: pad receivers (Vp) index the gather
            # TABLE's first halo row (its dump sits at Vp + n*B), so
            # unmasked pad slots would carry partition-dependent garbage
            e_out = jnp.where(em, e_out, 0.0)
            return n_out, e_out

        h = owned
        for i, params in enumerate(layer_params):
            h, e = layer(params, h, e)
            if activation == "tanh_between" and i < len(layer_params) - 1:
                h, e = jnp.tanh(h), jnp.tanh(e)
        return h[None], e[None]

    ep = P("ep")
    return _shard_map(
        forward, mesh,
        in_specs=(P(), ep, ep, ep, ep, ep, ep, ep, ep, ep),
        out_specs=(ep, ep),
    )


def unshard_nodes(part: Dict[str, Any], owned_out) -> np.ndarray:
    """[n, Vp, H] owned outputs -> [V, H] in original node order."""
    arr = np.asarray(owned_out)
    V = len(part["owner"])
    out = np.zeros((V, arr.shape[-1]), arr.dtype)
    for s in range(part["n"]):
        idx = part["owned_slice"][s]
        valid = idx >= 0
        out[idx[valid]] = arr[s][valid]
    return out
