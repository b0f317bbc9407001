"""Owner-sharded halo-exchange execution of the REAL UNC model.

parallel/halo.py demonstrated the exchange schedule on a bare DMP layer;
this module runs the full `UNCTrainModel` (any backbone, update MLPs,
BatchNorm, edge_norm, DistMult loss + regularizers — reference
Model/DMPNN/src/model.py:117-280, 632-737) with NODE STATE OWNER-SHARDED
(`node_sharding="owner"`, unc/model.py):

  * nodes are partitioned across the 'ep' mesh axis (degree-balanced
    greedy or contiguous ranges), each shard holding its owned rows
    [Vp, H];
  * every edge lives on the shard that owns its RECEIVER, so the
    segment-sum aggregation completes locally — no per-layer [V, H] psum
    (the full-psum replicated-node path is parallel/ep_unc.py);
  * each layer fetches only boundary sender rows with one all_to_all of
    [n, B, H] (`unc.model._halo_table`); B <= Vp by construction;
  * BatchNorm statistics, per-relation edge means, and the regularizer
    sums still ride [H]-sized psums (rows partition across shards);
  * the DistMult/supervised losses all_gather the final [Vp, H] node
    outputs once and score samples addressed by PACKED ids
    (owner * Vp + rank), remapped host-side here.

Everything the device sees is a static padded envelope: (Vp, Ep, B) are
fixed by `halo_envelope` so every batch compiles to the same program;
`build_halo_sub` raises if a sampled subgraph overflows it (B = Vp never
overflows — the boundary rows one owner can export are bounded by the
rows it owns).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..unc.model import UNCTrainModel
from .ep_unc import _shard_map

# arrays carrying a leading [n_shards] axis, sharded over 'ep'
SHARD_KEYS = ("nid", "node_mask", "out_deg", "senders", "receivers",
              "edge_type", "rev_flag", "edge_mask", "edge_norm",
              "send_idx", "send_mask")


def halo_envelope(v_max: int, e_max: int, n_shards: int,
                  edge_slack: float = 1.5,
                  boundary: Optional[int] = None) -> Tuple[int, int, int]:
    """Static (Vp, Ep, B) for jit: owned rows, edges, and boundary rows
    per shard. B defaults to Vp (always sufficient); pass a smaller
    `boundary` when the partitioner finds locality (community graphs) to
    shrink the all_to_all."""
    vp = -(-v_max // n_shards)
    ep = min(e_max, math.ceil(edge_slack * e_max / n_shards) + 64)
    return vp, ep, (boundary if boundary is not None else vp)


def _assign_owners_capped(senders, receivers, edge_mask, v_max, n_shards,
                          vp, method):
    """owner[row] for every padded node row; per-shard row count <= vp.

    "degree": nodes in descending in-degree order go to the shard with the
    fewest owned in-edges among shards that still have room (balances the
    local segment-sum while respecting the static envelope).
    "range": contiguous row ranges (locality-preserving for generators
    that wire locally).
    "bfs": METIS-style greedy region growing — each shard grows from an
    un-owned high-degree seed by repeatedly claiming the frontier node
    with the most already-owned neighbors (locality => fewer boundary
    sender rows => smaller per-layer all_to_all; measured boundary
    reduction on community graphs in tests/test_halo_unc.py)."""
    if method == "range":
        return (np.arange(v_max) // vp).astype(np.int32)
    in_deg = np.bincount(receivers[edge_mask], minlength=v_max)
    if method == "bfs":
        return _assign_owners_bfs(senders, receivers, edge_mask, v_max,
                                  n_shards, vp, in_deg)
    order = np.argsort(-in_deg, kind="stable")
    owner = np.zeros(v_max, np.int32)
    load = np.zeros(n_shards, np.int64)
    rows = np.zeros(n_shards, np.int64)
    for v in order:
        open_ = rows < vp
        cand = np.where(open_, load, np.iinfo(np.int64).max)
        s = int(np.argmin(cand))
        owner[v] = s
        load[s] += in_deg[v]
        rows[s] += 1
    return owner


def _assign_owners_bfs(senders, receivers, edge_mask, v_max, n_shards,
                       vp, in_deg):
    """Greedy region growing (coarse METIS idea, host-side numpy).

    Shards take turns claiming one node each: the frontier candidate with
    the most edges into the shard's already-owned set (ties broken toward
    high degree), falling back to the highest-degree unclaimed node when
    the frontier is exhausted (disconnected components). Each shard owns
    at most vp rows, so the static halo envelope always holds."""
    s_real = senders[edge_mask]
    r_real = receivers[edge_mask]
    # undirected adjacency in CSR form for neighbor scans
    u = np.concatenate([s_real, r_real])
    w = np.concatenate([r_real, s_real])
    order = np.argsort(u, kind="stable")
    u, w = u[order], w[order]
    starts = np.searchsorted(u, np.arange(v_max + 1))

    owner = np.full(v_max, -1, np.int32)
    rows = np.zeros(n_shards, np.int64)
    # affinity[s, v]: #edges between v and shard s's owned set so far
    affinity = np.zeros((n_shards, v_max), np.int32)
    deg_rank = np.argsort(-in_deg, kind="stable")
    seed_ptr = 0
    # bulk claiming bounds host cost: each shard claims up to c best-
    # affinity frontier nodes per round, so the loop runs O(n*vp/c)
    # rounds of O(V) argpartitions instead of V rounds of O(V) argmaxes
    # (the one-at-a-time form cost minutes per batch at Yelp scale).
    # c=1 when vp < 16 reproduces the exact greedy (tests).
    c = max(1, vp // 16)

    while (owner < 0).any():
        progress = False
        for s in range(n_shards):
            room = vp - int(rows[s])
            if room <= 0:
                continue
            take = min(c, room)
            aff = np.where(owner < 0, affinity[s], -1)
            cand = np.argpartition(aff, -take)[-take:]
            cand = cand[aff[cand] > 0]
            if len(cand) == 0:
                while seed_ptr < v_max and owner[deg_rank[seed_ptr]] >= 0:
                    seed_ptr += 1
                if seed_ptr >= v_max:
                    continue
                cand = deg_rank[seed_ptr: seed_ptr + 1]
            owner[cand] = s
            rows[s] += len(cand)
            nbrs = np.concatenate(
                [w[starts[v]: starts[v + 1]] for v in cand]) if len(cand) \
                else np.zeros(0, np.int64)
            if len(nbrs):
                np.add.at(affinity[s], nbrs, 1)
            progress = True
        if not progress:
            break
    return owner


def build_halo_sub(padded: Dict[str, np.ndarray], n_shards: int,
                   vp: int, ep: int, b: int, method: str = "degree"
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Partition a `pad_subgraph` output for owner-sharded execution.

    Returns (dev, meta): `dev` is the device-facing dict — [n, ...] arrays
    for SHARD_KEYS plus replicated samples/labels/sample_mask — and `meta`
    carries the host-side inverse maps (owned_slice for node rows,
    edge_perm for edge rows) plus (vp, ep, b).

    Per-shard edges stay sorted by LOCAL receiver: `pad_subgraph` sorts
    globally by receiver, each shard takes an order-preserving
    subsequence, and rank-within-owner is monotone in the original row
    id — so `UNCTrainModel(sorted_edges=True)` remains valid.
    """
    v_max = len(padded["nid"])
    senders = np.asarray(padded["senders"])
    receivers = np.asarray(padded["receivers"])
    e_mask_in = np.asarray(padded["edge_mask"])

    owner = _assign_owners_capped(senders, receivers, e_mask_in, v_max,
                                  n_shards, vp, method)
    rows = np.bincount(owner, minlength=n_shards)
    if rows.max() > vp:
        raise ValueError(f"partition places {rows.max()} rows on one shard; "
                         f"envelope vp={vp}")

    rank = np.zeros(v_max, np.int64)
    owned_slice = np.full((n_shards, vp), -1, np.int64)
    for s in range(n_shards):
        idx = np.flatnonzero(owner == s)
        rank[idx] = np.arange(len(idx))
        owned_slice[s, : len(idx)] = idx

    valid = owned_slice >= 0
    safe = np.maximum(owned_slice, 0)
    nid_sh = np.where(valid, np.asarray(padded["nid"])[safe], 0)
    node_mask_sh = np.logical_and(valid,
                                  np.asarray(padded["node_mask"])[safe])
    out_deg_full = np.bincount(senders[e_mask_in], minlength=v_max
                               ).astype(np.float32)
    out_deg_sh = np.where(valid, out_deg_full[safe], 0.0).astype(np.float32)

    # --- edge placement: receiver's owner --------------------------------
    real = np.flatnonzero(e_mask_in)
    e_owner = owner[receivers[real]]
    counts = np.bincount(e_owner, minlength=n_shards)
    if counts.max() > ep:
        raise ValueError(
            f"{counts.max()} edges land on one shard; envelope ep={ep} "
            f"(raise edge_slack in halo_envelope)")

    dump = vp + n_shards * b
    l_send = np.full((n_shards, ep), dump, np.int64)
    l_recv = np.zeros((n_shards, ep), np.int64)
    e_type = np.zeros((n_shards, ep), np.asarray(padded["edge_type"]).dtype)
    rev_sh = np.zeros((n_shards, ep), np.asarray(padded["rev_flag"]).dtype)
    e_mask_sh = np.zeros((n_shards, ep), bool)
    has_norm = "edge_norm" in padded
    if has_norm:
        norm_sh = np.zeros((n_shards, ep, 1), np.float32)
    edge_perm = []

    need = []
    send_idx = np.zeros((n_shards, n_shards, b), np.int64)
    send_mask = np.zeros((n_shards, n_shards, b), bool)
    for s in range(n_shards):
        es = real[e_owner == s]
        snd = senders[es]
        row = []
        for o in range(n_shards):
            if o == s:
                row.append(np.zeros(0, np.int64))
                continue
            uniq = np.unique(snd[owner[snd] == o])
            if len(uniq) > b:
                raise ValueError(f"boundary {len(uniq)} > envelope b={b}")
            row.append(uniq)
            send_idx[o, s, : len(uniq)] = rank[uniq]
            send_mask[o, s, : len(uniq)] = True
        need.append(row)

        k = len(es)
        local = np.zeros(k, np.int64)
        own_s = owner[snd]
        for o in range(n_shards):
            m = own_s == o
            if not m.any():
                continue
            if o == s:
                local[m] = rank[snd[m]]
            else:
                local[m] = vp + o * b + np.searchsorted(need[s][o], snd[m])
        l_send[s, :k] = local
        l_recv[s, :k] = rank[receivers[es]]
        if k:
            # pad tail repeats the last real local receiver so the shard
            # stream stays NON-DECREASING — the drivers run the model
            # with sorted_edges=True and XLA's indices_are_sorted scatter
            # is implementation-defined on unsorted indices (pad messages
            # are zeroed, so the repeated row only accumulates zeros)
            l_recv[s, k:] = l_recv[s, k - 1]
        e_type[s, :k] = np.asarray(padded["edge_type"])[es]
        rev_sh[s, :k] = np.asarray(padded["rev_flag"])[es]
        e_mask_sh[s, :k] = True
        if has_norm:
            norm_sh[s, :k] = np.asarray(padded["edge_norm"])[es]
        edge_perm.append(es)

    # --- samples: packed global ids (owner * vp + rank) ------------------
    packed = owner.astype(np.int64) * vp + rank
    samples = np.asarray(padded["samples"]).copy()
    samples[:, 0] = packed[samples[:, 0]]
    samples[:, 2] = packed[samples[:, 2]]

    dev = {
        "nid": nid_sh, "node_mask": node_mask_sh, "out_deg": out_deg_sh,
        "senders": l_send, "receivers": l_recv, "edge_type": e_type,
        "rev_flag": rev_sh, "edge_mask": e_mask_sh,
        "send_idx": send_idx, "send_mask": send_mask,
        "samples": samples, "labels": np.asarray(padded["labels"]),
        "sample_mask": np.asarray(padded["sample_mask"]),
    }
    if has_norm:
        dev["edge_norm"] = norm_sh
    meta = {"owner": owner, "rank": rank, "owned_slice": owned_slice,
            "edge_perm": edge_perm, "vp": vp, "ep": ep, "b": b,
            "packed": packed}
    return dev, meta


def halo_sub_specs(dev: Dict[str, Any]) -> Dict[str, P]:
    return {k: (P("ep") if k in SHARD_KEYS else P()) for k in dev}


def shard_halo_sub(mesh: Mesh, dev: Dict[str, np.ndarray]
                   ) -> Dict[str, jnp.ndarray]:
    return {k: jax.device_put(
        jnp.asarray(v),
        NamedSharding(mesh, P("ep") if k in SHARD_KEYS else P()))
        for k, v in dev.items()}


def _squeeze_local(sub):
    return {k: (v[0] if k in SHARD_KEYS else v) for k, v in sub.items()}


def make_halo_model(**model_kwargs) -> UNCTrainModel:
    return UNCTrainModel(ep_axis="ep", node_sharding="owner", **model_kwargs)


def _out_spec(model: UNCTrainModel):
    """Backbone output tuple specs: node stream (h) and edge stream (z)
    owner-/edge-sharded, per-relation means replicated."""
    if model.backbone == "DMPNN":     # (h, z, r_bar)
        return (P("ep"), P("ep"), P())
    if model.backbone == "CompGCN":   # (h, r)
        return (P("ep"), P("ep"))
    return (P("ep"),)                 # (h,)


def make_halo_apply(model: UNCTrainModel, mesh: Mesh) -> Callable:
    """Jitted owner-sharded forward: (variables, dev) -> (out, pred).

    Node-stream outputs come back with the leading shard axis ([n, Vp, ...]);
    map them to original rows with `unshard_halo_nodes`."""

    specs = _out_spec(model)

    @jax.jit
    def fwd(variables, dev):
        def inner(variables, dev):
            out, pred = model.apply(variables, _squeeze_local(dev),
                                    train=False)
            out = tuple(x[None] if s == P("ep") else x
                        for x, s in zip(out, specs))
            return out, (pred[None] if pred is not None else jnp.zeros(()))

        return _shard_map(
            inner, mesh,
            in_specs=(P(), halo_sub_specs(dev)),
            out_specs=(specs, P("ep") if model.nlabel > 0 else P()),
        )(variables, dev)

    return fwd


def make_halo_train_step(model: UNCTrainModel, tx, mesh: Mesh,
                         amp: bool = False) -> Callable:
    """Jitted owner-sharded unsupervised train step, same signature as
    make_unc_train_step / make_ep_train_step:
      (params, opt_state, batch_stats, dev, dropout_rng)
        -> (params, opt_state, batch_stats, loss)
    amp=True runs the backbone in bf16 with f32 master params / loss
    (unc.model.apply_unc_forward).
    """
    import optax

    from ..unc.model import apply_unc_forward

    @jax.jit
    def step(params, opt_state, batch_stats, dev, dropout_rng):
        spec = halo_sub_specs(dev)

        def loss_fn(p):
            def inner(p, batch_stats, dev, rng):
                sub = _squeeze_local(dev)
                (out, _pred), new_stats = apply_unc_forward(
                    model, p, batch_stats, sub, rng, amp=amp)
                loss = model.apply(
                    {"params": p}, out, sub["edge_type"], sub["edge_mask"],
                    sub["samples"], sub["labels"], sub["sample_mask"],
                    sub["node_mask"],
                    method=UNCTrainModel.unsupervised_loss)
                return loss, new_stats

            return _shard_map(
                inner, mesh,
                in_specs=(P(), P(), spec, P()),
                out_specs=(P(), P()),
            )(p, batch_stats, dev, dropout_rng)

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state,
                (new_stats if batch_stats else batch_stats), loss)

    return step


def unshard_halo_nodes(meta: Dict[str, Any], sharded) -> np.ndarray:
    """[n, Vp, H] owner-sharded node rows -> [v_max, H] original order."""
    arr = np.asarray(sharded)
    v_max = len(meta["owner"])
    out = np.zeros((v_max,) + arr.shape[2:], arr.dtype)
    for s in range(arr.shape[0]):
        idx = meta["owned_slice"][s]
        ok = idx >= 0
        out[idx[ok]] = arr[s][ok]
    return out


def unshard_halo_edges(meta: Dict[str, Any], sharded,
                       e_max: int) -> np.ndarray:
    """[n, Ep, H] receiver-owner-placed edge rows -> [e_max, H] original
    (receiver-sorted) order."""
    arr = np.asarray(sharded)
    out = np.zeros((e_max,) + arr.shape[2:], arr.dtype)
    for s, es in enumerate(meta["edge_perm"]):
        out[es] = arr[s][: len(es)]
    return out
