"""Static-shape graph containers for XLA execution.

This is the static-shape replacement for the reference's graph containers
(`Graph(dgl.DGLGraph)` and `EdgeSeq`, /root/reference/SubgraphCountingMatching/
dataset.py:111-769,1053-1373). Instead of a mutable graph object with feature
dicts, we use immutable struct-of-arrays pytrees with *static* padded shapes so
that XLA compiles one program per (V_max, E_max) bucket:

- `GraphBatch`  — a batch of B graphs, each padded to V_max nodes / E_max
  edges; layout [B, V_max] / [B, E_max].  This is the SCM workhorse: batching
  is a leading axis (so data parallelism = shard axis 0 of every leaf), and
  message passing lowers to batched gathers + one-hot einsums.
- `FlatGraph`   — one large graph in flat COO form (UNC workload; PubMed/Yelp
  scale), aggregated with segment-sum (XLA scatter-add).

Padding convention: **post-pad** — real entries occupy the head of each row,
padding the tail; `node_mask`/`edge_mask` mark real entries.  (The reference
pre-pads, dataset.py `batch_convert_len_to_mask(pre_pad=True)`; we translate at
parity-test boundaries only.)  Padded edges have senders == receivers == 0 and
must always be masked out by consumers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from .nn import struct


@struct.dataclass
class GraphBatch:
    """A batch of B graphs padded to a static (V_max, E_max) envelope.

    Equivalent capability surface of the reference `Graph` container
    (dataset.py:1053-1373): ids, labels, degrees, batching — but immutable,
    functional, and statically shaped.
    """

    # Structure: [B, E] int32 node indices (into the V axis of the same graph).
    senders: jnp.ndarray
    receivers: jnp.ndarray
    # Features: [B, V] / [B, E] int32.
    node_id: jnp.ndarray
    node_label: jnp.ndarray
    edge_label: jnp.ndarray
    # Validity masks: [B, V] / [B, E] bool.
    node_mask: jnp.ndarray
    edge_mask: jnp.ndarray
    # Reversed-edge augmentation flag (reference REVFLAG, dataset.py:1474-1506):
    # [B, E] bool; True for the artificially added reverse direction.
    rev_flag: jnp.ndarray
    # [B] int32 true sizes.
    n_node: jnp.ndarray
    n_edge: jnp.ndarray

    # ---- shapes --------------------------------------------------------------
    @property
    def batch_size(self) -> int:
        return self.node_id.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_id.shape[1]

    @property
    def max_edges(self) -> int:
        return self.senders.shape[1]

    # ---- degrees -------------------------------------------------------------
    # Reference: dgl out_degrees/in_degrees with cached INDEGREE/OUTDEGREE
    # (dataset.py:1222-1236). Here recomputed on device: a masked scatter-add
    # of ones. XLA folds this into the surrounding program; it is cheap
    # relative to the matmuls.
    def out_degrees(self) -> jnp.ndarray:
        """[B, V] float32 out-degree per node (over all real edges)."""
        return _bincount_batched(self.senders, self.edge_mask, self.max_nodes)

    def in_degrees(self) -> jnp.ndarray:
        """[B, V] float32 in-degree per node (over all real edges)."""
        return _bincount_batched(self.receivers, self.edge_mask, self.max_nodes)

    # ---- conversions ---------------------------------------------------------
    def flatten(self) -> "FlatGraph":
        """Concatenate the batch into one flat disjoint-union graph.

        Mirror of `dgl.batch` semantics (dataset.py:1299-1321) with node-index
        offsets of V_max per graph (padded slots included, masked off).
        """
        b, v = self.node_id.shape
        offs = (jnp.arange(b, dtype=jnp.int32) * v)[:, None]
        return FlatGraph(
            senders=(self.senders + offs).reshape(-1),
            receivers=(self.receivers + offs).reshape(-1),
            node_id=self.node_id.reshape(-1),
            node_label=self.node_label.reshape(-1),
            edge_label=self.edge_label.reshape(-1),
            node_mask=self.node_mask.reshape(-1),
            edge_mask=self.edge_mask.reshape(-1),
            rev_flag=self.rev_flag.reshape(-1),
            num_nodes=b * v,
        )


@struct.dataclass
class FlatGraph:
    """One flat COO graph (static E, V) — the UNC large-graph container."""

    senders: jnp.ndarray     # [E] int32
    receivers: jnp.ndarray   # [E] int32
    node_id: jnp.ndarray     # [V] int32
    node_label: jnp.ndarray  # [V] int32
    edge_label: jnp.ndarray  # [E] int32
    node_mask: jnp.ndarray   # [V] bool
    edge_mask: jnp.ndarray   # [E] bool
    rev_flag: jnp.ndarray    # [E] bool
    num_nodes: int = struct.field(pytree_node=False)

    @property
    def max_edges(self) -> int:
        return self.senders.shape[0]


@struct.dataclass
class EdgeSeqBatch:
    """Graph-as-edge-sequence container (reference `EdgeSeq`,
    dataset.py:111-769): tuples (u, v, ul, el, vl) sorted lexicographically
    by (u, v, el), padded to a static L per batch (post-pad convention)."""

    u: jnp.ndarray        # [B, L] int32
    v: jnp.ndarray
    ul: jnp.ndarray
    el: jnp.ndarray
    vl: jnp.ndarray
    mask: jnp.ndarray     # [B, L] bool
    rev_flag: jnp.ndarray # [B, L] bool
    n_tuple: jnp.ndarray  # [B] int32
    # padded node-count axis for degree gathers (static)
    num_nodes: int = struct.field(pytree_node=False)

    @property
    def batch_size(self) -> int:
        return self.u.shape[0]

    @property
    def max_len(self) -> int:
        return self.u.shape[1]

    def out_degrees(self) -> jnp.ndarray:
        """[B, num_nodes] out-degrees over real tuples."""
        return _bincount_batched(self.u, self.mask, self.num_nodes)

    def in_degrees(self) -> jnp.ndarray:
        return _bincount_batched(self.v, self.mask, self.num_nodes)


def record_to_edgeseq(rec: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Graph record -> edge-sequence record (EdgeSeq.from_graph semantics:
    tuples sorted lexicographically by (u, v, el), dataset.py:111-769).
    Returns the sort permutation as "order" so per-edge targets can follow.
    """
    em = rec["edge_mask"].astype(bool)
    n_edge = int(rec["n_edge"])
    e_max = em.shape[0]
    u = rec["senders"][em]
    v = rec["receivers"][em]
    el = rec["edge_label"][em]
    nl = rec["node_label"]
    order = np.lexsort((el, v, u))

    def pad(x, fill=0):
        out = np.full((e_max,), fill, x.dtype)
        out[: n_edge] = x[order]
        return out

    return {
        "u": pad(u), "v": pad(v), "el": pad(el),
        "ul": pad(nl[u]), "vl": pad(nl[v]),
        "mask": np.arange(e_max) < n_edge,
        "rev_flag": pad(rec["rev_flag"][em]),
        "n_tuple": np.int32(n_edge),
        "num_nodes": int(rec["node_mask"].shape[0]),
        "order": order,
    }


def edgeseq_add_tuples(rec: Dict[str, np.ndarray],
                       tuples: np.ndarray) -> Dict[str, np.ndarray]:
    """Order-preserving tuple insertion (reference EdgeSeq.add_tuple/
    add_tuples, dataset.py:352-445): new (u, v, ul, el, vl) rows are merged
    into the lexicographic (u, v, el) order, inserted before existing rows
    with equal keys (bisect_left). Among several new tuples with equal keys
    the reference's one-at-a-time bisect_left reverses their order — a
    quirk not reproduced; they keep argument order here. Grows the padded
    envelope when the new tuples overflow it. Host-side numpy.
    """
    tuples = np.asarray(tuples)
    if tuples.ndim == 1:
        tuples = tuples[None]
    m = rec["mask"].astype(bool)
    n_old, n_new = int(m.sum()), len(tuples)
    n = n_old + n_new
    e_max = max(len(m), n)
    u = np.concatenate([tuples[:, 0], rec["u"][m]])
    v = np.concatenate([tuples[:, 1], rec["v"][m]])
    ul = np.concatenate([tuples[:, 2], rec["ul"][m]])
    el = np.concatenate([tuples[:, 3], rec["el"][m]])
    vl = np.concatenate([tuples[:, 4], rec["vl"][m]])
    rev = np.concatenate([np.zeros(n_new, rec["rev_flag"].dtype),
                          rec["rev_flag"][m]])
    # stable sort with new rows listed first -> new-before-equal-existing
    order = np.lexsort((el, v, u))

    def pad(x, dtype=None):
        out = np.zeros((e_max,), dtype or x.dtype)
        out[:n] = x[order]
        return out

    return {
        "u": pad(u), "v": pad(v), "ul": pad(ul), "el": pad(el),
        "vl": pad(vl), "rev_flag": pad(rev),
        "mask": np.arange(e_max) < n,
        "n_tuple": np.int32(n),
        "num_nodes": max(int(rec["num_nodes"]),
                         int(max(u.max(), v.max())) + 1 if n else 0),
    }


def edgeseq_to_graph(rec: Dict[str, np.ndarray],
                     v_max: Optional[int] = None,
                     e_max: Optional[int] = None) -> Dict[str, np.ndarray]:
    """EdgeSeq record -> graph record (reference EdgeSeq.to_graph,
    dataset.py:560-591): nodes are the distinct ids appearing in tuples
    (u's first, then v's — insertion order), compacted to 0..V-1; labels
    from ul/vl; "key" numbers repeated (u, v) multi-edges by occurrence.
    Returns a padded graph record plus "node_id" (original ids) and
    "edge_key".
    """
    m = rec["mask"].astype(bool)
    u, v = rec["u"][m], rec["v"][m]
    ul, vl = rec["ul"][m], rec["vl"][m]
    el = rec["el"][m]
    nid2label: Dict[int, int] = {}
    for a, la in zip(u, ul):
        nid2label.setdefault(int(a), int(la))
    for b, lb in zip(v, vl):
        nid2label.setdefault(int(b), int(lb))
    node_ids = np.asarray(list(nid2label.keys()), np.int64)
    node_labels = np.asarray(list(nid2label.values()), np.int64)
    remap = {int(x): i for i, x in enumerate(node_ids)}
    senders = np.asarray([remap[int(x)] for x in u], np.int64)
    receivers = np.asarray([remap[int(x)] for x in v], np.int64)
    # occurrence index among consecutive equal (u, v) rows
    # (to_graph's roll-and-accumulate, dataset.py:579-585)
    key = np.zeros(len(u), np.int64)
    for i in range(1, len(u)):
        if u[i] == u[i - 1] and v[i] == v[i - 1]:
            key[i] = key[i - 1] + 1
    n_v, n_e = len(node_ids), len(u)
    v_max = v_max or n_v
    e_max = e_max or n_e

    def pad1(x, n, fill=0):
        out = np.full((n,), fill, x.dtype)
        out[: len(x)] = x
        return out

    return {
        "senders": pad1(senders, e_max),
        "receivers": pad1(receivers, e_max),
        "node_label": pad1(node_labels, v_max),
        "edge_label": pad1(el, e_max),
        "node_mask": np.arange(v_max) < n_v,
        "edge_mask": np.arange(e_max) < n_e,
        "rev_flag": pad1(rec["rev_flag"][m], e_max),
        "n_node": np.int32(n_v),
        "n_edge": np.int32(n_e),
        "node_id": pad1(node_ids, v_max),
        "edge_key": pad1(key, e_max),
    }


def batch_edgeseqs(records: List[Dict[str, np.ndarray]]) -> EdgeSeqBatch:
    def stack(key):
        return jnp.asarray(np.stack([r[key] for r in records], axis=0))

    return EdgeSeqBatch(
        u=stack("u"), v=stack("v"), ul=stack("ul"), el=stack("el"),
        vl=stack("vl"), mask=stack("mask"), rev_flag=stack("rev_flag"),
        n_tuple=jnp.asarray(np.stack([r["n_tuple"] for r in records])),
        num_nodes=max(r["num_nodes"] for r in records),
    )


# =============================================================================
# Host-side builders (numpy): the input pipeline constructs these, then the
# arrays are shipped to device once per batch.
# =============================================================================

def single_graph(
    num_nodes: int,
    senders: Sequence[int],
    receivers: Sequence[int],
    node_labels: Optional[Sequence[int]] = None,
    edge_labels: Optional[Sequence[int]] = None,
    v_max: Optional[int] = None,
    e_max: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Build one padded graph record (host-side numpy dict).

    The record is the unit the batching collate operates on; mirrors the
    preprocessing output of `GraphAdjDataset.preprocess` (dataset.py:1422-1445)
    without the DGL object.
    """
    senders = np.asarray(senders, dtype=np.int32)
    receivers = np.asarray(receivers, dtype=np.int32)
    num_edges = len(senders)
    v_max = num_nodes if v_max is None else v_max
    e_max = num_edges if e_max is None else e_max
    if num_nodes > v_max or num_edges > e_max:
        raise ValueError(
            f"graph ({num_nodes}V,{num_edges}E) exceeds envelope ({v_max},{e_max})"
        )
    if node_labels is None:
        node_labels = np.zeros(num_nodes, dtype=np.int32)
    if edge_labels is None:
        edge_labels = np.zeros(num_edges, dtype=np.int32)

    def pad1(x, n, fill=0):
        out = np.full((n,), fill, dtype=np.int32)
        out[: len(x)] = x
        return out

    return {
        "senders": pad1(senders, e_max),
        "receivers": pad1(receivers, e_max),
        "node_id": pad1(np.arange(num_nodes, dtype=np.int32), v_max),
        "node_label": pad1(np.asarray(node_labels, dtype=np.int32), v_max),
        "edge_label": pad1(np.asarray(edge_labels, dtype=np.int32), e_max),
        "node_mask": pad1(np.ones(num_nodes, dtype=np.int32), v_max).astype(bool),
        "edge_mask": pad1(np.ones(num_edges, dtype=np.int32), e_max).astype(bool),
        "rev_flag": np.zeros(e_max, dtype=bool),
        "n_node": np.int32(num_nodes),
        "n_edge": np.int32(num_edges),
    }


def add_reversed_edges(rec: Dict[str, np.ndarray], num_edge_labels: int) -> Dict[str, np.ndarray]:
    """Reversed-edge augmentation on a host record.

    Semantics of the reference transform (train.py:273-327, dataset.py
    `GraphAdjDataset.add_reversed_edges`): for every real edge (u, v, el) add
    (v, u, el + num_edge_labels) with rev_flag=True. Doubles E_max.
    """
    n_edge = int(rec["n_edge"])
    e_max = rec["senders"].shape[0]

    def cat(a, b):
        return np.concatenate([a, b], axis=0)

    out = dict(rec)
    out["senders"] = cat(rec["senders"], rec["receivers"])
    out["receivers"] = cat(rec["receivers"], rec["senders"])
    rev_labels = rec["edge_label"].copy()
    rev_labels[: n_edge] += num_edge_labels
    out["edge_label"] = cat(rec["edge_label"], rev_labels)
    out["edge_mask"] = cat(rec["edge_mask"], rec["edge_mask"])
    out["rev_flag"] = cat(np.zeros(e_max, dtype=bool), rec["edge_mask"].astype(bool))
    out["n_edge"] = np.int32(2 * n_edge)
    return out


def compact_record(rec: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Re-pack a record so real edges are contiguous at the head (post-pad)."""
    em = rec["edge_mask"].astype(bool)
    order = np.argsort(~em, kind="stable")  # real edges first, stable
    out = dict(rec)
    for k in ("senders", "receivers", "edge_label", "edge_mask", "rev_flag"):
        out[k] = rec[k][order]
    return out


def batch_graphs_dense(dense: Dict[str, np.ndarray], idx) -> GraphBatch:
    """GraphBatch from a dataset-level dense cache: one C-speed fancy-index
    gather per field instead of a 2048-element Python stack per batch
    (GraphAdjDataset builds `dense` once; collate dropped ~56 ms -> ~2 ms
    per flagship batch on this host)."""
    # ONE batched device_put for all fields: each transfer has its own
    # latency, so 10 per-field puts would dominate a fast step
    arrs = {k: dense[k][idx] for k in (
        "senders", "receivers", "node_id", "node_label", "edge_label",
        "node_mask", "edge_mask", "rev_flag", "n_node", "n_edge")}
    return GraphBatch(**jax.device_put(arrs))


def batch_graphs(records: List[Dict[str, np.ndarray]]) -> GraphBatch:
    """Stack host records (all same envelope) into a device GraphBatch."""
    def stack(key):
        return np.stack([r[key] for r in records], axis=0)

    return GraphBatch(
        senders=jnp.asarray(stack("senders")),
        receivers=jnp.asarray(stack("receivers")),
        node_id=jnp.asarray(stack("node_id")),
        node_label=jnp.asarray(stack("node_label")),
        edge_label=jnp.asarray(stack("edge_label")),
        node_mask=jnp.asarray(stack("node_mask")),
        edge_mask=jnp.asarray(stack("edge_mask")),
        rev_flag=jnp.asarray(stack("rev_flag")),
        n_node=jnp.asarray(np.stack([r["n_node"] for r in records])),
        n_edge=jnp.asarray(np.stack([r["n_edge"] for r in records])),
    )


# =============================================================================
# Internals
# =============================================================================

def _bincount_batched(idx: jnp.ndarray, mask: jnp.ndarray, n: int) -> jnp.ndarray:
    """[B, E] indices + mask -> [B, n] float32 counts.

    For small n a masked one-hot reduce (no scatter); scatter-add for
    large n.
    """
    ones = mask.astype(jnp.float32)
    if n <= 2048:
        oh = jax.nn.one_hot(idx, n, dtype=jnp.float32)
        return jnp.einsum("...ev,...e->...v", oh, ones)
    return jax.vmap(lambda i, w: jnp.zeros((n,), jnp.float32).at[i].add(w))(idx, ones)
