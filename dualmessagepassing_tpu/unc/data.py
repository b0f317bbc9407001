"""UNC data pipeline: HIN loaders, whole-graph build, subgraph samplers,
negative sampling — host-side (numpy), feeding padded static subgraphs.

Reference: /root/reference/UnsupervisedNodeClassification/Model/DMPNN/src/
utils.py (loaders 168-240, samplers 279-434, negative sampling 539-551,
graph build 473-491, norms 437-453) and main.py:48-218.

Semantics preserved:
  * the whole graph materializes BOTH directions: edges (s, d) and (d, s)
    with types rel and rel + num_rels (utils.py:473-491);
  * random-walk sampler: width-1 walks of length `depth` from the seeds
    (walks follow out-edges, restart from the seeds each iteration), union
    of visited nodes, then <=width in-edges sampled per node
    (utils.py:279-312);
  * neighbor sampler: depth-1 expansion rounds over in-edges, then the final
    <=width in-edge sampling (utils.py:315-349);
  * isolated non-seed nodes are dropped; node relabeling keeps ascending
    original ids (dgl subgraph semantics);
  * edge dropout keeps ~split_size of sampled edges (np.unique of uniform
    ints, utils.py:392-394);
  * negative sampling corrupts head or tail uniformly with the skip-self
    adjustment (utils.py:539-551).

Static-shape adaptation: sampled subgraphs are padded to a static (v_max, e_max)
envelope so one compiled train step serves every batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


# =============================================================================
# loaders (utils.py:168-240)
# =============================================================================

def load_unsupervised(link_path: str, node_path: Optional[str] = None,
                      attributed: bool = False):
    """-> (triplets [E, 3] (src, rel, dst), num_nodes, num_rels, attrs|None)."""
    triplets = []
    with open(link_path) as f:
        header = f.readline().split()
        num_nodes, num_rels = int(header[0]), int(header[1])
        for line in f:
            triplets.append([int(x) for x in line.split()])
    triplets = np.asarray(triplets, np.int64)
    attrs = None
    if attributed and node_path:
        attrs = _load_attrs(node_path)
    return triplets, num_nodes, num_rels, attrs


def load_supervised(link_path: str, node_path: str, train_pool: set,
                    attributed: bool = False):
    """Also returns labeled-node -> incident-edge-index lists
    (utils.py:168-195)."""
    triplets = []
    train_indices: Dict[int, List[int]] = {}
    with open(link_path) as f:
        header = f.readline().split()
        num_nodes, num_rels = int(header[0]), int(header[1])
        for i, line in enumerate(f):
            row = [int(x) for x in line.split()]
            triplets.append(row)
            if row[0] in train_pool:
                train_indices.setdefault(row[0], []).append(i)
            if row[-1] in train_pool:
                train_indices.setdefault(row[-1], []).append(i)
    attrs = _load_attrs(node_path) if attributed else None
    return (np.asarray(triplets, np.int64), num_nodes, num_rels,
            train_indices, len(train_indices), attrs)


def load_label(path: str):
    """-> (train_pool, train_labels, nlabels, multi) (utils.py:198-216)."""
    train_pool, train_labels, all_labels, multi = set(), {}, set(), False
    with open(path) as f:
        for line in f:
            node, label = line.rstrip("\n").split("\t")
            node = int(node)
            train_pool.add(node)
            if multi or "," in label:
                multi = True
                lab = np.asarray(label.split(","), np.int64)
                train_labels[node] = lab
                all_labels.update(int(x) for x in lab)
            else:
                lab = int(label)
                train_labels[node] = lab
                all_labels.add(lab)
    return train_pool, train_labels, len(all_labels), multi


def _load_attrs(path: str) -> np.ndarray:
    attrs = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            attrs[int(parts[0])] = np.asarray(parts[1].split(","), np.float32)
    return np.stack([attrs[k] for k in range(len(attrs))])


def save_embeddings(path: str, header: str, embs: np.ndarray,
                    index: Optional[np.ndarray] = None):
    """emb.dat writer with args header line (utils.py:243-258)."""
    with open(path, "w") as f:
        f.write(header + "\n")
        ids = range(len(embs)) if index is None else index
        for n, emb in zip(ids, embs):
            f.write(f"{n}\t" + " ".join(str(x) for x in emb) + "\n")


# =============================================================================
# whole graph (both directions; rel and rel + num_rels)
# =============================================================================

class WholeGraph:
    """Host CSR graph over the doubled edge set (utils.py:473-491)."""

    def __init__(self, num_nodes: int, num_rels: int, triplets: np.ndarray):
        self.num_nodes = num_nodes
        self.num_rels = num_rels
        src = np.concatenate([triplets[:, 0], triplets[:, 2]])
        dst = np.concatenate([triplets[:, 2], triplets[:, 0]])
        rel = np.concatenate([triplets[:, 1], triplets[:, 1] + num_rels])
        self.senders = src.astype(np.int64)
        self.receivers = dst.astype(np.int64)
        self.edge_type = rel.astype(np.int64)
        self.num_edges = len(src)
        # CSR by destination (in-edges) and by source (out-edges)
        self.in_order = np.argsort(dst, kind="stable")
        self.in_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(dst, minlength=num_nodes))])
        self.out_order = np.argsort(src, kind="stable")
        self.out_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(src, minlength=num_nodes))])
        self.in_deg = np.bincount(dst, minlength=num_nodes)
        self.out_deg = np.bincount(src, minlength=num_nodes)

    def in_edges(self, v: int) -> np.ndarray:
        return self.in_order[self.in_ptr[v]: self.in_ptr[v + 1]]

    def out_neighbors(self, v: int) -> np.ndarray:
        eids = self.out_order[self.out_ptr[v]: self.out_ptr[v + 1]]
        return self.receivers[eids]


# =============================================================================
# samplers
# =============================================================================

def _sample_in_edges(g: WholeGraph, nodes: np.ndarray, width: int, rng):
    """<=width in-edges per node, uniform without replacement
    (dgl.sampling.sample_neighbors(edge_dir='in') semantics).
    C++ fast path in csrc/hostkernels.cpp."""
    from .. import native
    if native.available() and len(nodes):
        out = native.sample_in_edges_native(
            g.in_ptr, g.in_order, np.asarray(nodes, np.int64), width,
            int(rng.integers(0, 2 ** 62)))
        if out is not None:
            return out
    eids = []
    for v in nodes:
        cand = g.in_edges(int(v))
        if len(cand) > width:
            cand = rng.choice(cand, size=width, replace=False)
        eids.append(cand)
    return np.concatenate(eids) if eids else np.zeros(0, np.int64)


def _finalize_subgraph(g: WholeGraph, nodes: np.ndarray, eids: np.ndarray,
                       seed_set: np.ndarray) -> Dict[str, np.ndarray]:
    """Drop isolated non-seeds, relabel ascending, package COO.
    Fully vectorized (the remap runs over ~1M endpoints at Yelp scale)."""
    src = g.senders[eids]
    dst = g.receivers[eids]
    # kept = edge-touched nodes plus (possibly isolated) seeds
    # (utils.py:298-303: deg-0 nodes removed unless they are seeds)
    nid = np.unique(np.concatenate(
        [src, dst, np.asarray(seed_set, np.int64)]))
    return {
        "nid": nid,
        "senders": np.searchsorted(nid, src),
        "receivers": np.searchsorted(nid, dst),
        "edge_type": g.edge_type[eids].copy(),
        "rev_flag": (g.edge_type[eids] >= g.num_rels),
        "eids": eids,
    }


def sample_subgraph_by_randomwalks(g: WholeGraph, seeds: np.ndarray,
                                   depth: int = 2, width: int = 10,
                                   rng=None) -> Dict[str, np.ndarray]:
    rng = rng or np.random.default_rng()
    seeds_arr = np.asarray(seeds, np.int64)
    from .. import native
    if native.available() and width > 1 and len(seeds_arr):
        walks = native.random_walks_native(
            g.out_ptr, g.receivers[g.out_order], seeds_arr, depth,
            width - 1, int(rng.integers(0, 2 ** 62)))
        visited = walks.reshape(-1)
        nodes = np.unique(np.concatenate(
            [seeds_arr, visited[visited >= 0]]))
    else:
        node_sets = [seeds_arr]
        for _ in range(width - 1):
            # one walk of length `depth` per seed, following out-edges
            cur = seeds_arr.copy()
            alive = np.ones(len(cur), bool)
            visited = [cur.copy()]
            for _step in range(depth):
                nxt = np.full(len(cur), -1, np.int64)
                for i, v in enumerate(cur):
                    if not alive[i]:
                        continue
                    nbrs = g.out_neighbors(int(v))
                    if len(nbrs) == 0:
                        alive[i] = False
                    else:
                        nxt[i] = nbrs[rng.integers(0, len(nbrs))]
                cur = np.where(alive, np.maximum(nxt, 0), cur)
                visited.append(cur[alive].copy())
                if not alive.any():
                    break
            node_sets.append(np.concatenate(visited))
        nodes = np.unique(np.concatenate(node_sets))
    eids = _sample_in_edges(g, nodes, width, rng)
    return _finalize_subgraph(g, nodes, eids, np.asarray(seeds, np.int64))


def sample_subgraph_by_neighbors(g: WholeGraph, seeds: np.ndarray,
                                 depth: int = 2, width: int = 10,
                                 rng=None) -> Dict[str, np.ndarray]:
    rng = rng or np.random.default_rng()
    nodes = np.asarray(seeds, np.int64)
    for _ in range(depth - 1):
        eids = _sample_in_edges(g, nodes, width, rng)
        srcs = g.senders[eids]
        # reference keeps expansion nodes with out_deg > 0 (utils.py:329-330)
        srcs = srcs[g.out_deg[srcs] > 0]
        nodes = np.unique(np.concatenate([nodes, srcs]))
    eids = _sample_in_edges(g, nodes, width, rng)
    return _finalize_subgraph(g, nodes, eids, np.asarray(seeds, np.int64))


def negative_sampling(pos: np.ndarray, num_entity: int, rate: int,
                      rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    n = len(pos) * rate
    neg = np.tile(pos, (rate, 1))
    values = rng.integers(0, num_entity - 1, size=n)
    choices = rng.random(n)
    subj = choices > 0.5
    obj = ~subj
    neg[subj, 0] = values[subj] + (values[subj] >= neg[subj, 0])
    neg[obj, 2] = values[obj] + (values[obj] >= neg[obj, 2])
    return neg


def labeled_edges_sampling(train_indices: Dict[int, list], ntrain: int,
                           if_train: bool, label_batch_size: int,
                           batch_index: int = 0, rng=None):
    """Sample labeled nodes and collect their incident edge indices
    (utils.py:494-509). Returns (edge_indices, sampled_node_set)."""
    rng = rng or np.random.default_rng()
    if if_train:
        sampled = set(rng.integers(0, ntrain,
                                   size=label_batch_size).tolist())
    else:
        sampled = set(range(batch_index * label_batch_size,
                            min(ntrain, (batch_index + 1) * label_batch_size)))
    new_edges, nodes = [], set()
    for index, (labeled_node, node_edges) in enumerate(train_indices.items()):
        if index in sampled:
            nodes.add(labeled_node)
            new_edges.append(np.asarray(node_edges))
    new_edges = (np.unique(np.concatenate(new_edges)) if new_edges
                 else np.zeros(0, np.int64))
    return new_edges, nodes


def match_labels_to_subgraph(nid: np.ndarray, sampled_nodes: set,
                             train_labels: Dict, nlabel: int, multi: bool):
    """Labeled-node targets aligned to SUBGRAPH row positions.

    The reference's correct_order_* (utils.py:515-536) aligns to the
    seed-node array instead of the subgraph rows the predictions live on —
    we align to sub['nid'] so pred[matched_index] indexes the right rows.
    Returns (matched_labels, matched_index).
    """
    labels, index = [], []
    for i, n in enumerate(nid):
        n = int(n)
        if n in sampled_nodes:
            if multi:
                row = np.zeros(nlabel, np.int64)
                row[train_labels[n]] = 1
                labels.append(row)
            else:
                labels.append(train_labels[n])
            index.append(i)
    if multi:
        labels = (np.asarray(labels, np.int64) if labels
                  else np.zeros((0, nlabel), np.int64))
    else:
        labels = np.asarray(labels, np.int64)
    return labels, np.asarray(index, np.int64)


def convert_subgraph_nids(ori: np.ndarray, nid: np.ndarray) -> np.ndarray:
    # nid is sorted ascending (subgraph relabeling), so a binary search
    # replaces the reference's numba dict loop (utils.py:554-564)
    return np.searchsorted(nid, np.asarray(ori, np.int64))


def edge_dropout(sub: Dict[str, np.ndarray], split_size: float,
                 rng=None) -> Dict[str, np.ndarray]:
    """Remove ~ (1 - split_size) * E random edges (utils.py:392-394)."""
    if split_size >= 1.0:
        return sub
    rng = rng or np.random.default_rng()
    n_e = len(sub["senders"])
    del_ids = np.unique(rng.integers(0, n_e, size=int(n_e * (1 - split_size))))
    keep = np.setdiff1d(np.arange(n_e), del_ids)
    out = dict(sub)
    for k in ("senders", "receivers", "edge_type", "rev_flag", "eids"):
        out[k] = sub[k][keep]
    return out


def compute_edgenorm(sub: Dict[str, np.ndarray], norm: str = "in") -> np.ndarray:
    """Reciprocal-degree per-edge norm with nan/inf -> finite-min quirk
    (utils.py:437-453)."""
    n = len(sub["nid"])
    in_deg = np.bincount(sub["receivers"], minlength=n).astype(np.float64)
    out_deg = np.bincount(sub["senders"], minlength=n).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        if norm == "in":
            w = 1.0 / in_deg[sub["receivers"]]
        elif norm == "out":
            w = 1.0 / out_deg[sub["senders"]]
        else:
            w = 1.0 / np.sqrt(out_deg[sub["senders"]] * in_deg[sub["receivers"]])
    bad = ~np.isfinite(w)
    if bad.any():
        w[bad] = w[~bad].min() if (~bad).any() else 1.0
    return w.astype(np.float32)[:, None]


def subgraph_degrees(sub: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    n = len(sub["nid"])
    return (np.bincount(sub["senders"], minlength=n),
            np.bincount(sub["receivers"], minlength=n))


# =============================================================================
# padding to a static envelope
# =============================================================================

def pad_subgraph(sub: Dict[str, np.ndarray], samples: np.ndarray,
                 labels: np.ndarray, v_max: int, e_max: int, s_max: int,
                 edge_norm: Optional[np.ndarray] = None,
                 send_keys: bool = True,
                 pair_keys: bool = False) -> Dict[str, np.ndarray]:
    """Pad a sampled subgraph + DistMult samples to static shapes.

    samples are (src, rel, dst) with subgraph-local node ids.  Overflow of
    the envelope raises (choose envelopes from batch size * width bounds).

    Edges are stably sorted by receiver (pad rows keep the last receiver id)
    so every device-side aggregation can claim XLA's sorted-scatter lowering
    (``indices_are_sorted=True``, ~1.4x over unsorted at V=82k) — enabled by
    ``UNCTrainModel(sorted_edges=True)``. All per-edge arrays (senders,
    receivers, edge_type, rev_flag, edge_norm) carry the same permutation;
    samples/labels index nodes, not edge positions, so they are unaffected.
    """
    n_v = len(sub["nid"])
    n_e = len(sub["senders"])
    n_s = len(samples)
    if n_v > v_max or n_e > e_max or n_s > s_max:
        raise ValueError(
            f"subgraph ({n_v}V, {n_e}E, {n_s}S) exceeds envelope "
            f"({v_max}, {e_max}, {s_max})")

    order = np.argsort(sub["receivers"], kind="stable")
    recv_fill = int(sub["receivers"][order[-1]]) if n_e else 0

    def pad1(x, n, dtype=np.int64, fill=0):
        out = np.full((n,), fill, dtype)
        out[: len(x)] = x
        return out

    out = {
        "nid": pad1(sub["nid"], v_max),
        "node_mask": np.arange(v_max) < n_v,
        "senders": pad1(sub["senders"][order], e_max),
        "receivers": pad1(sub["receivers"][order], e_max, fill=recv_fill),
        "edge_type": pad1(sub["edge_type"][order], e_max),
        "rev_flag": pad1(sub["rev_flag"][order], e_max, bool, False),
        "edge_mask": np.arange(e_max) < n_e,
        "samples": np.concatenate(
            [samples, np.zeros((s_max - n_s, 3), np.int64)], axis=0),
        "sample_mask": np.arange(s_max) < n_s,
        "labels": pad1(labels, s_max, np.float32, 0.0),
    }
    if edge_norm is not None:
        out["edge_norm"] = np.concatenate(
            [edge_norm[order], np.zeros((e_max - n_e, 1), np.float32)], axis=0)
    # Device-step accelerators, both pure functions of the arrays above
    # (profile_unc_step round 3):
    #   * out_deg: global out-degrees — computing them in-step was a
    #     3.5 ms 1-lane scatter (the model falls back to it when absent);
    #   * send_order / senders_sorted: a sender-sort permutation so the
    #     sender-side gather COTANGENT can use XLA's sorted-scatter fast
    #     path (unc.model._take_rows; pad rows sort as sender 0 and carry
    #     exactly-zero cotangents, so their placement is harmless).
    # Only the single-device TRAIN path reads the sort keys
    # (unc.model guards on `"send_order" in sub and ep_axis is None`);
    # sharded and forward-only callers pass send_keys=False to skip the
    # O(E log E) host argsort and the two dead e_max-length arrays.
    # out_deg is correct replicated (it is already the global degree).
    out["out_deg"] = np.bincount(
        sub["senders"], minlength=v_max).astype(np.float32)
    if send_keys:
        send_order = np.argsort(out["senders"], kind="stable")
        out["send_order"] = send_order
        out["senders_sorted"] = out["senders"][send_order]
    if pair_keys:
        out = add_pair_keys(out)
    return out


def add_pair_keys(padded: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fused-endpoint-gather keys (unc.model DualGraphConv): one sort
    permutation over the concatenated [2E] sender+receiver stream — its
    presence switches the layer to ONE gather / ONE sorted cotangent
    scatter per layer instead of one per endpoint."""
    pair = np.concatenate([np.asarray(padded["senders"]),
                           np.asarray(padded["receivers"])])
    pair_order = np.argsort(pair, kind="stable")
    out = dict(padded)
    # int32: both values (< V) and positions (< 2E) fit, halving the
    # per-batch host->device index transfer (gathers take i32 natively)
    out["pair_order"] = pair_order.astype(np.int32)
    out["pair_sorted"] = pair[pair_order].astype(np.int32)
    return out
