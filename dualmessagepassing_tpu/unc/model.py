"""UNC models: DualGraphConv (DMPNN), CompGCN, R-GIN, R-GCN + TrainModel.

Reference: /root/reference/UnsupervisedNodeClassification/Model/DMPNN/src/
model.py (DualGraphConv 117-280, DMPNN 283-328, TrainModel 632-737) and the
CompGCN/R-GIN/R-GCN variants (Model/{CompGCN,R-GIN,R-GCN}/src/model.py).

Flat-subgraph formulation: features live on [V_max]/[E_max] padded flat
arrays with masks; aggregation is a masked scatter-add (XLA) — the large-
graph path of SURVEY §2.3.

Reference quirks preserved:
  * DualGraphConv's dropout calls discard their result (model.py:245,260) —
    update MLP outputs are NOT dropped;
  * unused nfc/efc Linear layers are NOT reproduced (they contribute no
    computation and only noise to the param count);
  * update MLP is Linear-[BN]-LeakyReLU(1/5.5)-Linear with xavier-uniform
    weights and zero biases (model.py:146-168);
  * tanh between hidden layers, no activation after the last (DMPNN
    build_hidden_layer, model.py:299-308);
  * r-bar = per-relation mean of final edge outputs (model.py:319-325).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from .. import nn

from ..constants import LEAKY_RELU_A
from ..utils.init import scaled, xavier_uniform
from ..models.layers import MaskedBatchNorm


class UNCSubgraph:
    """Thin namespace for the padded flat subgraph arrays (a dict works too;
    this documents the fields)."""


def _xavier(scale=1.0):
    return scaled(xavier_uniform(1.0), scale)


def _segment_sum_f32(msg, receivers, v, h, sorted_edges):
    """XLA scatter-add that ACCUMULATES in f32: a bf16 accumulator
    (utils/amp compute dtype) loses ~0.4% per 2^8 summands, and hub nodes
    aggregate thousands of edges. No-op for f32 inputs."""
    acc = jnp.float32 if msg.dtype == jnp.bfloat16 else msg.dtype
    agg = jnp.zeros((v, h), acc).at[receivers].add(
        msg.astype(acc), indices_are_sorted=sorted_edges)
    return agg.astype(msg.dtype)


def _take_rows(table, idx, sorted_idx: bool = False):
    """Row gather whose BACKWARD is an f32-accumulating scatter-add with
    XLA's `indices_are_sorted` fast path when the index stream is sorted.

    Autodiff's default gather transpose emits an unsorted scatter with a
    bf16 accumulator under amp. Receiver streams are sorted by
    construction (pad_subgraph / the shard builders), so the receiver
    cotangent can take the sorted path; f32 accumulation also honors the
    amp exact-count rule (hub nodes sum thousands of cotangent rows).

    Module-level custom_vjp with idx carried as a residual — a
    closure-captured traced idx leaks out of shard_map traces.
    """
    return _take_rows_p(table, idx, sorted_idx, table.shape[0],
                        jnp.dtype(table.dtype).name)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def _take_rows_p(table, idx, sorted_idx, n_rows, out_dtype):
    return table[idx]


def _take_rows_fwd(table, idx, sorted_idx, n_rows, out_dtype):
    return table[idx], idx


def _take_rows_bwd(sorted_idx, n_rows, out_dtype, idx, g):
    out = jnp.zeros((n_rows, g.shape[-1]), jnp.float32).at[idx].add(
        g.astype(jnp.float32), indices_are_sorted=sorted_idx)
    return (out.astype(out_dtype),
            np.zeros(idx.shape, jax.dtypes.float0))


_take_rows_p.defvjp(_take_rows_fwd, _take_rows_bwd)


def _take_rows_perm(table, idx, order, idx_sorted):
    """_take_rows for UNSORTED index streams with a host-precomputed sort:
    the backward permutes the cotangent rows by `order` and scatters at
    `idx_sorted = idx[order]` with the sorted fast path; XLA can fuse the
    permute into the scatter. Pad rows carry exactly-zero cotangents, so
    their position in the sort is harmless."""
    return _take_rows_perm_p(table, idx, order, idx_sorted,
                             table.shape[0], jnp.dtype(table.dtype).name)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _take_rows_perm_p(table, idx, order, idx_sorted, n_rows, out_dtype):
    return table[idx]


def _take_rows_perm_fwd(table, idx, order, idx_sorted, n_rows, out_dtype):
    return table[idx], (order, idx_sorted)


def _take_rows_perm_bwd(n_rows, out_dtype, res, g):
    order, idx_sorted = res
    gs = g.astype(jnp.float32)[order]
    out = jnp.zeros((n_rows, g.shape[-1]), jnp.float32).at[idx_sorted].add(
        gs, indices_are_sorted=True)
    zero = lambda a: np.zeros(a.shape, jax.dtypes.float0)  # noqa: E731
    return (out.astype(out_dtype), zero(idx_sorted), zero(order),
            zero(idx_sorted))


_take_rows_perm_p.defvjp(_take_rows_perm_fwd, _take_rows_perm_bwd)


def _onehot_rows(table, idx, clip: bool = False):
    """Tiny-table row lookup as one_hot(idx) @ table.

    Row selection as a matmul whose TRANSPOSE is also a matmul — the
    row-gather backward otherwise lowers to an XLA scatter of E rows
    into a handful of relation rows. Only for small tables (relations):
    the busywork is O(E * R * H). `clip` reproduces gather's out-of-bounds clamping on
    BOTH sides (XLA clamps negatives to row 0; one_hot of a negative
    would otherwise select nothing).

    Precision: exact under amp (bf16 table, one_hot rows are 0/1, f32
    accumulate). For an f32 table the dot is forced to HIGHEST precision
    so the selected rows stay bit-exact — a default-precision (TF32 or
    bf16) matmul would round the f32 master values, unlike the gather
    this replaces; the small-table FLOP cost is noise."""
    n = table.shape[0]
    if clip:
        idx = jnp.clip(idx, 0, n - 1)
    prec = ("highest" if jnp.dtype(table.dtype) == jnp.float32 else None)
    return jnp.matmul(jax.nn.one_hot(idx, n, dtype=table.dtype), table,
                      precision=prec)


def _halo_table(node_feat, sub, axis):
    """Owner-sharded gather table: [owned ; halo ; zero dump].

    `node_feat` is this shard's owned rows [Vp, H]. The halo rows are the
    boundary sender features owned by other shards, fetched with ONE
    all_to_all over the `axis` mesh axis per call (SURVEY §2.4 "graph
    partitioning / halo exchange"; exchange plan built host-side by
    parallel/halo_unc.py). Local sender indices address this table:
    0..Vp-1 owned, Vp + o*B + j the j-th boundary row from owner o, and
    Vp + n*B the zero dump row for masked edges.
    """
    send_idx = sub["send_idx"]        # [n, B] rows of MY owned slice
    send_mask = sub["send_mask"]      # [n, B]
    n, b = send_idx.shape
    h = node_feat.shape[-1]
    send = jnp.where(send_mask[..., None], node_feat[send_idx], 0.0)
    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0,
                              tiled=False)
    return jnp.concatenate(
        [node_feat, recv.reshape(n * b, h),
         jnp.zeros((1, h), node_feat.dtype)])


class UpdateMLP2(nn.Module):
    """Linear-[BN]-LeakyReLU(1/5.5)-Linear (model.py:146-168)."""

    hidden_dim: int
    batch_norm: bool = True
    ep_axis: Optional[str] = None   # shard_map axis for global BN statistics

    @nn.compact
    def __call__(self, x, mask=None, train: bool = False):
        h = self.hidden_dim
        w0 = self.param("fc0_kernel", _xavier(), (x.shape[-1], h))
        b0 = self.param("fc0_bias", nn.initializers.zeros, (h,))
        w1 = self.param("fc1_kernel", _xavier(), (h, h))
        b1 = self.param("fc1_bias", nn.initializers.zeros, (h,))
        y = x @ w0 + b0
        if self.batch_norm:
            y = MaskedBatchNorm(name="bn", axis_name=self.ep_axis)(
                y, mask=mask, train=train)
        y = jax.nn.leaky_relu(y, LEAKY_RELU_A)
        return y @ w1 + b1


class DualGraphConv(nn.Module):
    """UNC flavor of the dual message passing layer (model.py:117-280)."""

    hidden_dim: int
    init_neigenv: float = 4.0
    init_eeigenv: float = 4.0
    use_bias: bool = True
    batch_norm: bool = True
    activation: Optional[str] = None  # None | "tanh"
    dropout: float = 0.0  # kept for config parity; see module docstring
    sorted_edges: bool = False  # receivers non-decreasing (pad_subgraph sorts)
    # Edge-partitioned mode (SURVEY §2.4): edge arrays arrive sharded over
    # this shard_map axis; node features are replicated.  The only
    # collectives are one psum completing the node aggregation and one for
    # out-degrees (+ BN statistic psums when batch_norm).
    ep_axis: Optional[str] = None
    # "replicated": node state replicated, aggregation completed by psum.
    # "owner": node state owner-sharded (edges placed at their receiver's
    # owner by parallel/halo_unc.py) — aggregation is fully local, sender
    # gathers go through the per-layer halo table (_halo_table), and
    # out-degrees arrive precomputed in sub["out_deg"].
    node_sharding: str = "replicated"

    @nn.compact
    def __call__(self, sub: Dict[str, jnp.ndarray], node_feat, edge_feat,
                 edge_norm=None, train: bool = False):
        h = self.hidden_dim
        din = node_feat.shape[-1]
        n_init = _xavier(1.0 / self.init_neigenv)
        e_init = _xavier(1.0 / self.init_eeigenv)
        w_in = self.param("in_weight", n_init, (din, h))
        w_out = self.param("out_weight", n_init, (din, h))
        w_nloop = self.param("nloop_weight", n_init, (din, h))
        w_src = self.param("src_weight", e_init, (din, h))
        w_dst = self.param("dst_weight", e_init, (din, h))
        w_eloop = self.param("eloop_weight", e_init, (din, h))
        if self.use_bias:
            b_n = self.param("nbias", nn.initializers.zeros, (h,))
            b_e = self.param("ebias", nn.initializers.zeros, (h,))

        senders = sub["senders"]
        receivers = sub["receivers"]
        e_mask = sub["edge_mask"]
        rev = sub["rev_flag"][:, None]
        v = sub["node_mask"].shape[0]
        owner_sharded = self.node_sharding == "owner"

        # Under owner sharding, senders address the [owned; halo; dump]
        # table; receivers are always owned rows (0..Vp-1, pads at 0 with
        # their messages zeroed), so receiver gathers stay on node_feat's
        # index space via the same table prefix.
        table = (_halo_table(node_feat, sub, self.ep_axis)
                 if owner_sharded else node_feat)

        # global out-degrees: host-precomputed under owner sharding
        # (edges whose SENDER is owned here may live on other shards),
        # hoisted into sub by the DMPNN backbone otherwise (it is
        # identical across layers, so one narrow scatter serves them all)
        if "out_deg" in sub:
            out_deg = sub["out_deg"]
        else:
            if owner_sharded:
                # an in-step scatter would count only locally-resident
                # edges — out-edges of owned nodes live on OTHER shards
                # under owner placement, so degrees would silently
                # undercount; build_halo_sub always precomputes out_deg
                raise ValueError(
                    "owner-sharded subs must carry host-precomputed "
                    "'out_deg' (parallel/halo_unc.build_halo_sub)")
            out_deg = jnp.zeros((v,), jnp.float32).at[senders].add(
                e_mask.astype(jnp.float32))
            if self.ep_axis:
                out_deg = jax.lax.psum(out_deg, self.ep_axis)

        # ONE [Vt, 2H+1] column table — src/dst endpoint products plus the
        # log-degree column — and ONE row gather per endpoint. The naive
        # form (four [E, H] gathers + a 1-lane degree gather) pays five
        # backward scatters per layer; this pays two, with the sorted
        # fast path on the receiver side (_take_rows). The degree column
        # rides along for free (it is only READ at receivers; the
        # optimization_barrier keeps XLA from re-fusing the lane slices
        # into the gather, which made the gather itself slow on the
        # hardware this was first tuned on — unmeasured on the GPU).
        d_col = jnp.log2(1.0 + out_deg).astype(table.dtype)[:, None]
        if table.shape[0] != d_col.shape[0]:
            d_col = jnp.concatenate(
                [d_col, jnp.zeros((table.shape[0] - d_col.shape[0], 1),
                                  table.dtype)], axis=0)
        cols = jnp.concatenate([table @ w_src, table @ w_dst, d_col],
                               axis=1)
        if "pair_order" in sub and self.ep_axis is None:
            # fused endpoint gather: ONE gather over the concatenated [2E]
            # sender+receiver stream — the backward pays ONE sorted
            # cotangent scatter per layer instead of a sender scatter + a
            # receiver scatter.
            # Opted in by the pair_order/pair_sorted keys
            # (pad_subgraph(pair_keys=True), train_unc(endpoint_gather=
            # "fused")).
            n_e = senders.shape[0]
            idx2 = jnp.concatenate([senders, receivers])
            rows = _take_rows_perm(cols, idx2, sub["pair_order"],
                                   sub["pair_sorted"])
            at_send = jax.lax.optimization_barrier(rows[:n_e])
            at_recv = jax.lax.optimization_barrier(rows[n_e:])
        else:
            if "send_order" in sub and self.ep_axis is None:
                # host-precomputed sender sort (pad_subgraph): sorted fast
                # path on the sender-side cotangent scatter
                at_send = _take_rows_perm(cols, senders, sub["send_order"],
                                          sub["senders_sorted"])
            else:
                at_send = _take_rows(cols, senders)
            at_send = jax.lax.optimization_barrier(at_send)
            at_recv = _take_rows(cols, receivers,
                                 sorted_idx=self.sorted_edges)
            at_recv = jax.lax.optimization_barrier(at_recv)
        edge_msg = jnp.where(
            rev,
            at_send[:, h: 2 * h] - at_recv[:, :h],
            at_recv[:, h: 2 * h] - at_send[:, :h],
        )
        node_msg = jnp.where(rev, edge_feat @ w_out, -(edge_feat @ w_in))
        if edge_norm is not None:
            # edge_norm stays a f32 input; follow the compute dtype
            node_msg = node_msg * edge_norm.astype(node_msg.dtype)
        node_msg = jnp.where(e_mask[:, None], node_msg, 0.0)
        agg = _segment_sum_f32(node_msg, receivers, v, h, self.sorted_edges)
        if self.ep_axis and not owner_sharded:
            # owner sharding places every edge at its receiver's owner, so
            # the aggregation is complete without any collective
            agg = jax.lax.psum(agg, self.ep_axis)

        n_out = node_feat @ w_nloop + agg
        if self.use_bias:
            n_out = n_out + b_n
        n_out = UpdateMLP2(h, self.batch_norm, ep_axis=self.ep_axis,
                           name="nmlp")(
            n_out, mask=sub["node_mask"], train=train)

        # log-degree at the receiver, already gathered in the column table
        # above (f32 log2, cast to the compute dtype before the gather —
        # identical values to casting after)
        d = at_recv[:, 2 * h: 2 * h + 1].astype(edge_feat.dtype)
        add = 2.0 * (1.0 + d) * (edge_feat @ (w_src - w_dst))
        e_out = edge_feat @ w_eloop + edge_msg + add
        if self.use_bias:
            e_out = e_out + b_e
        e_out = UpdateMLP2(h, self.batch_norm, ep_axis=self.ep_axis,
                           name="emlp")(
            e_out, mask=e_mask, train=train)

        if self.activation == "tanh":
            n_out = jnp.tanh(n_out)
            e_out = jnp.tanh(e_out)
        return n_out, e_out


class UNCDMPNN(nn.Module):
    """DMPNN UNC model: node/rel embeddings + DualGraphConv stack
    (model.py:283-328). Returns (h, z, r_bar)."""

    num_nodes: int
    num_rels: int        # already doubled by the caller (TrainModel)
    h_dim: int
    out_dim: int
    num_hidden_layers: int = 1
    dropout: float = 0.0
    node_attri: Optional[Any] = None  # frozen [N, A] attributes
    multihot_input: bool = False
    sorted_edges: bool = False
    ep_axis: Optional[str] = None
    node_sharding: str = "replicated"

    @nn.compact
    def __call__(self, sub, train: bool = False):
        h, z = _input_embeddings(self, sub, rel_stream=True)

        # hoist the (layer-invariant) global out-degree so every
        # DualGraphConv reads it instead of rebuilding the scatter
        if "out_deg" not in sub and self.node_sharding != "owner":
            od = jnp.zeros((sub["node_mask"].shape[0],), jnp.float32).at[
                sub["senders"]].add(sub["edge_mask"].astype(jnp.float32))
            if self.ep_axis:
                od = jax.lax.psum(od, self.ep_axis)
            sub = dict(sub, out_deg=od)

        norm = sub.get("edge_norm")
        for i in range(self.num_hidden_layers):
            act = "tanh" if i < self.num_hidden_layers - 1 else None
            h, z = DualGraphConv(
                hidden_dim=self.out_dim, activation=act,
                dropout=self.dropout, sorted_edges=self.sorted_edges,
                ep_axis=self.ep_axis, node_sharding=self.node_sharding,
                name=f"layer_{i}",
            )(sub, h, z, edge_norm=norm, train=train)

        # per-relation mean of final edge outputs (model.py:319-325);
        # sharded edge rows -> psum partial sums/counts over 'ep'
        et = sub["edge_type"]
        em = sub["edge_mask"].astype(jnp.float32)[:, None]
        onehot = jax.nn.one_hot(et, self.num_rels, dtype=z.dtype) * em
        sums = onehot.T @ z                       # [R, H]
        cnts = onehot.sum(axis=0)[:, None]
        if self.ep_axis:
            sums = jax.lax.psum(sums, self.ep_axis)
            cnts = jax.lax.psum(cnts, self.ep_axis)
        r_bar = sums / (cnts + 1e-8)
        return h, z, r_bar

    def full_node_embeddings(self, params):
        """The learned embedding table (main.py:187 node_emb.weight)."""
        if self.node_attri is not None:
            import numpy as np
            return np.asarray(self.node_attri)
        return params["params"]["node_emb"]


class CompGraphConv(nn.Module):
    """UNC CompGCN layer (Model/CompGCN/src/model.py:117-264): corr/mult/sub
    composition, in/out weights by rev flag, 1/3 self-loop averaging, edge
    stream E @ W_rel."""

    hidden_dim: int
    comp_opt: str = "corr"
    self_loop: bool = True
    use_bias: bool = True
    batch_norm: bool = False
    activation: Optional[str] = None
    dropout: float = 0.0
    sorted_edges: bool = False
    ep_axis: Optional[str] = None
    node_sharding: str = "replicated"

    @nn.compact
    def __call__(self, sub, node_feat, edge_feat, edge_norm=None,
                 train: bool = False):
        from ..models.compgcn import comp_func

        h = self.hidden_dim
        din = node_feat.shape[-1]
        w_in = self.param("in_weight", _xavier(), (din, h))
        w_out = self.param("out_weight", _xavier(), (din, h))
        w_rel = self.param("rel_weight", _xavier(), (din, h))
        if self.self_loop:
            w_loop = self.param("loop_weight", _xavier(), (din, h))
            loop_rel = self.param("loop_rel", _xavier(), (1, din))
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (h,))

        owner_sharded = self.node_sharding == "owner"
        table = (_halo_table(node_feat, sub, self.ep_axis)
                 if owner_sharded else node_feat)
        v = sub["node_mask"].shape[0]
        comp = comp_func(_take_rows(table, sub["senders"]), edge_feat,
                         self.comp_opt)
        rev = sub["rev_flag"][:, None]
        msg = jnp.where(rev, comp @ w_out, comp @ w_in)
        if edge_norm is not None:
            msg = msg * edge_norm.astype(msg.dtype)
        msg = jnp.where(sub["edge_mask"][:, None], msg, 0.0)
        agg = _segment_sum_f32(msg, sub["receivers"], v, h,
                               self.sorted_edges)
        if self.ep_axis and not owner_sharded:
            agg = jax.lax.psum(agg, self.ep_axis)

        if self.self_loop:
            out = (agg + comp_func(node_feat, loop_rel, self.comp_opt)
                   @ w_loop) * 0.3333333
        else:
            out = agg * 0.5
        if self.use_bias:
            out = out + bias
        if self.batch_norm:
            out = MaskedBatchNorm(name="bn", axis_name=self.ep_axis)(
                out, mask=sub["node_mask"], train=train)
        if self.activation == "tanh":
            out = jnp.tanh(out)
        out = nn.Dropout(self.dropout, name="drop")(out,
                                                    deterministic=not train)
        return out, edge_feat @ w_rel


def _flat_relation_agg(sub, src_feat_e, weights, layer,
                       local_complete=False):
    """agg[v] = sum_e->v src_feat_e @ W[rel(e)] via a scan over relations
    (same matmul-shaped scheme as models/rgnn.py). Under edge
    partitioning the partial sums are completed by ONE psum after the
    scan — `local_complete` (owner sharding: edges live at their
    receiver's owner) skips it."""
    v = sub["node_mask"].shape[0]
    num_rels = weights.shape[0]
    ep_axis = layer.ep_axis

    def body(carry, wr_and_r):
        wr, r = wr_and_r
        sel = jnp.logical_and(sub["edge_mask"], sub["edge_type"] == r)
        masked = jnp.where(sel[:, None], src_feat_e, 0.0)
        partial = _segment_sum_f32(masked, sub["receivers"], v,
                                   masked.shape[-1], layer.sorted_edges)
        return carry + partial @ wr, None

    init = jnp.zeros((v, weights.shape[2]), src_feat_e.dtype)
    agg, _ = jax.lax.scan(body, init, (weights, jnp.arange(num_rels)))
    if ep_axis and not local_complete:
        agg = jax.lax.psum(agg, ep_axis)
    return agg


class RelGraphConvFlat(nn.Module):
    """dgl RelGraphConv (basis, num_bases=num_rels) on the flat subgraph:
    msg = src @ W_rel [* norm]; out = act(agg + h @ W_loop + b); used by the
    UNC R-GCN (norm applied) and as the base of RelGraphIso (norm dropped,
    R-GIN/src/model.py:150-157)."""

    hidden_dim: int
    num_rels: int
    self_loop: bool = True
    use_bias: bool = True
    activation: Optional[str] = None
    use_norm: bool = True
    iso_layer: bool = False   # RelGraphIso: extra Linear + act + dropout
    dropout: float = 0.0
    sorted_edges: bool = False
    ep_axis: Optional[str] = None
    node_sharding: str = "replicated"

    @nn.compact
    def __call__(self, sub, node_feat, edge_norm=None, train: bool = False):
        h = self.hidden_dim
        din = node_feat.shape[-1]
        weights = self.param("weight", _xavier(), (self.num_rels, din, h))
        owner_sharded = self.node_sharding == "owner"
        table = (_halo_table(node_feat, sub, self.ep_axis)
                 if owner_sharded else node_feat)
        src = _take_rows(table, sub["senders"])
        if self.use_norm and edge_norm is not None:
            src = src * edge_norm.astype(src.dtype)
        out = _flat_relation_agg(sub, src, weights, self,
                                 local_complete=owner_sharded)
        if self.self_loop:
            out = out + node_feat @ self.param("loop_weight", _xavier(),
                                               (din, h))
        if self.use_bias:
            out = out + self.param("bias", nn.initializers.zeros, (h,))
        drop = nn.Dropout(self.dropout, name="drop")
        if self.iso_layer:
            out = Dense_(h, name="out_layer")(out)
        if self.activation == "tanh":
            out = jnp.tanh(out)
        return drop(out, deterministic=not train)


class Dense_(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        w = self.param("kernel", scaled(xavier_uniform(jnp.sqrt(2.0)), 1.0),
                       (x.shape[-1], self.features))
        b = self.param("bias", nn.initializers.zeros, (self.features,))
        return x @ w + b


class UNCCompGCN(nn.Module):
    """CompGCN UNC backbone (Model/CompGCN/src/model.py:267-305).
    Returns (h, r) — relation stream transformed per layer."""

    num_nodes: int
    num_rels: int
    h_dim: int
    out_dim: int
    num_hidden_layers: int = 1
    dropout: float = 0.0
    node_attri: Optional[Any] = None
    multihot_input: bool = False
    sorted_edges: bool = False
    ep_axis: Optional[str] = None
    node_sharding: str = "replicated"

    @nn.compact
    def __call__(self, sub, train: bool = False):
        h, z = _input_embeddings(self, sub, rel_stream=True)
        norm = sub.get("edge_norm")
        for i in range(self.num_hidden_layers):
            act = "tanh" if i < self.num_hidden_layers - 1 else None
            h, z = CompGraphConv(
                hidden_dim=self.out_dim, comp_opt="corr", activation=act,
                dropout=self.dropout, sorted_edges=self.sorted_edges,
                ep_axis=self.ep_axis, node_sharding=self.node_sharding,
                name=f"layer_{i}",
            )(sub, h, z, edge_norm=norm, train=train)
        return h, z


class UNCRGNN(nn.Module):
    """R-GCN / R-GIN UNC backbones (Model/R-GCN,R-GIN/src/model.py).
    Returns h only."""

    kind: str  # "rgcn" | "rgin"
    num_nodes: int
    num_rels: int
    h_dim: int
    out_dim: int
    num_hidden_layers: int = 1
    dropout: float = 0.0
    node_attri: Optional[Any] = None
    multihot_input: bool = False
    sorted_edges: bool = False
    ep_axis: Optional[str] = None
    node_sharding: str = "replicated"

    @nn.compact
    def __call__(self, sub, train: bool = False):
        h, _ = _input_embeddings(self, sub, rel_stream=False)
        norm = sub.get("edge_norm")
        for i in range(self.num_hidden_layers):
            act = "tanh" if i < self.num_hidden_layers - 1 else None
            h = RelGraphConvFlat(
                hidden_dim=self.out_dim, num_rels=self.num_rels,
                activation=act, dropout=self.dropout,
                use_norm=(self.kind == "rgcn"),
                iso_layer=(self.kind == "rgin"),
                sorted_edges=self.sorted_edges,
                ep_axis=self.ep_axis, node_sharding=self.node_sharding,
                name=f"layer_{i}",
            )(sub, h, edge_norm=norm, train=train)
        return (h,)


def _input_embeddings(mdl, sub, rel_stream: bool):
    """Shared input layer: EmbeddingLayer (learned uniform 1/sqrt(d)),
    EmbeddingLayerAttri (frozen attributes), or MultiHotEmbeddingLayer
    (frozen multihot encoding x learned projection, scale
    1/sqrt(d * enc_len) — Model/DMPNN/src/model.py:12-64)."""
    from ..utils.amp import compute_dtype

    if mdl.node_attri is not None:
        # frozen attribute table follows the trace-time compute dtype so
        # bf16 runs (utils/amp) start bf16 at the input
        h = jnp.asarray(mdl.node_attri, dtype=compute_dtype())[sub["nid"]]
    elif getattr(mdl, "multihot_input", False):
        from ..ops.encoding import get_enc_len, multihot_table

        enc_len = get_enc_len(mdl.num_nodes - 1, 2)
        table = jnp.asarray(multihot_table(mdl.num_nodes, 2),
                            dtype=compute_dtype())
        scale = 1.0 / jnp.sqrt(jnp.asarray(float(mdl.h_dim * enc_len)))
        proj = mdl.param(
            "node_emb_proj",
            lambda k, s: jax.random.uniform(k, s, jnp.float32, -1, 1) * scale,
            (enc_len * 2, mdl.h_dim))
        h = table[sub["nid"]] @ proj
    else:
        emb = mdl.param(
            "node_emb",
            lambda k, s: jax.random.uniform(
                k, s, jnp.float32, -1, 1) / jnp.sqrt(float(mdl.h_dim)),
            (mdl.num_nodes, mdl.h_dim))
        h = emb[sub["nid"]]
    z = None
    if rel_stream:
        rel_emb = mdl.param(
            "rel_emb",
            lambda k, s: jax.random.uniform(
                k, s, jnp.float32, -1, 1) / jnp.sqrt(float(mdl.h_dim)),
            (mdl.num_rels, mdl.h_dim))
        # one_hot @ table: exact, and the backward is a matmul instead of
        # an [E]-rows-into-[2R] XLA scatter (3.5 ms at the Yelp envelope)
        z = _onehot_rows(rel_emb, sub["edge_type"])
    return h, z


class UNCTrainModel(nn.Module):
    """DistMult link prediction / supervised head around the GNN
    (model.py:632-737)."""

    num_nodes: int
    num_rels: int        # ORIGINAL count; model uses num_rels * 2
    h_dim: int
    nlabel: int = 0
    num_hidden_layers: int = 1
    dropout: float = 0.0
    reg_param: float = 0.0
    node_attri: Optional[Any] = None
    backbone: str = "DMPNN"
    multi: bool = False
    multihot_input: bool = False
    # pad_subgraph sorts edges by receiver, so aggregations can claim
    # indices_are_sorted=True. Default stays False because correctness then depends on the CALLER's edge order (the
    # hint silently corrupts aggregation on unsorted input); the drivers,
    # whose pipeline always sorts, enable it. Edge-partitioned shards of a
    # globally sorted stream remain sorted, so the flag composes with
    # ep_axis.
    sorted_edges: bool = False
    # Edge-partitioned execution (SURVEY §2.4): set to the shard_map axis
    # name when the model runs with edge arrays sharded across devices
    # (parallel/ep_unc.py). Node features stay replicated; every partial
    # edge-reduction (aggregation, degrees, BN stats, per-relation means,
    # edge-stream regularizer sums) is completed with a psum over this axis.
    ep_axis: Optional[str] = None
    # Node-state placement under ep_axis. "replicated" is the full-psum
    # path above; "owner" is the halo-exchange path (parallel/halo_unc.py):
    # node rows are partitioned by owner, every edge lives at its
    # receiver's owner (local aggregation, no per-layer psum), each layer
    # exchanges only boundary sender rows with one all_to_all, and the
    # DistMult/supervised losses all_gather the final [Vp, H] node outputs
    # once to score samples addressed by packed ids (owner * Vp + rank).
    node_sharding: str = "replicated"

    def setup(self):
        if self.node_sharding == "owner" and self.nlabel > 0:
            # supervised_loss indexes the all_gathered packed table
            # (owner * Vp + rank); matched_index is only remapped by the
            # unsupervised halo builder — fail loudly instead of training
            # on silently-wrong rows
            raise NotImplementedError(
                "supervised head under node_sharding='owner' requires "
                "matched_index remapped to packed ids; use the "
                "replicated ep path or single-device for supervised runs")
        i_dim = (self.h_dim if self.node_attri is None
                 else self.node_attri.shape[1])
        kw = dict(num_nodes=self.num_nodes, num_rels=self.num_rels * 2,
                  h_dim=i_dim, out_dim=self.h_dim,
                  num_hidden_layers=self.num_hidden_layers,
                  dropout=self.dropout, node_attri=self.node_attri,
                  multihot_input=self.multihot_input,
                  sorted_edges=self.sorted_edges,
                  ep_axis=self.ep_axis,
                  node_sharding=self.node_sharding,
)
        if self.backbone == "DMPNN":
            self.model = UNCDMPNN(**kw)
        elif self.backbone == "CompGCN":
            self.model = UNCCompGCN(**kw)
        elif self.backbone in ("RGCN", "RGIN"):
            self.model = UNCRGNN(kind=self.backbone.lower(), **kw)
        else:
            raise NotImplementedError(self.backbone)
        # the reference only creates w_relation in the unsupervised branch
        # (model.py:653-661) yet its supervised regularizer still references
        # it — an unreachable-in-practice AttributeError; we create it in
        # both modes so the shared regularizer is well-defined
        self.w_relation = self.param(
            "w_relation",
            xavier_uniform(jnp.sqrt(2.0)),  # gain('relu')
            (self.num_rels, self.h_dim))
        if self.nlabel > 0:
            self.node_fc = nn.Dense(
                self.nlabel, kernel_init=xavier_uniform(1.0),
                bias_init=nn.initializers.zeros, name="node_fc")
        self.edge_fc = nn.Dense(
            self.h_dim, kernel_init=xavier_uniform(1.0),
            bias_init=nn.initializers.zeros, name="edge_fc")

    def __call__(self, sub, train: bool = False):
        out = self.model(sub, train=train)
        pred = self.node_fc(out[0]) if self.nlabel > 0 else None
        return out, pred

    def _full_rows(self, x):
        """Owner-sharded mode: all_gather the per-shard node rows so packed
        ids (owner * Vp + rank, built by parallel/halo_unc.py) address the
        full [n*Vp, ...] table. No-op in replicated mode."""
        if self.node_sharding == "owner" and self.ep_axis:
            return jax.lax.all_gather(x, self.ep_axis, axis=0, tiled=True)
        return x

    def calc_score(self, node_emb, triplets):
        s = node_emb[triplets[:, 0]]
        r = _onehot_rows(self.w_relation, triplets[:, 1])
        o = node_emb[triplets[:, 2]]
        return jnp.sum(s * r * o, axis=1)

    def regularization(self, embedding, edge_type=None, edge_mask=None,
                       node_mask=None):
        """mean(w_rel^2) + sum_i mean(emb_i^2) + edge_fc alignment for the
        edge stream (model.py:691-715). The reference tensors are unpadded,
        so our means run over mask-valid rows only. The backbone output
        tuple is positional — 0: node rows, 1: edge rows, 2: per-relation
        means — and masks are associated positionally (the reference's
        size(0)-matching is the same association on unpadded shapes, but
        under padded/sharded envelopes leading dims can collide, e.g.
        Vp == 2*num_rels)."""
        reg = jnp.mean(self.w_relation ** 2)  # replicated params: no psum
        if not isinstance(embedding, (tuple, list)):
            embedding = (embedding,)

        def _psum(v):
            return jax.lax.psum(v, self.ep_axis) if self.ep_axis else v

        # psum-both-numerator-and-denominator is correct for sharded edge
        # streams AND replicated node/relation streams (factor cancels)
        masks = (node_mask, edge_mask, None)
        for emb, mask in zip(embedding, masks):
            reg = reg + _masked_mean_sq(emb, mask, psum=_psum)
        if edge_type is not None and len(embedding) > 1:
            emb = embedding[1]  # the per-edge stream (z)
            mask = jnp.logical_and(
                edge_type < self.num_rels,
                edge_mask if edge_mask is not None else True)
            diff = self.edge_fc(emb) - _onehot_rows(
                self.w_relation, edge_type, clip=True)
            sq = jnp.sum(diff ** 2, axis=1)
            cnt = jnp.maximum(_psum(jnp.sum(mask)), 1)
            reg = reg + _psum(jnp.sum(jnp.where(mask, sq, 0.0))) / (
                cnt * self.h_dim)
        return reg

    def unsupervised_loss(self, embedding, edge_type, edge_mask, samples,
                          labels, sample_mask, node_mask=None):
        score = self.calc_score(self._full_rows(embedding[0]), samples)
        bce = optax_sigmoid_bce(score, labels)
        cnt = jnp.maximum(jnp.sum(sample_mask), 1)
        predict_loss = jnp.sum(jnp.where(sample_mask, bce, 0.0)) / cnt
        reg = self.regularization(embedding, edge_type, edge_mask, node_mask)
        return predict_loss + self.reg_param * reg

    def supervised_loss(self, embedding, edge_type, edge_mask, pred,
                        matched_labels, matched_index, matched_mask, multi):
        p = self._full_rows(pred)[matched_index]
        if multi:
            logp = jax.nn.log_sigmoid(p)
            log1mp = jax.nn.log_sigmoid(-p)
            bce = -(matched_labels * logp + (1 - matched_labels) * log1mp)
            per = jnp.mean(bce, axis=1)
        else:
            logits = jax.nn.log_softmax(p, axis=-1)
            per = -jnp.take_along_axis(
                logits, matched_labels[:, None].astype(jnp.int32), axis=1)[:, 0]
        cnt = jnp.maximum(jnp.sum(matched_mask), 1)
        predict_loss = jnp.sum(jnp.where(matched_mask, per, 0.0)) / cnt
        reg = self.regularization(embedding, edge_type, edge_mask)
        return predict_loss + self.reg_param * reg  # node_mask via kwargs


def apply_unc_forward(model: "UNCTrainModel", params, batch_stats, sub,
                      dropout_rng, amp: bool = False, train: bool = True):
    """Forward apply shared by every UNC train-step maker (single-device,
    ep-psum, halo), with optional bf16 mixed precision.

    amp=True casts params to bf16 at the boundary and runs the backbone
    under utils/amp's trace-time compute dtype (frozen tables and norm/
    degree pins follow it); outputs come back cast to f32 so the DistMult
    score, regularizers, and supervised head run in f32 against the
    MASTER params. Aggregation accumulators and BatchNorm statistics stay
    f32 inside the model (_segment_sum_f32, MaskedBatchNorm).

    Returns ((out_tuple, pred), new_batch_stats)."""
    if amp:
        from ..utils.amp import cast_floats, compute_dtype_scope

        with compute_dtype_scope(jnp.bfloat16):
            variables = {"params": cast_floats(params, jnp.bfloat16)}
            if batch_stats:
                variables["batch_stats"] = batch_stats
            (out, pred), mutated = model.apply(
                variables, sub, train=train, mutable=["batch_stats"],
                rngs={"dropout": dropout_rng})
        out = cast_floats(out, jnp.float32)
        pred = cast_floats(pred, jnp.float32)
    else:
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        (out, pred), mutated = model.apply(
            variables, sub, train=train, mutable=["batch_stats"],
            rngs={"dropout": dropout_rng})
    return (out, pred), mutated.get("batch_stats", {})


def init_unc_variables(model: "UNCTrainModel", key, sub):
    """Initialize ALL parameters, including the loss-path-only edge_fc /
    w_relation / node_fc (the module layer creates lazily only what a traced
    method touches).

    The init itself is jitted: an un-jitted init dispatches every op
    eagerly, one device launch each."""

    if model.nlabel == 0:
        def full(mdl, sub):
            out, pred = mdl(sub, train=False)
            return mdl.unsupervised_loss(
                out, sub["edge_type"], sub["edge_mask"], sub["samples"],
                sub["labels"], sub["sample_mask"], sub["node_mask"])
    else:
        def full(mdl, sub):
            out, pred = mdl(sub, train=False)
            ml = (jnp.zeros((1, model.nlabel), jnp.float32) if model.multi
                  else jnp.zeros((1,), jnp.int32))
            return mdl.supervised_loss(
                out, sub["edge_type"], sub["edge_mask"], pred, ml,
                jnp.zeros((1,), jnp.int32), jnp.zeros((1,), bool),
                model.multi)

    return jax.jit(lambda k, s: model.init(k, s, method=full))(key, sub)


def _masked_mean_sq(x, mask, psum=lambda v: v):
    if mask is None:
        return psum(jnp.sum(x ** 2)) / jnp.maximum(
            psum(jnp.asarray(float(x.size))), 1.0)
    m = mask.astype(x.dtype)[:, None]
    return psum(jnp.sum((x ** 2) * m)) / jnp.maximum(
        psum(m.sum() * x.shape[-1]), 1.0)


def optax_sigmoid_bce(logits, labels):
    """binary_cross_entropy_with_logits, elementwise."""
    return jnp.maximum(logits, 0) - logits * labels + jnp.log1p(
        jnp.exp(-jnp.abs(logits)))
