"""Relational GNN layers: RGCN and RGIN with basis / block-diagonal weights.

Reference: /root/reference/SubgraphCountingMatching/models/rgcn.py:16-212,
rgin.py:16-172.  Per edge (u --e--> v) with relation r = edge label:

    RGCN: msg = src @ W_r * norm;  out = act(agg + H @ W_loop * norm_loop + b)
    RGIN: msg = src @ W_r;         out = act(mlp(agg + H @ W_loop + b))
          (the reference applies `act` again after the MLP, rgin.py:147-152 —
          preserved here)

Weight regularizers (rgcn.py:59-78):
    basis: W_r = sum_b w_comp[r, b] * B_b           (num_bases < num_rels)
    bdd:   W_r block-diagonal with num_bases blocks of (din/nb, dout/nb)

Relation-scan aggregation: instead of gathering a per-edge
[E, D, H] weight tensor (the reference's index_select + bmm,
rgcn.py:100-122, which would materialize E*D*H floats), we use

    agg[v] = sum_r ( sum_{e->v, rel=r} src[e] * norm[e] ) @ W_r

i.e. one masked segment-sum + one dense [B,V,D]x[D,H] matmul per relation,
looped with lax.scan over stacked relation weights.  Every FLOP is a dense
matmul and peak memory stays at [B, V, D].  Edge norms factorize across the
scan: "in" multiplies at the destination after aggregation, "out" multiplies
source features before, "both" splits the square root (exact).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from .. import nn

from ..graph import GraphBatch
from ..ops.scatter import gather_nodes, scatter_sum_edges
from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, xavier_uniform
from .basemodel import GraphAdjModel
from .layers import MaskedBatchNorm, UpdateMLP
from .scm_models import MODEL_REGISTRY


def _relation_scan_agg(
    graph: GraphBatch,
    node_feat: jnp.ndarray,        # [B, V, D] (already src-norm-scaled)
    weights: jnp.ndarray,          # [R, D, H] dense or [R, nb, si, so] bdd
    bdd: bool,
) -> jnp.ndarray:
    """sum_r segment_sum(onehot_rel * src) @ W_r via lax.scan."""
    b, v, d = node_feat.shape
    senders, receivers = graph.senders, graph.receivers
    src = gather_nodes(node_feat, senders)   # [B,E,D]; matmul-transposed bwd

    def body(carry, wr_and_r):
        wr, r = wr_and_r
        sel = jnp.logical_and(graph.edge_mask, graph.edge_label == r)
        per_rel = scatter_sum_edges(src, receivers, sel, v)  # [B, V, D]
        if bdd:
            nb, si, so = wr.shape
            msg = jnp.einsum("bvks,kst->bvkt",
                             per_rel.reshape(b, v, nb, si), wr)
            msg = msg.reshape(b, v, nb * so)
        else:
            msg = per_rel @ wr
        return carry + msg, None

    num_rels = weights.shape[0]
    h_out = (weights.shape[1] * weights.shape[3] if bdd else weights.shape[2])
    init = jnp.zeros((b, v, h_out), node_feat.dtype)
    rs = jnp.arange(num_rels)
    agg, _ = jax.lax.scan(body, init, (weights, rs))
    return agg


class RelWeights(nn.Module):
    """Relation weight bank with basis/bdd regularizers (rgcn.py:59-78)."""

    num_rels: int
    input_dim: int
    hidden_dim: int
    regularizer: str = "bdd"
    num_bases: int = 4
    act: str = "relu"

    def effective_bases(self) -> int:
        if (self.regularizer == "none" or self.num_bases is None
                or self.num_bases > self.num_rels or self.num_bases <= 0):
            return self.num_rels
        return self.num_bases

    @nn.compact
    def __call__(self) -> Tuple[jnp.ndarray, bool]:
        init = xavier_uniform(calculate_gain(self.act))
        nb = self.effective_bases()
        if self.regularizer in ("none", "basis"):
            w = self.param("weight", init, (nb, self.input_dim, self.hidden_dim))
            if nb < self.num_rels:
                w_comp = self.param("w_comp", init, (self.num_rels, nb))
                w = jnp.einsum(
                    "rb,bdh->rdh", w_comp, w
                )
            return w, False
        if self.regularizer == "bdd":
            if self.input_dim % nb or self.hidden_dim % nb:
                raise ValueError(
                    f"dims must be divisible by num_bases ({nb})")
            si, so = self.input_dim // nb, self.hidden_dim // nb
            w = self.param("weight", init, (self.num_rels, nb * si * so))
            return w.reshape(self.num_rels, nb, si, so), True
        raise ValueError(f"regularizer {self.regularizer}")


class RGCNLayer(nn.Module):
    hidden_dim: int
    num_rels: int
    regularizer: str = "bdd"
    num_bases: int = 4
    edge_norm: str = "in"     # none | in | out | both
    self_loop: bool = True
    use_bias: bool = True
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, graph: GraphBatch, node_feat, train: bool = False):
        h = self.hidden_dim
        din = node_feat.shape[-1]
        init = xavier_uniform(calculate_gain(self.act))

        def recip(deg):
            if self.self_loop:
                return 1.0 / (deg + 1.0)
            # rgcn.py:141: 0-degree -> 0.0 (unlike compgcn's 1.0)
            return jnp.where(deg == 0, 0.0, 1.0 / jnp.maximum(deg, 1.0))

        innorm = recip(graph.in_degrees()) if self.edge_norm in ("in", "both") else None
        outnorm = recip(graph.out_degrees()) if self.edge_norm in ("out", "both") else None

        src_scaled = node_feat
        if self.edge_norm == "out":
            src_scaled = node_feat * outnorm[..., None]
        elif self.edge_norm == "both":
            src_scaled = node_feat * jnp.sqrt(outnorm)[..., None]

        weights, bdd = RelWeights(
            self.num_rels, din, h, self.regularizer, self.num_bases,
            self.act, name="rel_weights",
        )()
        agg = _relation_scan_agg(graph, src_scaled, weights, bdd)
        if self.edge_norm == "in":
            agg = agg * innorm[..., None]
        elif self.edge_norm == "both":
            agg = agg * jnp.sqrt(innorm)[..., None]

        out = agg
        if self.self_loop:
            w_loop = self.param("loop_weight", init, (din, h))
            loop_msg = node_feat @ w_loop
            if self.edge_norm == "in":
                loop_msg = loop_msg * innorm[..., None]
            elif self.edge_norm == "out":
                loop_msg = loop_msg * outnorm[..., None]
            elif self.edge_norm == "both":
                loop_msg = loop_msg * jnp.sqrt(innorm * outnorm)[..., None]
            out = out + loop_msg
        if self.use_bias:
            out = out + self.param("bias", nn.initializers.zeros, (h,))
        if self.batch_norm:
            out = MaskedBatchNorm(name="bn")(out, mask=graph.node_mask,
                                             train=train)
        out = map_activation_str_to_fn(self.act)(out)
        return nn.Dropout(self.dropout, name="drop")(out, deterministic=not train)


class RGINLayer(nn.Module):
    hidden_dim: int
    num_rels: int
    regularizer: str = "bdd"
    num_bases: int = 4
    num_mlp_layers: int = 2
    self_loop: bool = True
    use_bias: bool = True
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, graph: GraphBatch, node_feat, train: bool = False):
        h = self.hidden_dim
        din = node_feat.shape[-1]
        init = xavier_uniform(calculate_gain(self.act))
        weights, bdd = RelWeights(
            self.num_rels, din, h, self.regularizer, self.num_bases,
            self.act, name="rel_weights",
        )()
        out = _relation_scan_agg(graph, node_feat, weights, bdd)
        if self.self_loop:
            w_loop = self.param("loop_weight", init, (din, h))
            out = out + node_feat @ w_loop
        if self.use_bias:
            out = out + self.param("bias", nn.initializers.zeros, (h,))
        act_fn = map_activation_str_to_fn(self.act)
        if self.num_mlp_layers > 0:
            out = UpdateMLP(h, self.num_mlp_layers, self.batch_norm,
                            self.act, name="mlp")(
                out, mask=graph.node_mask, train=train)
        else:
            out = act_fn(out)
        out = act_fn(out)  # extra activation after the MLP (rgin.py:151)
        return nn.Dropout(self.dropout, name="drop")(out, deterministic=not train)


class RGNNStack(nn.Module):
    """Node-only gated residual stack (rgcn.py:254-300)."""

    kind: str  # "rgcn" | "rgin"
    num_layers: int
    hidden_dim: int
    num_rels: int
    regularizer: str = "bdd"
    num_bases: int = 4
    num_mlp_layers: int = 2
    edge_norm: str = "in"
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0
    residual: bool = True
    remat: bool = False  # jax.checkpoint each layer (memory <-> recompute)

    @nn.compact
    def __call__(self, graph: GraphBatch, v_emb, v_gate=None,
                 train: bool = False):
        v = v_emb if v_gate is None else v_emb * v_gate
        # static_argnums: 0 is the module itself, 3 is the `train` bool
        def wrap(cls):
            return nn.remat(cls, static_argnums=(3,)) if self.remat else cls
        for i in range(self.num_layers):
            if self.kind == "rgcn":
                layer = wrap(RGCNLayer)(
                    hidden_dim=self.hidden_dim, num_rels=self.num_rels,
                    regularizer=self.regularizer, num_bases=self.num_bases,
                    edge_norm=self.edge_norm, batch_norm=self.batch_norm,
                    act=self.act, dropout=self.dropout, name=f"rgcn_{i}",
                )
            else:
                layer = wrap(RGINLayer)(
                    hidden_dim=self.hidden_dim, num_rels=self.num_rels,
                    regularizer=self.regularizer, num_bases=self.num_bases,
                    num_mlp_layers=self.num_mlp_layers,
                    batch_norm=self.batch_norm,
                    act=self.act, dropout=self.dropout, name=f"rgin_{i}",
                )
            v_new = layer(graph, v, train)  # train positional: remat
            if v_gate is not None:
                v_new = v_new * v_gate
            if self.residual and v_new.shape == v.shape:
                v = v + v_new
            else:
                v = v_new
        return v


class RGCN(GraphAdjModel):
    """Relational GCN SCM model (rgcn.py:215-300)."""

    def make_rep_net(self) -> nn.Module:
        cfg = self.cfg
        return RGNNStack(
            kind="rgcn", num_layers=cfg.rep_num_graph_layers,
            hidden_dim=cfg.hid_dim, num_rels=cfg.max_ngel,
            regularizer=cfg.rep_rgcn_regularizer,
            num_bases=cfg.rep_rgcn_num_bases,
            edge_norm=cfg.rep_rgcn_edge_norm,
            batch_norm=cfg.rep_rgcn_batch_norm,
            act=cfg.rep_act_func, dropout=cfg.rep_dropout,
            residual=cfg.rep_residual, remat=cfg.rep_remat,
        )


class RGIN(GraphAdjModel):
    """Relational GIN SCM model (rgin.py:175-...)."""

    def make_rep_net(self) -> nn.Module:
        cfg = self.cfg
        return RGNNStack(
            kind="rgin", num_layers=cfg.rep_num_graph_layers,
            hidden_dim=cfg.hid_dim, num_rels=cfg.max_ngel,
            regularizer=cfg.rep_rgin_regularizer,
            num_bases=cfg.rep_rgin_num_bases,
            num_mlp_layers=cfg.rep_rgin_num_mlp_layers,
            batch_norm=cfg.rep_rgin_batch_norm,
            act=cfg.rep_act_func, dropout=cfg.rep_dropout,
            residual=cfg.rep_residual, remat=cfg.rep_remat,
        )


MODEL_REGISTRY["RGCN"] = RGCN
MODEL_REGISTRY["RGIN"] = RGIN
