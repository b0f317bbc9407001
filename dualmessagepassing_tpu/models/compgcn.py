"""Composition-based GCN layer (CompGCN).

Reference: /root/reference/SubgraphCountingMatching/models/compgcn.py:101-286.
Math per edge (u --e--> v):

    comp = comp_opt(src_feat, edge_feat)      # sub | mult | corr
    msg  = comp @ W_in   (fwd)  |  comp @ W_out  (rev)
    msg *= edge_norm (none|in|out|both)       # degree reciprocal norms
    agg_v = sum of msg at receiver
    node update: out = (agg + comp(H, loop_rel) @ W_loop) / 3   (self loop)
                 out = agg / 2                                   (no loop)
                 (+bias, [BN], act, dropout)
    edge update: E' = E @ W_rel               # plain linear on the edge stream

corr = circular correlation via rFFT (compgcn.py:213-224):
    irfft( conj(rfft(head)) * rfft(rel) )  — XLA-native jnp.fft.
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
from .layers import MaskedBatchNorm
from .scm_models import MODEL_REGISTRY
from .basemodel import GraphAdjModelV2


def comp_func(head: jnp.ndarray, relation: jnp.ndarray, comp_opt: str) -> jnp.ndarray:
    if comp_opt == "sub":
        return head - relation
    if comp_opt == "mult":
        return head * relation
    if comp_opt == "corr":
        # XLA RFFT accepts f32/f64 only; under bf16 compute (utils/amp)
        # run the correlation in f32 and return the compute dtype
        n = head.shape[-1]
        fh = jnp.fft.rfft(head.astype(jnp.float32), axis=-1)
        fr = jnp.fft.rfft(relation.astype(jnp.float32), axis=-1)
        out = jnp.fft.irfft(jnp.conj(fh) * fr, n=n, axis=-1)
        return out.astype(head.dtype)
    raise NotImplementedError(f"comp_opt {comp_opt}")


class CompGCNLayer(nn.Module):
    hidden_dim: int
    self_loop: bool = True
    comp_opt: str = "corr"
    edge_norm: str = "none"   # none | in | out | both
    use_bias: bool = True
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0
    scatter_method: Optional[str] = None

    @nn.compact
    def __call__(self, graph: GraphBatch, node_feat, edge_feat,
                 train: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
        h = self.hidden_dim
        din = node_feat.shape[-1]
        init = xavier_uniform(calculate_gain(self.act))
        w_in = self.param("in_weight", init, (din, h))
        w_out = self.param("out_weight", init, (din, h))
        w_rel = self.param("rel_weight", init, (din, h))
        if self.self_loop:
            w_loop = self.param("loop_weight", init, (din, h))
            loop_rel = self.param("loop_rel", init, (1, din))
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (h,))

        src_feat = gather_nodes(node_feat, graph.senders)
        comp = comp_func(src_feat, edge_feat, self.comp_opt)
        rev = graph.rev_flag[..., None]
        msg = jnp.where(rev, comp @ w_out, comp @ w_in)

        # degree-reciprocal norms (compgcn.py:177-209); +1 when self_loop
        if self.edge_norm != "none":
            def recip(d):
                if self.self_loop:
                    return 1.0 / (d + 1.0)
                return jnp.where(d == 0, 1.0, 1.0 / jnp.maximum(d, 1.0))
            innorm = recip(graph.in_degrees())
            outnorm = recip(graph.out_degrees())
            if self.edge_norm == "in":
                norm = jnp.take_along_axis(innorm, graph.receivers, axis=1)
            elif self.edge_norm == "out":
                norm = jnp.take_along_axis(outnorm, graph.senders, axis=1)
            else:  # both
                norm = jnp.sqrt(
                    jnp.take_along_axis(outnorm, graph.senders, axis=1)
                    * jnp.take_along_axis(innorm, graph.receivers, axis=1)
                )
            msg = msg * norm[..., None]

        agg = scatter_sum_edges(msg, graph.receivers, graph.edge_mask,
                                graph.max_nodes, method=self.scatter_method)

        if self.self_loop:
            loop_msg = comp_func(node_feat, loop_rel, self.comp_opt) @ w_loop
            out = (agg + loop_msg) * 0.3333333
        else:
            out = agg * 0.5
        if self.use_bias:
            out = out + bias
        if self.batch_norm:
            out = MaskedBatchNorm(name="bn")(out, mask=graph.node_mask,
                                             train=train)
        act_fn = map_activation_str_to_fn(self.act)
        out = act_fn(out)
        out = nn.Dropout(self.dropout, name="drop")(out, deterministic=not train)

        e_out = edge_feat @ w_rel
        return out, e_out


class CompGCNStack(nn.Module):
    """Gate/mask + masked-residual stack (compgcn.py:323-385)."""

    num_layers: int
    hidden_dim: int
    comp_opt: str = "corr"
    edge_norm: str = "none"
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0
    residual: bool = True
    scatter_method: Optional[str] = None
    remat: bool = False  # jax.checkpoint each layer (memory <-> recompute)

    @nn.compact
    def __call__(self, graph: GraphBatch, v_emb, e_emb, v_gate=None,
                 e_gate=None, train: bool = False):
        v = v_emb if v_gate is None else v_emb * v_gate
        e = e_emb if e_gate is None else e_emb * e_gate
        # static_argnums: 0 is the module itself, 4 is the `train` bool
        layer_cls = (nn.remat(CompGCNLayer, static_argnums=(4,))
                     if self.remat else CompGCNLayer)
        for i in range(self.num_layers):
            v_new, e_new = layer_cls(
                hidden_dim=self.hidden_dim, comp_opt=self.comp_opt,
                edge_norm=self.edge_norm, batch_norm=self.batch_norm,
                act=self.act, dropout=self.dropout,
                scatter_method=self.scatter_method,
                name=f"compgcn_{i}",
            )(graph, v, e, train)
            if v_gate is not None:
                v_new = v_new * v_gate
            if e_gate is not None:
                e_new = e_new * e_gate
            if self.residual and v_new.shape == v.shape and e_new.shape == e.shape:
                v, e = v + v_new, e + e_new
            else:
                v, e = v_new, e_new
        return v, e


class CompGCN(GraphAdjModelV2):
    """CompGCN SCM model (compgcn.py:289-385)."""

    def make_rep_net(self) -> nn.Module:
        cfg = self.cfg
        return CompGCNStack(
            num_layers=cfg.rep_num_graph_layers,
            hidden_dim=cfg.hid_dim,
            comp_opt=cfg.rep_compgcn_comp_opt,
            edge_norm=cfg.rep_compgcn_edge_norm,
            batch_norm=cfg.rep_compgcn_batch_norm,
            act=cfg.rep_act_func,
            dropout=cfg.rep_dropout,
            residual=cfg.rep_residual,
            remat=cfg.rep_remat,
        )


MODEL_REGISTRY["CompGCN"] = CompGCN
