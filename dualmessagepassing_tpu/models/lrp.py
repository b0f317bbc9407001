"""LRP / DMPLRP: local relational pooling models.

Reference: /root/reference/SubgraphCountingMatching/models/lrp.py:18-214,
dmplrp.py:19-330.  The reference materializes block-diagonal torch.sparse
perm matrices at collate time and runs spmm per layer (lrp.py:66,73); our
static-shape form replaces each spmm with gathers + S (or S^2) dense
matmuls over fixed-size perm index tensors (data/lrp.py):

  perm_feat[p, :] = sum_i  h[node(p, i)] @ W[:, :, i, i]
                  + sum_ij e[edge(p, i, j)] @ W[:, :, i, j] (cells with edges)

followed by mean pooling over each node's perms (segment scatter by owner)
— numerically identical to N2P/E2P spmm + 'dab,bca->dc' einsum + pool.

Loops run over the S (and S^2) grid positions, keeping peak memory at
[B, P, D] while every FLOP is a dense [B*P, D] x [D, H] matmul.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from .. import nn
from ..nn import struct

from ..graph import GraphBatch
from ..ops.scatter import scatter_sum_edges
from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, scaled, xavier_uniform
from .basemodel import GraphAdjModelV2
from .layers import Dense, MaskedBatchNorm, UpdateMLP
from .scm_models import MODEL_REGISTRY


@struct.dataclass
class LRPGraphBatch(GraphBatch):
    """GraphBatch + fixed-size perm index tensors (data/lrp.py)."""

    perm_node: jnp.ndarray = None       # [B, P, S] int32
    perm_node_mask: jnp.ndarray = None  # [B, P, S] bool
    perm_edge: jnp.ndarray = None       # [B, P, S, S] int32
    perm_edge_mask: jnp.ndarray = None  # [B, P, S, S] bool
    perm_owner: jnp.ndarray = None      # [B, P] int32
    perm_mask: jnp.ndarray = None       # [B, P] bool


def perm_project(graph: LRPGraphBatch, node_feat, edge_feat, weight,
                 seq_len: int):
    """The N2P/E2P + einsum('dab,bca->dc') core. weight: [D, H, S*S]."""
    b, p, s = graph.perm_node.shape
    d = node_feat.shape[-1]
    w = weight.reshape(d, -1, s, s)
    out = 0.0
    # diagonal (node) cells
    for i in range(s):
        idx = graph.perm_node[:, :, i]                      # [B, P]
        feat = jnp.take_along_axis(node_feat, idx[..., None], axis=1)
        feat = feat * graph.perm_node_mask[:, :, i, None]
        out = out + feat @ w[:, :, i, i]
    # edge cells
    for i in range(s):
        for j in range(s):
            m = graph.perm_edge_mask[:, :, i, j]
            idx = graph.perm_edge[:, :, i, j]
            feat = jnp.take_along_axis(edge_feat, idx[..., None], axis=1)
            feat = feat * m[..., None]
            out = out + feat @ w[:, :, i, j]
    return out  # [B, P, H]


def perm_mean_pool(graph: LRPGraphBatch, perm_feat):
    """Mean over each node's perms (build_perm_pooling_matrix 'mean',
    dataset.py:1799-1814)."""
    summed = scatter_sum_edges(perm_feat, graph.perm_owner, graph.perm_mask,
                               graph.max_nodes, method="segment")
    counts = scatter_sum_edges(
        jnp.ones(graph.perm_mask.shape + (1,), perm_feat.dtype),
        graph.perm_owner, graph.perm_mask, graph.max_nodes, method="segment")
    return summed / jnp.maximum(counts, 1.0)


class LRPLayer(nn.Module):
    """Perm-pooling layer (lrp.py:18-96); edge stream passthrough."""

    hidden_dim: int
    lrp_seq_len: int = 4
    use_bias: bool = True
    batch_norm: bool = False
    use_mlp: bool = False
    act: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, graph: LRPGraphBatch, node_feat, edge_feat,
                 train: bool = False):
        h = self.hidden_dim
        d = node_feat.shape[-1]
        s = self.lrp_seq_len
        gain = calculate_gain(self.act)
        act_fn = map_activation_str_to_fn(self.act)
        w = self.param("weight", xavier_uniform(gain), (d, h, s * s))
        out = perm_project(graph, node_feat, edge_feat, w, s)
        if self.use_bias:
            out = out + self.param("bias", nn.initializers.zeros, (h,))
        out = act_fn(out)
        out = perm_mean_pool(graph, out)
        deg = graph.in_degrees()[..., None]
        factor = Dense(h, init="uniform", activation=self.act,
                       name="degnet_1")(
            act_fn(Dense(2 * h, init="uniform", activation=self.act,
                         name="degnet_0")(deg)))
        out = act_fn(out * factor)
        if self.batch_norm:
            out = MaskedBatchNorm(name="bn")(out, mask=graph.node_mask,
                                             train=train)
        if self.use_mlp:
            out = act_fn(Dense(h, init="uniform", activation=self.act,
                               name="mlp")(out))
        out = nn.Dropout(self.dropout, name="drop")(out, deterministic=not train)
        return out, edge_feat


class DMPLRPPoolLayer(nn.Module):
    """DMPLayer message passing + LRP perm pooling on the node stream
    (dmplrp.py:19-198)."""

    hidden_dim: int
    lrp_seq_len: int = 4
    init_neigenv: float = 4.0
    init_eeigenv: float = 4.0
    use_bias: bool = True
    num_mlp_layers: int = 2
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, graph: LRPGraphBatch, node_feat, edge_feat,
                 train: bool = False):
        from .dmpnn import DMPLayer  # same math, reused

        h = self.hidden_dim
        d = node_feat.shape[-1]
        s = self.lrp_seq_len
        v_out, e_out = DMPLayer(
            hidden_dim=h, init_neigenv=self.init_neigenv,
            init_eeigenv=self.init_eeigenv, use_bias=self.use_bias,
            num_mlp_layers=self.num_mlp_layers, batch_norm=self.batch_norm,
            act=self.act, dropout=self.dropout, name="dmp",
        )(graph, node_feat, edge_feat, train=train)
        # lrp projection of the updated streams (dmplrp.py:182-188)
        w = self.param("lrp_weight", xavier_uniform(1.0), (h, h, s * s))
        out = perm_project(graph, v_out, e_out, w, s)
        if self.use_bias:
            out = out + self.param("lrp_bias", nn.initializers.zeros, (h,))
        out = perm_mean_pool(graph, out)
        return out, e_out


class LRPStack(nn.Module):
    """LRP stack — NOTE: the reference never applies residuals here even when
    rep_residual is set (lrp.py:161-167 appends v, not v_prev + v)."""

    num_layers: int
    hidden_dim: int
    lrp_seq_len: int = 4
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0
    residual: bool = False  # parity: always False for LRP

    @nn.compact
    def __call__(self, graph: LRPGraphBatch, v_emb, e_emb, v_gate=None,
                 e_gate=None, train: bool = False):
        v = v_emb if v_gate is None else v_emb * v_gate
        e = e_emb if e_gate is None else e_emb * e_gate
        for i in range(self.num_layers):
            v_new, e_new = LRPLayer(
                hidden_dim=self.hidden_dim, lrp_seq_len=self.lrp_seq_len,
                batch_norm=self.batch_norm, act=self.act,
                dropout=self.dropout, name=f"lrp_{i}",
            )(graph, v, e, train=train)
            if v_gate is not None:
                v_new = v_new * v_gate
            if e_gate is not None:
                e_new = e_new * e_gate
            v, e = v_new, e_new
        return v, e


class DMPLRPStack(nn.Module):
    """DMPLRP stack with gated masked residuals (dmplrp.py:262-330)."""

    num_layers: int
    hidden_dim: int
    lrp_seq_len: int = 4
    init_neigenv: float = 4.0
    init_eeigenv: float = 4.0
    num_mlp_layers: int = 2
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0
    residual: bool = True

    @nn.compact
    def __call__(self, graph: LRPGraphBatch, v_emb, e_emb, v_gate=None,
                 e_gate=None, train: bool = False):
        v = v_emb if v_gate is None else v_emb * v_gate
        e = e_emb if e_gate is None else e_emb * e_gate
        for i in range(self.num_layers):
            v_new, e_new = DMPLRPPoolLayer(
                hidden_dim=self.hidden_dim, lrp_seq_len=self.lrp_seq_len,
                init_neigenv=self.init_neigenv,
                init_eeigenv=self.init_eeigenv,
                num_mlp_layers=self.num_mlp_layers,
                batch_norm=self.batch_norm, act=self.act,
                dropout=self.dropout, name=f"dmplrp_{i}",
            )(graph, v, e, train=train)
            if v_gate is not None:
                v_new = v_new * v_gate
            if e_gate is not None:
                e_new = e_new * e_gate
            if self.residual and v_new.shape == v.shape and e_new.shape == e.shape:
                v, e = v + v_new, e + e_new
            else:
                v, e = v_new, e_new
        return v, e


class LRP(GraphAdjModelV2):
    def make_rep_net(self) -> nn.Module:
        cfg = self.cfg
        return LRPStack(
            num_layers=cfg.rep_num_graph_layers, hidden_dim=cfg.hid_dim,
            lrp_seq_len=cfg.lrp_seq_len, batch_norm=cfg.rep_lrp_batch_norm,
            act=cfg.rep_act_func, dropout=cfg.rep_dropout,
        )


class DMPLRP(GraphAdjModelV2):
    def make_rep_net(self) -> nn.Module:
        cfg = self.cfg
        return DMPLRPStack(
            num_layers=cfg.rep_num_graph_layers, hidden_dim=cfg.hid_dim,
            lrp_seq_len=cfg.lrp_seq_len,
            init_neigenv=cfg.init_neigenv, init_eeigenv=cfg.init_eeigenv,
            num_mlp_layers=cfg.rep_dmpnn_num_mlp_layers,
            batch_norm=cfg.rep_dmpnn_batch_norm,
            act=cfg.rep_act_func, dropout=cfg.rep_dropout,
            residual=cfg.rep_residual,
        )


MODEL_REGISTRY["LRP"] = LRP
MODEL_REGISTRY["DMPLRP"] = DMPLRP
