"""Dual message passing layer (DMPLayer) — the core algorithmic object.

Static-shape re-design of the reference layer
(/root/reference/SubgraphCountingMatching/models/dmpnn.py:16-176).  Math, per
edge (u --e--> v), with forward/reversed handled by select on rev_flag
(dmpnn.py:111-127):

  node stream message (summed at the receiver v):
      fwd:  -E_e @ W_in          rev:  +E_e @ W_out
  edge stream message (stored per edge, no reduction):
      fwd:   H_v @ W_dst - H_u @ W_src
      rev:   H_u @ W_dst - H_v @ W_src
  node update (dmpnn.py:129-140):
      H'_v = MLP( H_v @ W_nloop + agg_v + b_n )
  edge update (dmpnn.py:142-156), d = log2(1 + outdeg(v)):
      E'_e = MLP( E_e @ W_eloop + 2*(1+d) * E_e @ (W_src - W_dst)
                  + edge_msg_e + b_e )

Eigenvalue reparameterization (dmpnn.py:79-86): W_in/W_out/W_nloop divided by
init_neigenv and W_src/W_dst/W_eloop by init_eeigenv at init — folded into
the initializer here.

XLA mapping: the six weight matmuls are hoisted to node/edge level (dense
[B,V,H]x[H,H] / [B,E,H]x[H,H] batched matmuls), per-edge terms are
gathers of those products, and the node aggregation is a masked segment-sum
(one-hot einsum for SCM envelopes; scatter-add for large graphs).
XLA fuses the elementwise glue; there is no per-edge UDF interpreter.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from .. import nn

from ..graph import GraphBatch
from ..ops.scatter import gather_nodes, gather_scalars, scatter_sum_edges
from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, scaled, xavier_uniform
from .layers import UpdateMLP


class DMPLayer(nn.Module):
    """One dual-message-passing layer over a padded GraphBatch."""

    hidden_dim: int
    init_neigenv: float = 4.0
    init_eeigenv: float = 4.0
    use_bias: bool = True
    num_mlp_layers: int = 2
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0
    scatter_method: Optional[str] = None  # None = auto (onehot for small V)

    @nn.compact
    def __call__(
        self,
        graph: GraphBatch,
        node_feat: jnp.ndarray,  # [B, V, Din]
        edge_feat: jnp.ndarray,  # [B, E, Din]
        train: bool = False,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        h = self.hidden_dim
        din = node_feat.shape[-1]
        gain = calculate_gain(self.act)
        n_init = scaled(xavier_uniform(gain), 1.0 / self.init_neigenv)
        e_init = scaled(xavier_uniform(gain), 1.0 / self.init_eeigenv)

        w_in = self.param("in_weight", n_init, (din, h))
        w_out = self.param("out_weight", n_init, (din, h))
        w_nloop = self.param("nloop_weight", n_init, (din, h))
        w_src = self.param("src_weight", e_init, (din, h))
        w_dst = self.param("dst_weight", e_init, (din, h))
        w_eloop = self.param("eloop_weight", e_init, (din, h))
        if self.use_bias:
            b_n = self.param("nbias", nn.initializers.zeros, (h,))
            b_e = self.param("ebias", nn.initializers.zeros, (h,))

        senders, receivers = graph.senders, graph.receivers
        e_mask = graph.edge_mask
        rev = graph.rev_flag[..., None]  # [B, E, 1]

        # ---- hoisted matmuls ------------------------------------------------
        # one fused [Din, 2H] product so each edge endpoint needs ONE gather
        hw = node_feat @ jnp.concatenate([w_src, w_dst], axis=1)  # [B, V, 2H]
        ew_in = edge_feat @ w_in      # [B, E, H]
        ew_out = edge_feat @ w_out    # [B, E, H]

        # ---- per-edge messages (gather + select) ----------------------------
        # gathers share the scatter backend choice: the one-hot form has
        # a matmul transpose, keeping the backward scatter-free (scatter.py)
        src_w = gather_nodes(hw, senders, method=self.scatter_method)
        dst_w = gather_nodes(hw, receivers, method=self.scatter_method)
        src_wsrc, src_wdst = src_w[..., :h], src_w[..., h:]
        dst_wsrc, dst_wdst = dst_w[..., :h], dst_w[..., h:]

        edge_msg = jnp.where(rev, src_wdst - dst_wsrc, dst_wdst - src_wsrc)
        node_msg = jnp.where(rev, ew_out, -ew_in)

        # ---- node aggregation (segment-sum at receivers) --------------------
        agg = scatter_sum_edges(
            node_msg, receivers, e_mask, graph.max_nodes, method=self.scatter_method
        )

        # ---- node update ----------------------------------------------------
        v_out = node_feat @ w_nloop + agg
        if self.use_bias:
            v_out = v_out + b_n
        if self.num_mlp_layers > 0:
            v_out = UpdateMLP(
                h, self.num_mlp_layers, self.batch_norm, self.act, name="nmlp"
            )(v_out, mask=graph.node_mask, train=train)
        else:
            v_out = map_activation_str_to_fn(self.act)(v_out)
        v_out = nn.Dropout(self.dropout, name="ndrop")(v_out, deterministic=not train)

        # ---- edge update ----------------------------------------------------
        out_deg = graph.out_degrees()                         # [B, V]
        d = gather_scalars(out_deg, receivers,
                           method=self.scatter_method)        # outdeg at dst
        # degrees are f32 (exact counts); cast so bf16 compute (utils/amp)
        # is not silently promoted back through the edge stream
        d = jnp.log2(1.0 + d)[..., None].astype(edge_feat.dtype)
        add = 2.0 * (1.0 + d) * (edge_feat @ (w_src - w_dst))
        e_out = edge_feat @ w_eloop + add + edge_msg
        if self.use_bias:
            e_out = e_out + b_e
        if self.num_mlp_layers > 0:
            e_out = UpdateMLP(
                h, self.num_mlp_layers, self.batch_norm, self.act, name="emlp"
            )(e_out, mask=e_mask, train=train)
        else:
            e_out = map_activation_str_to_fn(self.act)(e_out)
        e_out = nn.Dropout(self.dropout, name="edrop")(e_out, deterministic=not train)

        return v_out, e_out


class DMPNNStack(nn.Module):
    """A stack of DMPLayers with per-layer gate/mask multiply + masked residual.

    Mirrors DMPNN.get_pattern_rep / get_graph_rep (dmpnn.py:215-277): inputs
    are gated (mask * gate) before the first layer; every layer output is
    re-gated; residual connections are added when enabled and shapes match.
    """

    num_layers: int
    hidden_dim: int
    init_neigenv: float = 4.0
    init_eeigenv: float = 4.0
    num_mlp_layers: int = 2
    batch_norm: bool = False
    act: str = "relu"
    dropout: float = 0.0
    residual: bool = True
    scatter_method: Optional[str] = None
    remat: bool = False  # jax.checkpoint each layer (memory <-> recompute)

    @nn.compact
    def __call__(
        self,
        graph: GraphBatch,
        v_emb: jnp.ndarray,
        e_emb: jnp.ndarray,
        v_gate: Optional[jnp.ndarray] = None,  # [B, V, 1] float (mask*filter)
        e_gate: Optional[jnp.ndarray] = None,  # [B, E, 1]
        train: bool = False,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        v = v_emb if v_gate is None else v_emb * v_gate
        e = e_emb if e_gate is None else e_emb * e_gate
        # static_argnums: 0 is the module itself, 4 is the `train` bool
        layer_cls = (nn.remat(DMPLayer, static_argnums=(4,))
                     if self.remat else DMPLayer)
        for i in range(self.num_layers):
            v_new, e_new = layer_cls(
                hidden_dim=self.hidden_dim,
                init_neigenv=self.init_neigenv,
                init_eeigenv=self.init_eeigenv,
                num_mlp_layers=self.num_mlp_layers,
                batch_norm=self.batch_norm,
                act=self.act,
                dropout=self.dropout,
                scatter_method=self.scatter_method,
                name=f"dmpnn_{i}",
            )(graph, v, e, train)  # train positional: remat static_argnums
            if v_gate is not None:
                v_new = v_new * v_gate
            if e_gate is not None:
                e_new = e_new * e_gate
            if self.residual and v_new.shape == v.shape and e_new.shape == e.shape:
                v = v + v_new
                e = e + e_new
            else:
                v, e = v_new, e_new
        return v, e
