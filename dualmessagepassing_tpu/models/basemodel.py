"""Model scaffold: encode -> filter+embed -> represent -> interact+predict.

Static-shape re-design of the reference scaffold
(/root/reference/SubgraphCountingMatching/models/basemodel.py:15-219 BaseModel,
965-1663 GraphAdjModelV2).  Key structural differences from the reference:

  * The model is a pure function of (params, pattern GraphBatch, graph
    GraphBatch) — no mutable feature dicts.
  * Features stay in per-graph padded layout [B, V, .] / [B, E, .] end to
    end, so the reference's `split_and_batchify_graph_feats` scatter hot spot
    (basemodel.py:1572,1623; SURVEY §3.2) disappears entirely.
  * Sharing (enc/emb/rep nets) is realized by calling the same submodule for
    pattern and graph.

The forward contract matches GraphAdjModelV2.forward (basemodel.py:1500-1663):
returns an output dict with pred_c / pred_v / pred_e, the pattern/graph
node/edge reps and masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from .. import nn

from ..graph import GraphBatch
from ..ops.encoding import get_enc_len
from ..utils.amp import compute_dtype
from ..ops.scatter import gather_nodes, gather_scalars
from .embed import Embedding, MultihotEncoder, PositionEncoder
from .filter import scalar_filter
from .pred import build_pred_net


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Flattened model-facing configuration (reference **kw of BaseModel).

    Field names follow the reference flags (config.py) so configs translate
    1:1. Sizes are *model-facing* (after process_model_config doubling for
    reversed edges / dual conversion, train.py:38-65).
    """

    max_ngv: int
    max_ngvl: int
    max_nge: int
    max_ngel: int
    max_npv: int
    max_npvl: int
    max_npe: int
    max_npel: int
    base: int = 2
    hid_dim: int = 64
    share_emb_net: bool = True
    share_enc_net: bool = True
    share_rep_net: bool = True
    rep_residual: bool = True
    pred_with_enc: bool = False
    pred_with_deg: bool = False
    enc_net: str = "Multihot"
    emb_net: str = "Orthogonal"
    filter_net: str = "None"
    rep_net: str = "DMPNN"
    rep_num_pattern_layers: int = 3
    rep_num_graph_layers: int = 3
    rep_act_func: str = "relu"
    rep_dropout: float = 0.0
    # DMPNN-specific
    rep_dmpnn_num_mlp_layers: int = 2
    rep_dmpnn_batch_norm: bool = False
    init_neigenv: float = 4.0
    init_eeigenv: float = 4.0
    # CompGCN-specific (config.py:168-190)
    rep_compgcn_comp_opt: str = "corr"
    rep_compgcn_edge_norm: str = "none"
    rep_compgcn_batch_norm: bool = False
    # RGCN/RGIN-specific (config.py:105-165)
    rep_rgcn_num_bases: int = 4
    rep_rgcn_regularizer: str = "bdd"
    rep_rgcn_edge_norm: str = "in"
    rep_rgcn_batch_norm: bool = False
    rep_rgin_num_bases: int = 4
    rep_rgin_regularizer: str = "bdd"
    rep_rgin_num_mlp_layers: int = 2
    rep_rgin_batch_norm: bool = False
    # CNN-specific (config.py:13-35)
    rep_cnn_batch_norm: bool = True
    rep_cnn_kernel_sizes: Tuple[int, ...] = (2,)
    rep_cnn_paddings: Tuple[int, ...] = (-1,)
    rep_cnn_strides: Tuple[int, ...] = (1,)
    # RNN-specific (config.py:38-58)
    rep_rnn_type: str = "LSTM"
    rep_rnn_bidirectional: bool = False
    rep_rnn_layer_norm: bool = False
    # TXL-specific (config.py:61-102)
    rep_txl_num_heads: int = 4
    rep_txl_seg_len: int = 64
    rep_txl_mem_len: int = 64
    rep_txl_clamp_len: int = -1
    rep_txl_pre_norm: bool = True
    # LRP-specific
    lrp_seq_len: int = 4
    rep_lrp_batch_norm: bool = False
    # id-augmentation
    gnn_add_node_id: bool = False
    gnn_add_edge_id: bool = False
    node_pred: bool = True
    edge_pred: bool = True
    # prediction
    pred_net: str = "SumPredictNet"
    pred_hid_dim: int = 64
    pred_act_func: str = "relu"
    pred_dropout: float = 0.0
    pred_return_weights: str = "none"
    pred_infer_steps: int = 1
    pred_num_heads: int = 4
    pred_mem_len: int = 4
    pred_mem_init: str = "mean"
    # scatter backend: None = auto (one-hot einsum for small V), "onehot",
    # "segment" (XLA scatter-add)
    scatter_method: str = None
    # Extension (no reference equivalent): rematerialize each DMP
    # layer under autodiff (jax.checkpoint) to trade recompute for activation
    # memory — lets big envelopes / batch sizes fit HBM
    rep_remat: bool = False

    # ---- derived dims (basemodel.py:1345-1392) ------------------------------
    def enc_dims(self, which: str) -> Dict[str, int]:
        if which == "pattern" and not self.share_enc_net:
            nv, nvl, nel = self.max_npv, self.max_npvl, self.max_npel
        else:
            nv, nvl, nel = self.max_ngv, self.max_ngvl, self.max_ngel
        return {
            "v": get_enc_len(nv - 1, self.base) * self.base,
            "vl": get_enc_len(nvl - 1, self.base) * self.base,
            "el": get_enc_len(nel - 1, self.base) * self.base,
        }

    def rep_dims(self) -> Tuple[int, int]:
        rep_v, rep_e = self.hid_dim, self.hid_dim
        if self.pred_with_enc:
            d = self.enc_dims("graph")
            rep_v += d["v"] + d["vl"]
            rep_e += (d["v"] + d["vl"]) * 2 + d["el"]
        if self.pred_with_deg:
            rep_v += 2
            rep_e += 2
        return rep_v, rep_e

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


class EncNet(nn.Module):
    """Frozen encoder bundle {v, vl[, el]} (basemodel.py:624-662,973-1016)."""

    cfg: ModelConfig
    which: str  # "graph" | "pattern"
    include_el: bool = True

    def setup(self):
        cfg = self.cfg
        if self.which == "pattern" and not cfg.share_enc_net:
            nv, nvl, nel = cfg.max_npv, cfg.max_npvl, cfg.max_npel
        else:
            nv, nvl, nel = cfg.max_ngv, cfg.max_ngvl, cfg.max_ngel
        if cfg.enc_net == "Multihot":
            self.v = MultihotEncoder(nv, cfg.base)
            self.vl = MultihotEncoder(nvl, cfg.base)
            if self.include_el:
                self.el = MultihotEncoder(nel, cfg.base)
        elif cfg.enc_net == "Position":
            d = self.cfg.enc_dims(self.which)
            self.v = PositionEncoder(d["v"], nv)
            self.vl = PositionEncoder(d["vl"], nvl)
            if self.include_el:
                self.el = PositionEncoder(d["el"], nel)
        else:
            raise NotImplementedError(f"enc_net {cfg.enc_net}")

    def __call__(self, graph: GraphBatch) -> Dict[str, jnp.ndarray]:
        enc = {
            "v": self.v(graph.node_id),
            "vl": self.vl(graph.node_label),
        }
        if self.include_el:
            enc["el"] = self.el(graph.edge_label)
        if self.include_el and self.cfg.gnn_add_edge_id:
            enc["src"] = gather_nodes(enc["v"], graph.senders)
            enc["dst"] = gather_nodes(enc["v"], graph.receivers)
        return enc


class EmbNet(nn.Module):
    """Trainable embedding bundle with 1/enc_len rescale (basemodel.py:1028-1072).

    Note: the node-only GraphAdjModel scaffold uses BaseModel.create_emb_net,
    which does NOT apply the 1/enc_len rescale (basemodel.py:69-91); only
    GraphAdjModelV2 overrides it with the rescale. `rescale` mirrors that.
    """

    cfg: ModelConfig
    which: str
    include_el: bool = True
    rescale: bool = True

    def setup(self):
        cfg = self.cfg
        dims = cfg.enc_dims(self.which)
        init = cfg.emb_net.lower()
        h = cfg.hid_dim

        def scale(d):
            # 1/(enc_dim // base) = 1/enc_len (basemodel.py:1066-1071)
            return cfg.base / d if self.rescale else 1.0

        self.v = Embedding(dims["v"], h, weight_init=init, scale=scale(dims["v"]))
        self.vl = Embedding(dims["vl"], h, weight_init=init, scale=scale(dims["vl"]))
        if self.include_el:
            self.el = Embedding(dims["el"], h, weight_init=init, scale=scale(dims["el"]))

    def __call__(self, enc: Dict[str, jnp.ndarray]) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
        cfg = self.cfg
        v_emb = self.vl(enc["vl"])
        if cfg.gnn_add_node_id:
            v_emb = v_emb + self.v(enc["v"])
        if not self.include_el:
            return v_emb, None
        e_emb = self.el(enc["el"])
        if cfg.gnn_add_edge_id:
            e_emb = e_emb + self.v(enc["src"]) + self.v(enc["dst"])
        return v_emb, e_emb


class GraphAdjModelV2(nn.Module):
    """Node+edge dual-stream scaffold (basemodel.py:965-1663).

    Subclasses provide `make_rep_net()` returning a module with signature
    (graph, v_emb, e_emb, v_gate, e_gate, train) -> (v_rep, e_rep).
    """

    cfg: ModelConfig

    def make_rep_net(self) -> nn.Module:
        raise NotImplementedError

    def setup(self):
        cfg = self.cfg
        self.g_enc_net = EncNet(cfg, "graph")
        if not cfg.share_enc_net:
            self.p_enc_net = EncNet(cfg, "pattern")
        self.g_emb_net = EmbNet(cfg, "graph")
        if not cfg.share_emb_net:
            self.p_emb_net = EmbNet(cfg, "pattern")
        self.g_rep_net = self.make_rep_net()
        if not cfg.share_rep_net:
            self.p_rep_net = self.make_rep_net()
        rep_v_dim, rep_e_dim = cfg.rep_dims()
        kw = dict(
            act=cfg.pred_act_func,
            dropout=cfg.pred_dropout,
            infer_steps=cfg.pred_infer_steps,
            num_heads=cfg.pred_num_heads,
            mem_len=cfg.pred_mem_len,
            mem_init=cfg.pred_mem_init,
        )
        if cfg.node_pred:
            self.pred_net_v = build_pred_net(
                cfg.pred_net, cfg.pred_hid_dim,
                return_weights="node" in cfg.pred_return_weights,
                **kw,
            )
        if cfg.edge_pred:
            self.pred_net_e = build_pred_net(
                cfg.pred_net, cfg.pred_hid_dim,
                return_weights="edge" in cfg.pred_return_weights,
                **kw,
            )

    # ---- hooks overridden by LRP variants -----------------------------------
    def refine_node_weights(self, w, use_max=False):
        return w

    def refine_edge_weights(self, w, use_max=False):
        return w

    # ---- filter gates (basemodel.py:1394-1423) ------------------------------
    def get_filter_gate(self, pattern: GraphBatch, graph: GraphBatch):
        if self.cfg.filter_net == "None":
            return None, None
        if self.cfg.filter_net != "ScalarFilter":
            raise ValueError(self.cfg.filter_net)
        vl_gate = scalar_filter(pattern.node_label, graph.node_label,
                                pattern.node_mask)
        el_gate = scalar_filter(pattern.edge_label, graph.edge_label,
                                pattern.edge_mask)
        return (
            vl_gate.astype(compute_dtype())[..., None],
            el_gate.astype(compute_dtype())[..., None],
        )

    def __call__(self, pattern: GraphBatch, graph: GraphBatch,
                 train: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        bsz = pattern.batch_size

        p_v_mask = pattern.node_mask
        g_v_mask = graph.node_mask
        p_e_mask = pattern.edge_mask
        g_e_mask = graph.edge_mask
        vl_gate, el_gate = self.get_filter_gate(pattern, graph)

        p_enc_net = self.g_enc_net if cfg.share_enc_net else self.p_enc_net
        p_emb_net = self.g_emb_net if cfg.share_emb_net else self.p_emb_net
        p_rep_net = self.g_rep_net if cfg.share_rep_net else self.p_rep_net

        p_enc = p_enc_net(pattern)
        p_v_emb, p_e_emb = p_emb_net(p_enc)
        p_v_rep, p_e_rep = p_rep_net(
            pattern, p_v_emb, p_e_emb,
            v_gate=p_v_mask.astype(compute_dtype())[..., None],
            e_gate=p_e_mask.astype(compute_dtype())[..., None],
            train=train,
        )

        g_enc = self.g_enc_net(graph)
        g_v_emb, g_e_emb = self.g_emb_net(g_enc)
        g_v_gate = g_v_mask.astype(compute_dtype())[..., None]
        g_e_gate = g_e_mask.astype(compute_dtype())[..., None]
        if vl_gate is not None:
            g_v_gate = g_v_gate * vl_gate
            g_e_gate = g_e_gate * el_gate
        g_v_rep, g_e_rep = self.g_rep_net(
            graph, g_v_emb, g_e_emb, v_gate=g_v_gate, e_gate=g_e_gate, train=train
        )

        # reversed edges never appear in the prediction (basemodel.py:1521-1531)
        p_e_mask = jnp.logical_and(p_e_mask, jnp.logical_not(pattern.rev_flag))
        g_e_mask = jnp.logical_and(g_e_mask, jnp.logical_not(graph.rev_flag))

        if cfg.pred_with_deg:
            p_out_deg, p_in_deg = pattern.out_degrees(), pattern.in_degrees()
            g_out_deg, g_in_deg = graph.out_degrees(), graph.in_degrees()

        # ---- node head inputs (basemodel.py:1540-1577) ----------------------
        if cfg.node_pred:
            p_v_add, g_v_add = [], []
            if cfg.pred_with_enc:
                p_v_add += [p_enc["v"], p_enc["vl"]]
                g_v_add += [g_enc["v"], g_enc["vl"]]
            if cfg.pred_with_deg:
                p_v_add += [p_out_deg[..., None], p_in_deg[..., None]]
                g_v_add += [g_out_deg[..., None], g_in_deg[..., None]]
            if p_v_add:
                p_v_out = jnp.concatenate(
                    [self.refine_node_weights(jnp.concatenate(p_v_add, -1)), p_v_rep], -1
                )
                g_v_out = jnp.concatenate(
                    [self.refine_node_weights(jnp.concatenate(g_v_add, -1)), g_v_rep], -1
                )
            else:
                p_v_out, g_v_out = p_v_rep, g_v_rep
            p_v_out = p_v_out * p_v_mask[..., None]
            g_v_out = g_v_out * g_v_mask[..., None]
        else:
            p_v_out = g_v_out = None

        # ---- edge head inputs (basemodel.py:1582-1627) ----------------------
        if cfg.edge_pred:
            p_e_add, g_e_add = [], []
            if cfg.pred_with_enc:
                def egather(enc, idx):
                    return gather_nodes(enc, idx)
                p_e_add += [
                    egather(p_enc["v"], pattern.senders),
                    egather(p_enc["v"], pattern.receivers),
                    egather(p_enc["vl"], pattern.senders),
                    p_enc["el"],
                    egather(p_enc["vl"], pattern.receivers),
                ]
                g_e_add += [
                    egather(g_enc["v"], graph.senders),
                    egather(g_enc["v"], graph.receivers),
                    egather(g_enc["vl"], graph.senders),
                    g_enc["el"],
                    egather(g_enc["vl"], graph.receivers),
                ]
            if cfg.pred_with_deg:
                def dgather(deg, idx):
                    return gather_scalars(deg, idx)[..., None]
                p_e_add += [
                    dgather(p_out_deg, pattern.senders),
                    dgather(p_in_deg, pattern.receivers),
                ]
                g_e_add += [
                    dgather(g_out_deg, graph.senders),
                    dgather(g_in_deg, graph.receivers),
                ]
            if p_e_add:
                p_e_out = jnp.concatenate(
                    [self.refine_edge_weights(jnp.concatenate(p_e_add, -1)), p_e_rep], -1
                )
                g_e_out = jnp.concatenate(
                    [self.refine_edge_weights(jnp.concatenate(g_e_add, -1)), g_e_rep], -1
                )
            else:
                p_e_out, g_e_out = p_e_rep, g_e_rep
            p_e_out = p_e_out * p_e_mask[..., None]
            g_e_out = g_e_out * g_e_mask[..., None]
        else:
            p_e_out = g_e_out = None

        # ---- dual-head prediction (basemodel.py:1477-1498) ------------------
        pred_v = pred_e = None
        v_pred_c = e_pred_c = None
        if cfg.node_pred:
            v_pred_c, pred_v = self.pred_net_v(
                p_v_out, p_v_mask, g_v_out, g_v_mask, train=train
            )
        if cfg.edge_pred:
            e_pred_c, pred_e = self.pred_net_e(
                p_e_out, p_e_mask, g_e_out, g_e_mask, train=train
            )
        if cfg.node_pred and cfg.edge_pred:
            # exact counts: sum in f32, then follow the compute dtype
            # (bf16 cannot represent integers above 256 — utils/amp)
            g_v_len = jnp.sum(g_v_mask.astype(jnp.float32), 1,
                              keepdims=True).astype(compute_dtype())
            g_e_len = jnp.sum(g_e_mask.astype(jnp.float32), 1,
                              keepdims=True).astype(compute_dtype())
            g_len = g_v_len + g_e_len
            pred_c = (g_v_len / g_len) * v_pred_c + (g_e_len / g_len) * e_pred_c
        elif cfg.node_pred:
            pred_c = v_pred_c
        elif cfg.edge_pred:
            pred_c = e_pred_c
        else:
            raise ValueError("at least one of node_pred/edge_pred required")

        return {
            "p_v_emb": p_v_emb, "p_e_emb": p_e_emb,
            "g_v_emb": g_v_emb, "g_e_emb": g_e_emb,
            "p_v_rep": p_v_rep, "p_e_rep": p_e_rep,
            "g_v_rep": g_v_rep, "g_e_rep": g_e_rep,
            "p_v_mask": p_v_mask, "p_e_mask": p_e_mask,
            "g_v_mask": g_v_mask, "g_e_mask": g_e_mask,
            "pred_c": pred_c, "pred_v": pred_v, "pred_e": pred_e,
        }


class GraphAdjModel(nn.Module):
    """Node-only GNN scaffold (basemodel.py:619-962) — RGCN / RGIN family.

    The representation net consumes (graph, v_emb, v_gate) and the integer
    edge labels as relation types; there is no learned edge stream.
    """

    cfg: ModelConfig

    def make_rep_net(self) -> nn.Module:
        raise NotImplementedError

    def setup(self):
        cfg = self.cfg
        self.g_enc_net = EncNet(cfg, "graph", include_el=False)
        if not cfg.share_enc_net:
            self.p_enc_net = EncNet(cfg, "pattern", include_el=False)
        # BaseModel.create_emb_net has no 1/enc_len rescale (basemodel.py:69-91)
        self.g_emb_net = EmbNet(cfg, "graph", include_el=False, rescale=False)
        if not cfg.share_emb_net:
            self.p_emb_net = EmbNet(cfg, "pattern", include_el=False,
                                    rescale=False)
        self.g_rep_net = self.make_rep_net()
        if not cfg.share_rep_net:
            self.p_rep_net = self.make_rep_net()
        self.pred_net_v = build_pred_net(
            cfg.pred_net, cfg.pred_hid_dim,
            act=cfg.pred_act_func, dropout=cfg.pred_dropout,
            return_weights="node" in cfg.pred_return_weights,
            infer_steps=cfg.pred_infer_steps, num_heads=cfg.pred_num_heads,
            mem_len=cfg.pred_mem_len, mem_init=cfg.pred_mem_init,
        )

    def get_filter_gate(self, pattern: GraphBatch, graph: GraphBatch):
        """vl-only gate (basemodel.py:820-837)."""
        if self.cfg.filter_net == "None":
            return None
        if self.cfg.filter_net != "ScalarFilter":
            raise ValueError(self.cfg.filter_net)
        vl_gate = scalar_filter(pattern.node_label, graph.node_label,
                                pattern.node_mask)
        return vl_gate.astype(compute_dtype())[..., None]

    def __call__(self, pattern: GraphBatch, graph: GraphBatch,
                 train: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        p_v_mask = pattern.node_mask
        g_v_mask = graph.node_mask
        vl_gate = self.get_filter_gate(pattern, graph)

        p_enc_net = self.g_enc_net if cfg.share_enc_net else self.p_enc_net
        p_emb_net = self.g_emb_net if cfg.share_emb_net else self.p_emb_net
        p_rep_net = self.g_rep_net if cfg.share_rep_net else self.p_rep_net

        p_enc = p_enc_net(pattern)
        p_v_emb, _ = p_emb_net(p_enc)
        p_v_rep = p_rep_net(
            pattern, p_v_emb,
            v_gate=p_v_mask.astype(compute_dtype())[..., None], train=train,
        )

        g_enc = self.g_enc_net(graph)
        g_v_emb, _ = self.g_emb_net(g_enc)
        g_v_gate = g_v_mask.astype(compute_dtype())[..., None]
        if vl_gate is not None:
            g_v_gate = g_v_gate * vl_gate
        g_v_rep = self.g_rep_net(graph, g_v_emb, v_gate=g_v_gate, train=train)

        p_add, g_add = [], []
        if cfg.pred_with_enc:
            p_add += [p_enc["v"], p_enc["vl"]]
            g_add += [g_enc["v"], g_enc["vl"]]
        if cfg.pred_with_deg:
            p_add += [pattern.out_degrees()[..., None],
                      pattern.in_degrees()[..., None]]
            g_add += [graph.out_degrees()[..., None],
                      graph.in_degrees()[..., None]]
        if p_add:
            p_v_out = jnp.concatenate(p_add + [p_v_rep], -1)
            g_v_out = jnp.concatenate(g_add + [g_v_rep], -1)
        else:
            p_v_out, g_v_out = p_v_rep, g_v_rep
        p_v_out = p_v_out * p_v_mask[..., None]
        g_v_out = g_v_out * g_v_mask[..., None]

        pred_c, pred_v = self.pred_net_v(
            p_v_out, p_v_mask, g_v_out, g_v_mask, train=train
        )
        return {
            "p_v_emb": p_v_emb, "p_e_emb": None,
            "g_v_emb": g_v_emb, "g_e_emb": None,
            "p_v_rep": p_v_rep, "p_e_rep": None,
            "g_v_rep": g_v_rep, "g_e_rep": None,
            "p_v_mask": p_v_mask, "p_e_mask": None,
            "g_v_mask": g_v_mask, "g_e_mask": None,
            "pred_c": pred_c, "pred_v": pred_v, "pred_e": None,
        }
