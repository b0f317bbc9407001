"""EdgeSeq model family: CNN / RNN / TransformerXL over edge sequences.

Reference: /root/reference/SubgraphCountingMatching/models/basemodel.py:222-616
(EdgeSeqModel scaffold), cnn.py, rnn.py, txl.py.

The scaffold encodes all five tuple fields (u, v, ul, el, vl), sums their
embeddings, applies the label filter (ul & el & vl), runs a sequence rep net,
and predicts over the (possibly length-changed) edge sequence.

Padding convention note: the reference pre-pads (zeros at the head); we
post-pad with masks.  For CNN/TXL the outputs at real positions are
mask-equivalent; for RNN the reference's recurrent state at real positions
has passed through the zero pad steps first — an artifact of pre-padding we
deliberately do not reproduce (state starts at h0 at the first real step).

TXL static-shape design: segments have fixed length seg_len, so the memory
length at segment i is exactly min(mem_len, i * seg_len) — a static quantity
per unrolled segment.  Memories are stop_gradient'ed as in the reference
(txl.py:284-287).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import nn

from ..constants import _INF
from ..graph import EdgeSeqBatch
from ..ops.encoding import get_enc_len, position_table
from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, kaiming_normal, get_initializer
from .basemodel import ModelConfig
from .embed import Embedding, MultihotEncoder, PositionEncoder
from .filter import scalar_filter
from .layers import Dense, MaskedBatchNorm
from .pred import build_pred_net
from .scm_models import MODEL_REGISTRY


# =============================================================================
# scaffold
# =============================================================================

class EdgeSeqEncNet(nn.Module):
    """Five frozen encoders (basemodel.py:226-284)."""

    cfg: ModelConfig
    which: str

    def setup(self):
        cfg = self.cfg
        if self.which == "pattern" and not cfg.share_enc_net:
            nv, nvl, nel = cfg.max_npv, cfg.max_npvl, cfg.max_npel
        else:
            nv, nvl, nel = cfg.max_ngv, cfg.max_ngvl, cfg.max_ngel
        mk = (MultihotEncoder if cfg.enc_net == "Multihot" else None)
        if mk is not None:
            self.u = mk(nv, cfg.base)
            self.v = mk(nv, cfg.base)
            self.ul = mk(nvl, cfg.base)
            self.el = mk(nel, cfg.base)
            self.vl = mk(nvl, cfg.base)
        elif cfg.enc_net == "Position":
            def dim(n):
                return get_enc_len(n - 1, cfg.base) * cfg.base
            self.u = PositionEncoder(dim(nv), nv)
            self.v = PositionEncoder(dim(nv), nv)
            self.ul = PositionEncoder(dim(nvl), nvl)
            self.el = PositionEncoder(dim(nel), nel)
            self.vl = PositionEncoder(dim(nvl), nvl)
        else:
            raise NotImplementedError(cfg.enc_net)

    def __call__(self, seq: EdgeSeqBatch) -> Dict[str, jnp.ndarray]:
        return {
            "u": self.u(seq.u), "v": self.v(seq.v), "ul": self.ul(seq.ul),
            "el": self.el(seq.el), "vl": self.vl(seq.vl),
        }


class EdgeSeqEmbNet(nn.Module):
    """Summed five-field embedding (basemodel.py:484-500); no rescale
    (BaseModel.create_emb_net, basemodel.py:69-91)."""

    cfg: ModelConfig
    which: str

    def setup(self):
        cfg = self.cfg
        dims = cfg.enc_dims(self.which)
        init = cfg.emb_net.lower()
        h = cfg.hid_dim
        self.u = Embedding(dims["v"], h, weight_init=init)
        self.v = Embedding(dims["v"], h, weight_init=init)
        self.ul = Embedding(dims["vl"], h, weight_init=init)
        self.el = Embedding(dims["el"], h, weight_init=init)
        self.vl = Embedding(dims["vl"], h, weight_init=init)

    def __call__(self, enc: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        return (self.u(enc["u"]) + self.v(enc["v"]) + self.ul(enc["ul"])
                + self.el(enc["el"]) + self.vl(enc["vl"]))


class EdgeSeqModel(nn.Module):
    """Sequence-arch scaffold (basemodel.py:222-616)."""

    cfg: ModelConfig

    def make_rep_net(self) -> nn.Module:
        raise NotImplementedError

    def setup(self):
        cfg = self.cfg
        self.g_enc_net = EdgeSeqEncNet(cfg, "graph")
        if not cfg.share_enc_net:
            self.p_enc_net = EdgeSeqEncNet(cfg, "pattern")
        self.g_emb_net = EdgeSeqEmbNet(cfg, "graph")
        if not cfg.share_emb_net:
            self.p_emb_net = EdgeSeqEmbNet(cfg, "pattern")
        self.g_rep_net = self.make_rep_net()
        if not cfg.share_rep_net:
            self.p_rep_net = self.make_rep_net()
        self.pred_net = build_pred_net(
            cfg.pred_net, cfg.pred_hid_dim,
            act=cfg.pred_act_func, dropout=cfg.pred_dropout,
            return_weights="edge" in cfg.pred_return_weights,
            infer_steps=cfg.pred_infer_steps, num_heads=cfg.pred_num_heads,
            mem_len=cfg.pred_mem_len, mem_init=cfg.pred_mem_init,
        )

    # CNN overrides these to track pooling-induced length changes; also
    # applied to weight TARGETS in the loss (train.py:630,641)
    def refine_edge_weights(self, w, use_max=False):
        return w

    def refine_node_weights(self, w, use_max=False):
        return w

    def get_filter_gate(self, pattern: EdgeSeqBatch, graph: EdgeSeqBatch):
        if self.cfg.filter_net == "None":
            return None
        if self.cfg.filter_net != "ScalarFilter":
            raise ValueError(self.cfg.filter_net)
        pm = pattern.mask
        ul = scalar_filter(pattern.ul, graph.ul, pm)
        el = scalar_filter(pattern.el, graph.el, pm)
        vl = scalar_filter(pattern.vl, graph.vl, pm)
        return jnp.logical_and(jnp.logical_and(ul, vl), el).astype(
            jnp.float32)[..., None]

    def __call__(self, pattern: EdgeSeqBatch, graph: EdgeSeqBatch,
                 train: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        p_mask = pattern.mask
        g_mask = graph.mask
        el_gate = self.get_filter_gate(pattern, graph)

        p_enc_net = self.g_enc_net if cfg.share_enc_net else self.p_enc_net
        p_emb_net = self.g_emb_net if cfg.share_emb_net else self.p_emb_net
        p_rep_net = self.g_rep_net if cfg.share_rep_net else self.p_rep_net

        p_enc = p_enc_net(pattern)
        p_e_emb = p_emb_net(p_enc)
        p_e_rep = p_rep_net(p_e_emb, mask=p_mask.astype(jnp.float32)[..., None],
                            gate=None, train=train)

        g_enc = self.g_enc_net(graph)
        g_e_emb = self.g_emb_net(g_enc)
        g_gate = g_mask.astype(jnp.float32)[..., None]
        if el_gate is not None:
            g_gate = g_gate * el_gate
        g_e_rep = self.g_rep_net(g_e_emb, mask=None, gate=g_gate, train=train)

        # reversed edges leave the prediction mask (basemodel.py:531-535)
        p_e_mask = jnp.logical_and(p_mask, jnp.logical_not(pattern.rev_flag))
        g_e_mask = jnp.logical_and(g_mask, jnp.logical_not(graph.rev_flag))

        p_add, g_add = [], []
        if cfg.pred_with_enc:
            p_add += [p_enc[k] for k in ("u", "v", "ul", "el", "vl")]
            g_add += [g_enc[k] for k in ("u", "v", "ul", "el", "vl")]
        if cfg.pred_with_deg:
            p_out = pattern.out_degrees()
            p_in = pattern.in_degrees()
            g_out = graph.out_degrees()
            g_in = graph.in_degrees()
            p_add += [jnp.take_along_axis(p_out, pattern.u, 1)[..., None],
                      jnp.take_along_axis(p_in, pattern.v, 1)[..., None]]
            g_add += [jnp.take_along_axis(g_out, graph.u, 1)[..., None],
                      jnp.take_along_axis(g_in, graph.v, 1)[..., None]]

        if p_add:
            p_addfeat = jnp.concatenate(p_add, -1) * p_e_mask[..., None]
            p_addfeat = self.refine_edge_weights(p_addfeat)
            p_e_out = jnp.concatenate([p_addfeat, p_e_rep], -1)
            g_addfeat = jnp.concatenate(g_add, -1) * g_e_mask[..., None]
            g_addfeat = self.refine_edge_weights(g_addfeat)
            g_e_out = jnp.concatenate([g_addfeat, g_e_rep], -1)
        else:
            p_e_out, g_e_out = p_e_rep, g_e_rep

        p_e_mask = self.refine_edge_weights(
            p_e_mask.astype(jnp.float32)[..., None], use_max=True)[..., 0] > 0
        g_e_mask = self.refine_edge_weights(
            g_e_mask.astype(jnp.float32)[..., None], use_max=True)[..., 0] > 0

        pred_c, pred_e = self.pred_net(
            p_e_out, p_e_mask, g_e_out, g_e_mask, train=train)

        return {
            "p_v_emb": None, "p_e_emb": p_e_emb,
            "g_v_emb": None, "g_e_emb": g_e_emb,
            "p_v_rep": None, "p_e_rep": p_e_rep,
            "g_v_rep": None, "g_e_rep": g_e_rep,
            "p_v_mask": None, "p_e_mask": p_e_mask,
            "g_v_mask": None, "g_e_mask": g_e_mask,
            "pred_c": pred_c, "pred_v": None, "pred_e": pred_e,
        }


# =============================================================================
# CNN (cnn.py:13-237)
# =============================================================================

def _max_pool1d(x, kernel, stride, padding):
    """torch MaxPool1d semantics on [B, L, C] (pads with -inf)."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(1, kernel, 1), window_strides=(1, stride, 1),
        padding=((0, 0), (padding, padding), (0, 0)))


def _sum_pool1d(x, kernel, stride, padding):
    """k * avg_pool1d with count_include_pad=True == sum pooling, zero pad."""
    return jax.lax.reduce_window(
        x, 0.0, jax.lax.add,
        window_dimensions=(1, kernel, 1), window_strides=(1, stride, 1),
        padding=((0, 0), (padding, padding), (0, 0)))


class CNNLayer(nn.Module):
    """Conv1d -> act -> MaxPool -> [BN] -> dropout (cnn.py:13-62)."""

    out_channels: int
    kernel_size: int = 2
    padding: int = -1
    stride: int = 1
    batch_norm: bool = True
    act: str = "relu"
    dropout: float = 0.0

    @property
    def conv_padding(self) -> int:
        return self.kernel_size // 2 if self.padding == -1 else self.padding

    @property
    def pool_kernel(self) -> int:
        return self.kernel_size // self.stride

    def out_len(self, l: int) -> int:
        p = self.conv_padding
        lc = (l + 2 * p - self.kernel_size) // self.stride + 1
        return lc + 2 * p - self.pool_kernel + 1

    @nn.compact
    def __call__(self, x, mask=None, train: bool = False):
        # x: [B, L, C]
        gain = calculate_gain(self.act)
        conv = nn.Conv(
            self.out_channels, kernel_size=(self.kernel_size,),
            strides=(self.stride,),
            padding=[(self.conv_padding, self.conv_padding)],
            kernel_init=kaiming_normal(gain, fan_axis=1), name="conv")
        o = conv(x)
        o = map_activation_str_to_fn(self.act)(o)
        o = _max_pool1d(o, self.pool_kernel, 1, self.conv_padding)
        if self.batch_norm:
            o = MaskedBatchNorm(name="bn")(o, mask=mask, train=train)
        return nn.Dropout(self.dropout, name="drop")(o, deterministic=not train)


def cnn_geometry(cfg: ModelConfig) -> List[Tuple[int, int, int, int]]:
    """Per-layer (kernel, conv_padding, stride, pool_kernel) — shared by the
    stack and by refine_edge_weights (pure pooling, no parameters)."""
    n = cfg.rep_num_graph_layers

    def expand(t):
        t = (t,) if isinstance(t, int) else tuple(t)
        return t * n if len(t) == 1 else t

    ks = expand(cfg.rep_cnn_kernel_sizes)
    ps = expand(cfg.rep_cnn_paddings)
    ss = expand(cfg.rep_cnn_strides)
    geo = []
    for i in range(n):
        p = ks[i] // 2 if ps[i] == -1 else ps[i]
        geo.append((ks[i], p, ss[i], ks[i] // ss[i]))
    return geo


class CNNStack(nn.Module):
    """Gated CNN stack with pooled gates (cnn.py:112-190)."""

    cfg: ModelConfig

    @nn.compact
    def __call__(self, emb, mask=None, gate=None, train: bool = False):
        cfg = self.cfg
        g = None
        if mask is not None or gate is not None:
            g = (mask if mask is not None else 1.0)
            if gate is not None:
                g = g * gate
        x = emb if g is None else emb * g
        # static_argnums: 0 is the module itself, 3 is the `train` bool
        cnn_cls = (nn.remat(CNNLayer, static_argnums=(3,))
                   if cfg.rep_remat else CNNLayer)
        for i, (k, p, s, pk) in enumerate(cnn_geometry(cfg)):
            layer = cnn_cls(cfg.hid_dim, kernel_size=k, padding=p, stride=s,
                            batch_norm=cfg.rep_cnn_batch_norm,
                            act=cfg.rep_act_func, dropout=cfg.rep_dropout,
                            name=f"cnn_{i}")
            if g is not None:
                g = _max_pool1d(g, k, s, p)
                g = _max_pool1d(g, pk, 1, p)
            o = layer(x, (g[..., 0] > 0) if g is not None else None, train)
            if g is not None:
                o = o * g
            if cfg.rep_residual and o.shape == x.shape:
                x = x + o
            else:
                x = o
        return x


class CNN(EdgeSeqModel):
    def make_rep_net(self) -> nn.Module:
        return CNNStack(self.cfg)

    def refine_edge_weights(self, w, use_max=False):
        """Track pooling length changes (cnn.py:192-237)."""
        for (k, p, s, pk) in cnn_geometry(self.cfg):
            if use_max:
                w = _max_pool1d(w, k, s, p)
            else:
                w = _sum_pool1d(w, k, s, p)
            w = _max_pool1d(w, pk, 1, p)
        return w


# =============================================================================
# RNN (rnn.py:13-124)
# =============================================================================

class RNNLayer(nn.Module):
    hid_dim: int
    rnn_type: str = "LSTM"
    bidirectional: bool = False
    layer_norm: bool = False
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, train: bool = False):
        h = self.hid_dim // 2 if self.bidirectional else self.hid_dim
        init = get_initializer("uniform")

        def make_cell():
            if self.rnn_type == "LSTM":
                return nn.OptimizedLSTMCell(
                    h, kernel_init=init, recurrent_kernel_init=init)
            if self.rnn_type == "GRU":
                return nn.GRUCell(h, kernel_init=init,
                                  recurrent_kernel_init=init)
            if self.rnn_type == "RNN":
                return nn.SimpleCell(h, kernel_init=init,
                                     recurrent_kernel_init=init)
            raise ValueError(self.rnn_type)

        if self.bidirectional:
            o = nn.Bidirectional(
                nn.RNN(make_cell()), nn.RNN(make_cell()), name="rnn")(x)
        else:
            o = nn.RNN(make_cell(), name="rnn")(x)
        if self.layer_norm:
            o = nn.LayerNorm(name="ln")(o)
        return nn.Dropout(self.dropout, name="drop")(o, deterministic=not train)


class RNNStack(nn.Module):
    cfg: ModelConfig

    @nn.compact
    def __call__(self, emb, mask=None, gate=None, train: bool = False):
        cfg = self.cfg
        g = None
        if mask is not None or gate is not None:
            g = (mask if mask is not None else 1.0)
            if gate is not None:
                g = g * gate
        # pattern path (mask only): masked, no residual (rnn.py:87-92);
        # graph path (gate): gated with residual (rnn.py:113-122)
        residual = cfg.rep_residual and (gate is not None or g is None)
        x = emb if g is None else emb * g
        # static_argnums: 0 is the module itself, 2 is the `train` bool
        rnn_cls = (nn.remat(RNNLayer, static_argnums=(2,))
                   if cfg.rep_remat else RNNLayer)
        for i in range(cfg.rep_num_graph_layers):
            o = rnn_cls(cfg.hid_dim, cfg.rep_rnn_type,
                        cfg.rep_rnn_bidirectional, cfg.rep_rnn_layer_norm,
                        cfg.rep_dropout, name=f"rnn_{i}")(x, train)
            if g is not None:
                o = o * g
            if residual and o.shape == x.shape:
                x = x + o
            else:
                x = o
        return x


class RNN(EdgeSeqModel):
    def make_rep_net(self) -> nn.Module:
        return RNNStack(self.cfg)


# =============================================================================
# TransformerXL (txl.py:18-383)
# =============================================================================

def rel_shift(x: jnp.ndarray) -> jnp.ndarray:
    """TXL relative-position shift (txl.py:95-108). x: [B, q, k, n]."""
    b, q, k, n = x.shape
    x = jnp.concatenate([jnp.zeros((b, q, 1, n), x.dtype), x], axis=2)
    x = x.reshape(b, k + 1, q, n)[:, 1:]
    return x.reshape(b, q, k, n)


class TXLAttn(nn.Module):
    hid_dim: int
    num_heads: int = 4
    dropout: float = 0.0
    pre_lnorm: bool = True

    @nn.compact
    def __call__(self, w, r, r_w_bias, r_r_bias, mems=None,
                 train: bool = False):
        h, nh = self.hid_dim, self.num_heads
        scale = 1.0 / math.sqrt(h / nh)
        bsz, qlen = w.shape[0], w.shape[1]
        original_w = w
        c = w if mems is None else jnp.concatenate([mems, w], axis=1)
        klen = c.shape[1]
        if self.pre_lnorm:
            ln = nn.LayerNorm(name="layer_norm")
            w = ln(w)
            c = ln(c)
        mk = kaiming_normal(1.0)
        q = (w @ self.param("q_kernel", mk, (w.shape[-1], h))).reshape(
            bsz, qlen, nh, -1)
        k = (c @ self.param("k_kernel", mk, (c.shape[-1], h))).reshape(
            bsz, klen, nh, -1)
        v = (c @ self.param("v_kernel", mk, (c.shape[-1], h))).reshape(
            bsz, klen, nh, -1)
        rk = (r @ self.param("r_kernel", mk, (r.shape[-1], h))).reshape(
            klen, nh, -1)

        AC = jnp.einsum("bind,bjnd->bijn", q + r_w_bias, k)
        BD = rel_shift(jnp.einsum("bind,jnd->bijn", q + r_r_bias, rk))
        score = (AC + BD) * scale
        prob = jax.nn.softmax(score, axis=2)
        prob = nn.Dropout(self.dropout, name="attn_drop")(
            prob, deterministic=not train)
        vec = jnp.einsum("bijn,bjnd->bind", prob, v).reshape(bsz, qlen, h)
        out = Dense(h, init="normal", name="o_net")(vec)
        out = nn.Dropout(self.dropout, name="out_drop")(
            out, deterministic=not train)
        out = out + original_w
        if not self.pre_lnorm:
            out = nn.LayerNorm(name="layer_norm")(out)
        return out


class TXLFF(nn.Module):
    hid_dim: int
    act: str = "relu"
    dropout: float = 0.0
    pre_lnorm: bool = True

    @nn.compact
    def __call__(self, x, train: bool = False):
        original = x
        if self.pre_lnorm:
            x = nn.LayerNorm(name="layer_norm")(x)
        o = Dense(self.hid_dim, init="normal", activation=self.act,
                  name="layer1")(x)
        o = map_activation_str_to_fn(self.act)(o)
        o = nn.Dropout(self.dropout, name="drop1")(o, deterministic=not train)
        o = Dense(original.shape[-1], init="normal", name="layer2")(o)
        o = nn.Dropout(self.dropout, name="drop2")(o, deterministic=not train)
        o = o + original
        if not self.pre_lnorm:
            o = nn.LayerNorm(name="layer_norm")(o)
        return o


class TXLStack(nn.Module):
    """Segment-recurrent TXL over the padded sequence (txl.py:212-383)."""

    cfg: ModelConfig

    @nn.compact
    def __call__(self, emb, mask=None, gate=None, train: bool = False):
        cfg = self.cfg
        h = cfg.hid_dim
        seg_len = cfg.rep_txl_seg_len
        mem_len = cfg.rep_txl_mem_len
        num_layers = cfg.rep_num_graph_layers
        b, total_len = emb.shape[0], emb.shape[1]

        g = None
        if mask is not None or gate is not None:
            g = (mask if mask is not None else 1.0)
            if gate is not None:
                g = g * gate
        x = emb if g is None else emb * g

        r_w_bias = self.param("r_w_bias", kaiming_normal(1.0),
                              (cfg.rep_txl_num_heads,
                               h // cfg.rep_txl_num_heads))
        r_r_bias = self.param("r_r_bias", kaiming_normal(1.0),
                              (cfg.rep_txl_num_heads,
                               h // cfg.rep_txl_num_heads))
        layers = [
            (TXLAttn(h, cfg.rep_txl_num_heads, cfg.rep_dropout,
                     cfg.rep_txl_pre_norm, name=f"attn_{i}"),
             TXLFF(h, cfg.rep_act_func, cfg.rep_dropout,
                   cfg.rep_txl_pre_norm, name=f"ff_{i}"))
            for i in range(num_layers)
        ]

        max_klen = seg_len + mem_len
        clamp = cfg.rep_txl_clamp_len
        pos_table = jnp.asarray(position_table(h, max(clamp, max_klen)))

        n_seg = -(-total_len // seg_len)
        pad = n_seg * seg_len - total_len
        if pad:
            x = jnp.concatenate(
                [x, jnp.zeros((b, pad, h), x.dtype)], axis=1)
        drop = nn.Dropout(cfg.rep_dropout)
        x = drop(x, deterministic=not train)

        mems: Optional[List[jnp.ndarray]] = None
        outs = []
        for i in range(n_seg):
            seg = x[:, i * seg_len: (i + 1) * seg_len]
            mlen = min(mem_len, i * seg_len)
            klen = mlen + seg_len
            pos_seq = jnp.arange(klen - 1, -1, -1)
            if clamp > 0:
                pos_seq = jnp.minimum(pos_seq, clamp)
            r = pos_table[pos_seq]
            r = drop(r, deterministic=not train)

            hids = [seg]
            o = seg
            for li, (attn, ff) in enumerate(layers):
                m = None if mems is None or mlen == 0 else mems[li]
                o = attn(o, r, r_w_bias, r_r_bias, mems=m, train=train)
                o = ff(o, train=train)
                hids.append(o)
            outs.append(o)
            # update mems (txl.py:269-288): cache last mem_len positions
            new_mems = []
            for li in range(len(hids)):
                cat = hids[li] if mems is None or mlen == 0 else \
                    jnp.concatenate([mems[li], hids[li]], axis=1)
                end = mlen + seg_len
                beg = max(0, end - mem_len)
                new_mems.append(jax.lax.stop_gradient(cat[:, beg:end]))
            mems = new_mems

        out = jnp.concatenate(outs, axis=1)[:, :total_len]
        if g is not None:
            out = out * (g if gate is None else
                         (mask if mask is not None else 1.0))
            # reference zero-masks outputs per layer with x_mask and re-gates
            # graph outputs with the full gate (txl.py:305-313, 380-382)
            if gate is not None:
                out = out * g
        return out


class TransformerXL(EdgeSeqModel):
    def make_rep_net(self) -> nn.Module:
        return TXLStack(self.cfg)


MODEL_REGISTRY["CNN"] = CNN
MODEL_REGISTRY["RNN"] = RNN
MODEL_REGISTRY["TXL"] = TransformerXL
