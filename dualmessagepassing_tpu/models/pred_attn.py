"""Attention / memory predict nets: DotAttention, MemAttn, DIAMNet.

Reference: /root/reference/SubgraphCountingMatching/models/pred.py:240-1328.

Static-shape re-design of `init_mem` (pred.py:648-760) + the per-sample
bucketing in `init_memory` (pred.py:836-865, 1183-1263): the reference slices
each sample to its true length and calls torch pooling per bucket because
torch pooling cannot handle ragged rows.  Here each sample's pooling windows
are encoded as a [mem_len, L] selection-count matrix computed from the traced
true length (stride = l // mem_len, kernel = l - (mem_len-1)*stride when
l > mem_len; one tail-aligned slot per position when l <= mem_len; circular
variants wrap indices modulo l).  Pooling then becomes one batched einsum —
no data-dependent shapes, no host round trips, identical numerics.

The "identity" parameter init ("make the attention prefer to output the
original", pred.py:540-546) follows utils/init.py:105-122: eye + eps noise
for matrices, ones + eps noise for vectors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from .. import nn

from ..constants import _INF
from ..utils.act import map_activation_str_to_fn, sparsemax
from ..utils.init import get_initializer
from .layers import Dense
from .pred import MaxPredictNet, MeanPredictNet, PredictNet, SumPredictNet


# =============================================================================
# DotAttention
# =============================================================================

class DotAttention(nn.Module):
    """Multi-head dot attention with sparsemax/softmax scores and output gate
    (pred.py:240-487)."""

    hidden_dim: int
    num_heads: int = 1
    scale: float = 1.0
    score_func: str = "softmax"
    add_zero_attn: bool = False
    add_gate: bool = False
    add_residual: bool = False
    pre_lnorm: bool = False
    post_lnorm: bool = False
    dropout: float = 0.0
    param_init: str = "normal"   # pred nets re-init everything to "identity"

    @nn.compact
    def __call__(self, query, key, value, query_mask=None, key_mask=None,
                 train: bool = False):
        qd, kd, vd = query.shape[-1], key.shape[-1], value.shape[-1]
        h = self.hidden_dim
        init = get_initializer(self.param_init)
        bsz, qlen = query.shape[0], query.shape[1]

        original_query = query
        if self.add_zero_attn:
            zk = jnp.zeros((bsz, 1, kd), key.dtype)
            zv = jnp.zeros((bsz, 1, vd), value.dtype)
            key = jnp.concatenate([key, zk], axis=1)
            value = jnp.concatenate([value, zv], axis=1)
            if key_mask is not None:
                key_mask = jnp.concatenate(
                    [key_mask, jnp.ones((bsz, 1), key_mask.dtype)], axis=1)

        if self.pre_lnorm:
            query = nn.LayerNorm(name="q_layer_norm")(query)
            key = nn.LayerNorm(name="k_layer_norm")(key)
            value = nn.LayerNorm(name="v_layer_norm")(value)

        klen, vlen = key.shape[1], value.shape[1]

        if h != -1:
            wq = self.param("weight_q", init, (qd, h))
            wk = self.param("weight_k", init, (kd, h))
            wv = self.param("weight_v", init, (vd, h))
            wo = self.param("weight_o", init, (h, qd))
            q = (query @ wq).reshape(bsz, qlen, self.num_heads, -1)
            k = (key @ wk).reshape(bsz, klen, self.num_heads, -1)
        else:
            q = query.reshape(bsz, qlen, self.num_heads, -1)
            k = key.reshape(bsz, klen, self.num_heads, -1)

        # [B, qlen, klen, heads]
        score = jnp.einsum("bind,bjnd->bijn", q, k) * self.scale
        if key_mask is not None:
            score = jnp.where(key_mask[:, None, :, None], score, _INF)
        if self.score_func == "sparsemax":
            score = sparsemax(score, axis=2)
        elif self.score_func == "softmax":
            score = jax.nn.softmax(score, axis=2)
        else:
            score = map_activation_str_to_fn(self.score_func)(score)
        score = nn.Dropout(self.dropout, name="score_drop")(
            score, deterministic=not train)

        v = (value @ wv if h != -1 else value).reshape(
            bsz, vlen, self.num_heads, -1)
        vec = jnp.einsum("bijn,bjnd->bind", score, v).reshape(bsz, qlen, -1)
        if query_mask is not None:
            vec = vec * query_mask[..., None]
        if h != -1:
            vec = vec @ wo
        vec = nn.Dropout(self.dropout, name="out_drop")(
            vec, deterministic=not train)

        if self.add_gate:
            gk = self.param("g_kernel", init, (2 * qd, qd))
            gb = self.param(
                "g_bias",
                # reference sets the gate bias to 1.0 then the pred nets'
                # identity re-init makes it ~ones either way
                nn.initializers.ones, (qd,))
            g = jax.nn.sigmoid(
                jnp.concatenate([original_query, vec], axis=-1) @ gk + gb)
            out = g * original_query + (1 - g) * vec
        else:
            out = vec
        if self.add_residual:
            out = original_query + out
        if self.post_lnorm:
            out = nn.LayerNorm(name="o_layer_norm")(out)
        return out


# =============================================================================
# static-shape memory initialization
# =============================================================================

def window_selection(lengths: jnp.ndarray, seq_len: int, mem_len: int,
                     circular: bool) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-sample pooling-window count matrix.

    lengths: [B] true lengths (post-pad convention).  Returns
    (sel [B, mem_len, seq_len] float counts, mem_mask [B, mem_len] bool).
    Encodes init_mem's two regimes (pred.py:656-758): tail-aligned unit slots
    when l <= mem_len, else stride/kernel windows; circular variants extend
    the virtual sequence by pad = ceil((l+1)/2)-1 with indices mod l.
    """
    b = lengths.shape[0]
    l = lengths.astype(jnp.int32)[:, None, None]                 # [B,1,1]
    k_ids = jnp.arange(mem_len, dtype=jnp.int32)[None, :, None]  # [1,M,1]

    # virtual length after circular pad
    pad = jnp.where(l > 0, (l + 2) // 2 - 1, 0) if circular else jnp.zeros_like(l)
    lv = l + pad

    stride = jnp.maximum(lv // mem_len, 1)
    kernel = lv - (mem_len - 1) * stride

    max_virtual = seq_len + (seq_len + 2) // 2 - 1 if circular else seq_len
    j_ids = jnp.arange(max_virtual, dtype=jnp.int32)[None, None, :]  # [1,1,Lv]

    # regime A: lv > mem_len — window k covers [k*stride, k*stride+kernel)
    in_win_a = jnp.logical_and(j_ids >= k_ids * stride,
                               j_ids < k_ids * stride + kernel)
    # regime B: lv <= mem_len — slot k covers position k - (mem_len - lv)
    in_win_b = j_ids == (k_ids - (mem_len - lv))
    in_win = jnp.where(lv > mem_len, in_win_a, in_win_b)
    in_win = jnp.logical_and(in_win, j_ids < lv)                  # [B,M,Lv]

    # fold virtual positions back onto real ones: real = j % l
    real = jnp.where(l > 0, j_ids % jnp.maximum(l, 1), 0)         # [B,1,Lv]
    real = jnp.broadcast_to(real, in_win.shape)
    onehot = jax.nn.one_hot(real, seq_len, dtype=jnp.float32)     # [B,M,Lv,L]
    sel = jnp.einsum("bmv,bmvl->bml", in_win.astype(jnp.float32), onehot)
    mem_mask = jnp.any(in_win, axis=2)
    return sel, mem_mask


def window_bounds(lengths: jnp.ndarray, mem_len: int, circular: bool):
    """Per-sample (start [B, M], kernel [B, M]) of each memory slot's window
    in the virtual (possibly circular-padded) sequence; kernel 0 for empty
    slots. Mirrors the two regimes of init_mem (pred.py:656-758)."""
    l = lengths.astype(jnp.int32)[:, None]                      # [B,1]
    k_ids = jnp.arange(mem_len, dtype=jnp.int32)[None, :]       # [1,M]
    pad = jnp.where(l > 0, (l + 2) // 2 - 1, 0) if circular else jnp.zeros_like(l)
    lv = l + pad
    stride = jnp.maximum(lv // mem_len, 1)
    kernel_a = lv - (mem_len - 1) * stride
    start_a = k_ids * stride
    # regime B (lv <= mem_len): slot k holds position k - (M - lv), kernel 1
    start_b = k_ids - (mem_len - lv)
    valid_b = start_b >= 0
    start = jnp.where(lv > mem_len, start_a, jnp.maximum(start_b, 0))
    kernel = jnp.where(lv > mem_len, kernel_a,
                       valid_b.astype(jnp.int32))
    return start, kernel, lv[:, 0]


class WindowLSTMMem(nn.Module):
    """lstm mem_init: per-slot LSTM over the window's elements, final hidden
    state as the slot value (init_mem lstm branches, pred.py:691-702,
    741-748) — static-shape via per-slot gathered windows + nn.RNN with
    seq_lengths."""

    features: int
    mem_len: int
    circular: bool = False

    @nn.compact
    def __call__(self, x, x_mask, train: bool = False):
        b, seq_len, d = x.shape
        if x_mask is None:
            lengths = jnp.full((b,), seq_len, jnp.int32)
        else:
            lengths = jnp.sum(x_mask.astype(jnp.int32), axis=1)
        start, kernel, lv = window_bounds(lengths, self.mem_len,
                                          self.circular)
        m = self.mem_len
        k_max = max(seq_len + (seq_len + 2) // 2 - 1 if self.circular
                    else seq_len - m + 1, 1)
        # gather window elements: virtual index start + j, folded mod l
        j = jnp.arange(k_max, dtype=jnp.int32)[None, None, :]   # [1,1,K]
        virt = start[:, :, None] + j                            # [B,M,K]
        real = jnp.where(lengths[:, None, None] > 0,
                         virt % jnp.maximum(lengths[:, None, None], 1), 0)
        win = jnp.take_along_axis(
            x[:, None, :, :].repeat(m, axis=1),
            jnp.minimum(real, seq_len - 1)[..., None].repeat(d, -1), axis=2)
        win = win.reshape(b * m, k_max, d)
        seq_lengths = jnp.minimum(kernel, k_max).reshape(b * m)
        rnn = nn.RNN(
            nn.OptimizedLSTMCell(
                self.features,
                kernel_init=get_initializer("uniform"),
                recurrent_kernel_init=get_initializer("uniform"),
                name="cell"),
            return_carry=True, name="lstm")
        carry, _outs = rnn(win, seq_lengths=seq_lengths)
        # LSTM carry = (c, h); reference uses hx[0].view(bsz, 1, -1) — torch
        # hx[0] is h
        h = carry[1] if isinstance(carry, tuple) else carry
        mem = h.reshape(b, m, self.features)
        mem_mask = kernel > 0
        mem = jnp.where(mem_mask[..., None], mem, 0.0)
        return mem, mem_mask


def init_mem_static(x: jnp.ndarray, x_mask: Optional[jnp.ndarray],
                    mem_len: int, mem_init: str,
                    attn: Optional[DotAttention] = None,
                    lstm: Optional[WindowLSTMMem] = None,
                    train: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched init_mem (pred.py:648-760) for mean/sum/max/attn (+circular)."""
    b, seq_len, d = x.shape
    if x_mask is None:
        lengths = jnp.full((b,), seq_len, jnp.int32)
        x_mask = jnp.ones((b, seq_len), bool)
    else:
        lengths = jnp.sum(x_mask.astype(jnp.int32), axis=1)
    circular = mem_init.startswith("circular")
    base = mem_init.split("_")[-1]

    sel, mem_mask = window_selection(lengths, seq_len, mem_len, circular)
    if base == "sum":
        mem = jnp.einsum("bml,bld->bmd", sel, x)
    elif base == "mean":
        cnt = jnp.maximum(sel.sum(-1, keepdims=True), 1.0)
        mem = jnp.einsum("bml,bld->bmd", sel, x) / cnt
    elif base == "max":
        big = jnp.where(sel[..., None] > 0, x[:, None, :, :], -_INF)
        mem = jnp.max(big, axis=2)
        mem = jnp.where(mem_mask[..., None], mem, 0.0)
    elif base == "attn":
        # window attention with query = window mean (pred.py:723-740)
        cnt = jnp.maximum(sel.sum(-1, keepdims=True), 1.0)
        qmean = jnp.einsum("bml,bld->bmd", sel, x) / cnt      # [B,M,D]
        if attn is not None:
            # attention restricted to each slot's window: flatten slots into
            # the batch so each slot attends over its own window mask
            q = qmean.reshape(b * mem_len, 1, d)
            k = jnp.repeat(x, mem_len, axis=0)
            win_mask = (sel > 0).reshape(b * mem_len, seq_len)
            out = attn(q, k, k, query_mask=None, key_mask=win_mask,
                       train=train)
            mem = out.reshape(b, mem_len, d)
        else:
            score = jnp.einsum("bmd,bld->bml", qmean, x) / math.sqrt(d)
            score = jnp.where(sel > 0, score, -_INF)
            score = jax.nn.softmax(score, axis=-1)
            score = jnp.where(sel > 0, score, 0.0)
            mem = jnp.einsum("bml,bld->bmd", score, x)
        mem = jnp.where(mem_mask[..., None], mem, 0.0)
    elif base == "lstm":
        if lstm is None:
            raise ValueError("lstm mem_init requires a WindowLSTMMem module")
        return lstm(x, x_mask, train=train)
    else:
        raise NotImplementedError(f"mem_init '{mem_init}'")
    return mem, mem_mask


# =============================================================================
# Attn predict nets (pred.py:490-641)
# =============================================================================

class BaseAttnPredictNet(PredictNet):
    num_heads: int = 4
    infer_steps: int = 1

    def _attns(self):
        kw = dict(
            hidden_dim=self.hidden_dim, num_heads=self.num_heads,
            scale=1.0 / math.sqrt(self.hidden_dim / self.num_heads),
            score_func="sparsemax", add_gate=True, param_init="identity",
        )
        return (DotAttention(name="p_attn", **kw),
                DotAttention(name="g_attn", **kw))

    def pre_transform(self, p_rep, p_mask, g_rep, g_mask, train):
        p_attn, g_attn = self._attns()
        g = g_rep
        for _ in range(self.infer_steps):
            g = p_attn(g, p_rep, p_rep, query_mask=g_mask, key_mask=p_mask,
                       train=train)
            g = g_attn(g, g, g, query_mask=g_mask, key_mask=g_mask,
                       train=train)
        return g


class MeanAttnPredictNet(BaseAttnPredictNet, MeanPredictNet):
    pass


class SumAttnPredictNet(BaseAttnPredictNet, SumPredictNet):
    pass


class MaxAttnPredictNet(BaseAttnPredictNet, MaxPredictNet):
    pass


# =============================================================================
# MemAttn predict nets (pred.py:763-1040)
# =============================================================================

class MemDotAttention(nn.Module):
    """DotAttention whose keys/values are first compressed into mem_len slots
    (pred.py:763-871)."""

    hidden_dim: int
    mem_dim: int
    mem_len: int = 4
    mem_init: str = "mean"
    num_heads: int = 1
    score_func: str = "sparsemax"
    add_gate: bool = True
    pre_lnorm: bool = True
    param_init: str = "identity"

    @nn.compact
    def __call__(self, query, key, value, query_mask=None, key_mask=None,
                 train: bool = False):
        proj_k = Dense(self.mem_dim, init=self.param_init, name="proj_k")
        proj_v = Dense(self.mem_dim, init=self.param_init, name="proj_v")
        inner_attn = None
        inner_lstm_k = inner_lstm_v = None
        if self.mem_init.endswith("attn"):
            inner_attn = DotAttention(
                hidden_dim=self.hidden_dim, num_heads=self.num_heads,
                scale=1.0 / math.sqrt(self.hidden_dim / self.num_heads),
                score_func=self.score_func, param_init=self.param_init,
                name="mem_attn")
        elif self.mem_init.endswith("lstm"):
            circ = self.mem_init.startswith("circular")
            inner_lstm_k = WindowLSTMMem(self.mem_dim, self.mem_len, circ,
                                         name="mem_lstm_k")
            inner_lstm_v = WindowLSTMMem(self.mem_dim, self.mem_len, circ,
                                         name="mem_lstm_v")
        mem_k, mem_k_mask = init_mem_static(
            proj_k(key), key_mask, self.mem_len, self.mem_init,
            attn=inner_attn, lstm=inner_lstm_k, train=train)
        mem_v, _ = init_mem_static(
            proj_v(value), key_mask, self.mem_len, self.mem_init,
            attn=inner_attn, lstm=inner_lstm_v, train=train)
        return DotAttention(
            hidden_dim=self.hidden_dim, num_heads=self.num_heads,
            scale=1.0, score_func=self.score_func, add_gate=self.add_gate,
            pre_lnorm=self.pre_lnorm, param_init=self.param_init,
            name="attn",
        )(query, mem_k, mem_v, query_mask=query_mask, key_mask=mem_k_mask,
          train=train)


class BaseMemAttnPredictNet(PredictNet):
    num_heads: int = 4
    infer_steps: int = 1
    mem_len: int = 4
    mem_init: str = "mean"

    def pre_transform(self, p_rep, p_mask, g_rep, g_mask, train):
        kw = dict(
            hidden_dim=self.hidden_dim, mem_dim=self.hidden_dim,
            mem_len=self.mem_len, mem_init=self.mem_init,
            num_heads=self.num_heads,
        )
        p_attn = MemDotAttention(name="p_attn", **kw)
        g_attn = MemDotAttention(name="g_attn", **kw)
        g = g_rep
        for _ in range(self.infer_steps):
            g = p_attn(g, p_rep, p_rep, query_mask=g_mask, key_mask=p_mask,
                       train=train)
            g = g_attn(g, g, g, query_mask=g_mask, key_mask=g_mask,
                       train=train)
        return g


class MeanMemAttnPredictNet(BaseMemAttnPredictNet, MeanPredictNet):
    pass


class SumMemAttnPredictNet(BaseMemAttnPredictNet, SumPredictNet):
    pass


class MaxMemAttnPredictNet(BaseMemAttnPredictNet, MaxPredictNet):
    pass


# =============================================================================
# DIAMNet (pred.py:1043-1328)
# =============================================================================

class DIAMNet(nn.Module):
    """Dynamic intermedium attention memory network."""

    hidden_dim: int
    act: str = "relu"
    num_heads: int = 4
    infer_steps: int = 1
    mem_len: int = 4
    mem_init: str = "mean"
    dropout: float = 0.0
    return_weights: bool = False

    @nn.compact
    def __call__(self, p_rep, p_mask, g_rep, g_mask, train: bool = False):
        h = self.hidden_dim
        act_fn = map_activation_str_to_fn(self.act)
        bsz, g_len = g_mask.shape
        pl = jnp.sum(p_mask.astype(jnp.float32), 1, keepdims=True)
        gl = jnp.sum(g_mask.astype(jnp.float32), 1, keepdims=True)
        pl_inv, gl_inv = 1.0 / pl, 1.0 / gl

        attn_kw = dict(
            hidden_dim=h, num_heads=self.num_heads,
            scale=1.0 / math.sqrt(h / self.num_heads),
            score_func="sparsemax", add_gate=True, param_init="identity",
        )

        # ---- memory init (input_dim -> mem_dim = hidden_dim) ----------------
        if self.mem_init.endswith("attn"):
            mem_layer = DotAttention(name="mem_layer", **attn_kw)
            m, m_mask = init_mem_static(g_rep, g_mask, self.mem_len,
                                        self.mem_init, attn=mem_layer,
                                        train=train)
        elif self.mem_init.endswith("lstm"):
            mem_layer = WindowLSTMMem(
                h, self.mem_len, self.mem_init.startswith("circular"),
                name="mem_layer")
            m, m_mask = init_mem_static(g_rep, g_mask, self.mem_len,
                                        self.mem_init, lstm=mem_layer,
                                        train=train)
        else:
            m, m_mask = init_mem_static(g_rep, g_mask, self.mem_len,
                                        self.mem_init, train=train)
            m = Dense(h, init="normal", name="mem_layer")(m)

        p_attn = DotAttention(name="p_attn", **attn_kw)
        g_attn = DotAttention(name="g_attn", **attn_kw)
        m_attn = DotAttention(name="m_attn", **attn_kw)

        for _ in range(self.infer_steps):
            m = p_attn(m, p_rep, p_rep, query_mask=m_mask, key_mask=p_mask,
                       train=train)
            m = g_attn(m, g_rep, g_rep, query_mask=m_mask, key_mask=g_mask,
                       train=train)

        drop = nn.Dropout(self.dropout)
        if self.return_weights:
            p = Dense(h, init="normal", activation=self.act, name="p_fc")(p_rep)
            p = m_attn(p, m, m, query_mask=p_mask, key_mask=m_mask, train=train)
            p = drop(p, deterministic=not train)
            if self.mem_init in ("max", "circular_max"):
                p = jnp.max(jnp.where(p_mask[..., None], p, 0.0), axis=1)
            elif self.mem_init in ("sum", "circular_sum"):
                p = jnp.sum(p * p_mask[..., None], axis=1)
            else:
                p = jnp.sum(p * p_mask[..., None], axis=1) / jnp.maximum(
                    jnp.max(pl), 1.0)
            p = p[:, None, :]                    # [B, 1, h]

            g = Dense(h, init="normal", activation=self.act, name="g_fc")(g_rep)
            g = m_attn(g, m, m, query_mask=g_mask, key_mask=m_mask, train=train)
            g = drop(g, deterministic=not train)

            # concat-free weight head (Dense parts=..., see models/pred.py)
            pl_e = pl[:, :, None]                # [B, 1, 1]
            pli_e = pl_inv[:, :, None]
            w = Dense(h, init="normal", activation=self.act,
                      name="weight_fc1")(
                parts=[p, g, g - p, g * p, pl_e, pli_e])
            w = act_fn(w)
            w = Dense(1, init="zero", name="weight_fc2")(
                parts=[w, pl_e, pli_e])[..., 0]
        else:
            w = None

        mflat = m.reshape(bsz, -1)
        y = jnp.concatenate([mflat, pl, gl, pl_inv, gl_inv], axis=1)
        y = Dense(h, init="normal", activation=self.act, name="pred_fc1")(y)
        y = act_fn(y)
        y = Dense(1, init="zero", name="pred_fc2")(
            jnp.concatenate([y, pl, gl, pl_inv, gl_inv], axis=1))
        return y, w


ATTN_PRED_NETS = {
    "MeanAttnPredictNet": MeanAttnPredictNet,
    "SumAttnPredictNet": SumAttnPredictNet,
    "MaxAttnPredictNet": MaxAttnPredictNet,
    "MeanMemAttnPredictNet": MeanMemAttnPredictNet,
    "SumMemAttnPredictNet": SumMemAttnPredictNet,
    "MaxMemAttnPredictNet": MaxMemAttnPredictNet,
    "DIAMNet": DIAMNet,
}
