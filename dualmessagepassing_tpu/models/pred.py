"""Prediction (readout) networks: count regression + optional matching-weight
head over pooled pattern/graph representations.

Reference: /root/reference/SubgraphCountingMatching/models/pred.py:17-237
(PredictNet + Mean/Sum/Max pooling variants; attention/memory variants live in
pred_attn.py here).  Count head (pred.py:140-156):

    y = fc2( act(fc1([p, g, g-p, g*p, pl, gl, 1/pl, 1/gl])) ++ [pl, gl, 1/pl, 1/gl] )

Weight head per graph element (pred.py:114-136):

    w = fc2( act(fc1([p, g_j, g_j-p, g_j*p, pl, 1/pl])) ++ [pl, 1/pl] )

Pooling semantics under padding (parity-exact with the reference's dynamic
max-length batches):
  * sum  — masked sum (padded entries are zeroed upstream).
  * mean — sum / max_batch_len, where max_batch_len = max over the batch of
    true lengths (the reference divides by the padded max length, which is the
    batch max; our static envelope re-derives it from n_node/n_edge).
  * max  — max over entries with padding at 0 (the reference masks padded
    entries to 0 before max, inheriting the same clipping-at-0 behavior).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from .. import nn

from ..utils.amp import compute_dtype
from ..utils.act import map_activation_str_to_fn
from .layers import Dense


class PredictNet(nn.Module):
    """Base predict net; subclasses define `agg` (the pooling)."""

    hidden_dim: int
    act: str = "relu"
    dropout: float = 0.0
    return_weights: bool = False

    def agg(self, rep, mask, max_len):
        raise NotImplementedError

    def pre_transform(self, p_rep, p_mask, g_rep, g_mask, train):
        """Hook for Attn/MemAttn variants: transform g_rep before pooling
        (pred.py:554-559, 942-947). Base: identity."""
        return g_rep

    @nn.compact
    def __call__(
        self,
        p_rep: jnp.ndarray,   # [B, Lp, D] or [B, D]
        p_mask: jnp.ndarray,  # [B, Lp] bool
        g_rep: jnp.ndarray,   # [B, Lg, D]
        g_mask: jnp.ndarray,  # [B, Lg] bool
        train: bool = False,
    ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
        g_rep = self.pre_transform(p_rep, p_mask, g_rep, g_mask, train)
        act_fn = map_activation_str_to_fn(self.act)
        h = self.hidden_dim
        bsz, g_len = g_mask.shape

        pl = jnp.sum(p_mask.astype(jnp.float32), axis=1,
                     keepdims=True).astype(compute_dtype())  # [B,1]
        gl = jnp.sum(g_mask.astype(jnp.float32), axis=1,
                     keepdims=True).astype(compute_dtype())
        pl_inv, gl_inv = 1.0 / pl, 1.0 / gl
        # batch max true length == reference's padded max length
        p_max_len = jnp.max(pl)
        g_max_len = jnp.max(gl)

        drop = nn.Dropout(self.dropout)
        if p_rep.ndim == 2:
            p = p_rep
        else:
            p = Dense(h, init="normal", activation=self.act, name="p_fc")(p_rep)
            p = drop(p, deterministic=not train)
            p = self.agg(p, p_mask, p_max_len)

        g_el = Dense(h, init="normal", activation=self.act, name="g_fc")(g_rep)
        g_el = drop(g_el, deterministic=not train)

        if self.return_weights:
            # concat-free weight head (Dense parts=...): the [B, Lg, 4h+2]
            # input tensor never materializes — per-graph rows ([B, 1, *])
            # ride broadcasting through their partial products. Same
            # parameters and math as the reference concat (pred.py:87-156).
            pe = p[:, None, :]                    # [B, 1, h]
            pl_e = pl[:, :, None]                 # [B, 1, 1]
            pli_e = pl_inv[:, :, None]
            w = Dense(h, init="normal", activation=self.act,
                      name="weight_fc1")(
                parts=[pe, g_el, g_el - pe, g_el * pe, pl_e, pli_e])
            w = act_fn(w)
            w = Dense(1, init="zero", activation=self.act,
                      name="weight_fc2")(parts=[w, pl_e, pli_e])
            w = w[..., 0]
        else:
            w = None

        g = self.agg(g_el, g_mask, g_max_len)

        y = jnp.concatenate([p, g, g - p, g * p, pl, gl, pl_inv, gl_inv], axis=1)
        y = Dense(h, init="normal", activation=self.act, name="pred_fc1")(y)
        y = act_fn(y)
        y = Dense(1, init="zero", activation=self.act, name="pred_fc2")(
            jnp.concatenate([y, pl, gl, pl_inv, gl_inv], axis=1)
        )
        return y, w


class SumPredictNet(PredictNet):
    def agg(self, rep, mask, max_len):
        return jnp.sum(rep * mask[..., None], axis=1)


class MeanPredictNet(PredictNet):
    def agg(self, rep, mask, max_len):
        return jnp.sum(rep * mask[..., None], axis=1) / jnp.maximum(max_len, 1.0)


class MaxPredictNet(PredictNet):
    def agg(self, rep, mask, max_len):
        return jnp.max(jnp.where(mask[..., None], rep, 0.0), axis=1)


PRED_NETS = {
    "SumPredictNet": SumPredictNet,
    "MeanPredictNet": MeanPredictNet,
    "MaxPredictNet": MaxPredictNet,
}


def build_pred_net(name: str, hidden_dim: int, act: str, dropout: float,
                   return_weights: bool, **kw) -> PredictNet:
    """Factory mirroring create_pred_net (basemodel.py:1074-1366).

    Attention/memory variants are resolved lazily from pred_attn.py; extra
    kwargs (infer_steps, num_heads, mem_len, mem_init) are filtered down to
    the fields each class actually declares.
    """
    import dataclasses as _dc

    if name in PRED_NETS:
        cls = PRED_NETS[name]
    else:
        from .pred_attn import ATTN_PRED_NETS  # noqa: deferred to avoid cycle
        if name not in ATTN_PRED_NETS:
            raise ValueError(f"unknown pred_net '{name}'")
        cls = ATTN_PRED_NETS[name]
    fields = {f.name for f in _dc.fields(cls)}
    extra = {k: v for k, v in kw.items() if k in fields}
    return cls(hidden_dim=hidden_dim, act=act, dropout=dropout,
               return_weights=return_weights, **extra)
