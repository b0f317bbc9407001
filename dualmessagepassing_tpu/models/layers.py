"""Shared neural building blocks: reference-initialized Dense, masked
BatchNorm, and the 2-layer update MLPs used by the GNN layers.

The reference composes update MLPs as Linear-[BatchNorm1d]-act-Linear
(dmpnn.py:45-60). Under padding, BatchNorm statistics must ignore padded
rows, hence MaskedBatchNorm here.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from .. import nn

from ..utils.act import map_activation_str_to_fn
from ..utils.init import calculate_gain, get_initializer


class Dense(nn.Module):
    """x @ W + b with gain-aware init-by-name (utils/init.py:146-166)."""

    features: int
    use_bias: bool = True
    init: str = "uniform"
    activation: str = "none"

    @nn.compact
    def __call__(self, x=None, parts=None):
        """x @ W + b, or — with `parts` — the concat-free equivalent
        `concat(parts, -1) @ W + b == sum_i parts[i] @ W[off_i:off_i+k_i]`.

        `parts` avoids materializing wide concatenations feeding the
        matmul (the flagship's [B, E, 4h+2] weight-head input cost
        ~2 ms/step at bsz 2048 as a real HBM tensor); broadcastable
        parts (e.g. a per-graph [B, 1, h] row against per-element
        [B, L, h] streams) contribute a rank-broadcast partial product
        that XLA adds without expansion. Parameters are IDENTICAL to the
        concat form (one kernel sized by the summed width)."""
        if parts is not None:
            din = sum(p.shape[-1] for p in parts)
            w = self.param(
                "kernel",
                get_initializer(self.init, self.activation),
                (din, self.features),
            )
            off = 0
            y = None
            for p in parts:
                k = p.shape[-1]
                term = p @ w[off: off + k]
                y = term if y is None else y + term
                off += k
        else:
            w = self.param(
                "kernel",
                get_initializer(self.init, self.activation),
                (x.shape[-1], self.features),
            )
            y = x @ w
        if self.use_bias:
            b = self.param("bias", nn.initializers.zeros, (self.features,))
            y = y + b
        return y


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the element axis using only mask-valid rows.

    Equivalent to the reference applying nn.BatchNorm1d to the flat node/edge
    table of a DGL batch (which has no padding); here the batch is padded, so
    mean/var are computed over masked entries. Running statistics follow the
    torch default momentum 0.1.
    """

    momentum: float = 0.9  # decay of the running average (1 - torch momentum)
    epsilon: float = 1e-5
    # psum partial sums/counts over this shard_map axis so statistics are
    # global when rows are sharded (edge partitioning). Also correct for
    # replicated rows: the shard factor cancels in sum/count ratios.
    axis_name: Optional[str] = None

    @nn.compact
    def __call__(self, x, mask=None, train: bool = False):
        # x: [..., H]; mask broadcastable to x[..., 0]
        features = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean", lambda: jnp.zeros((features,)))
        ra_var = self.variable("batch_stats", "var", lambda: jnp.ones((features,)))
        gamma = self.param("scale", nn.initializers.ones, (features,))
        beta = self.param("bias", nn.initializers.zeros, (features,))

        def _psum(v):
            return jax.lax.psum(v, self.axis_name) if self.axis_name else v

        if train:
            # statistics ALWAYS in f32: bf16 inputs (utils/amp) cannot
            # represent row counts above 256 and sum-reductions over large
            # element tables accumulate bf16 rounding — a no-op for f32
            xf = x.astype(jnp.float32)
            if mask is None:
                cnt = _psum(jnp.asarray(x[..., 0].size, jnp.float32))
                mean = _psum(jnp.sum(xf, axis=tuple(range(x.ndim - 1)))) / cnt
                var = _psum(jnp.sum((xf - mean) ** 2,
                                    axis=tuple(range(x.ndim - 1)))) / cnt
            else:
                m = mask.astype(jnp.float32)[..., None]
                cnt = jnp.maximum(_psum(jnp.sum(m)), 1.0)
                mean = _psum(jnp.sum(xf * m, axis=tuple(range(x.ndim - 1)))) / cnt
                var = (
                    _psum(jnp.sum(((xf - mean) ** 2) * m,
                                  axis=tuple(range(x.ndim - 1)))) / cnt
                )
            if not self.is_initializing():
                ra_mean.value = self.momentum * ra_mean.value + (1 - self.momentum) * mean
                # unbiased running var, as torch does
                unbiased = var * cnt / jnp.maximum(cnt - 1.0, 1.0)
                ra_var.value = self.momentum * ra_var.value + (1 - self.momentum) * unbiased
        else:
            mean, var = ra_mean.value, ra_var.value

        y = (x - mean.astype(x.dtype)) * jax.lax.rsqrt(
            var + self.epsilon).astype(x.dtype)
        return y * gamma + beta


class UpdateMLP(nn.Module):
    """num_layers x Dense with [BN]-act between layers (none after the last).

    Mirrors the nmlp/emlp construction in DMPLayer (dmpnn.py:45-60) and the
    GIN update MLP (rgin.py).
    """

    features: int
    num_layers: int = 2
    batch_norm: bool = False
    act: str = "relu"
    init: str = "uniform"

    @nn.compact
    def __call__(self, x, mask=None, train: bool = False):
        act_fn = map_activation_str_to_fn(self.act)
        for i in range(self.num_layers):
            x = Dense(self.features, init=self.init, activation=self.act,
                      name=f"fc{i}")(x)
            if i != self.num_layers - 1:
                if self.batch_norm:
                    x = MaskedBatchNorm(name=f"bn{i}")(x, mask=mask, train=train)
                x = act_fn(x)
        return x
