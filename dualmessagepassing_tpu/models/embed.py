"""Encoders (frozen tables) and trainable embedding projections.

Reference: /root/reference/SubgraphCountingMatching/models/embed.py:105-222.
Encoders are frozen lookup tables (multi-hot digit encodings or sinusoidal
positions) materialized host-side (ops/encoding.py) and constant-folded into
the XLA program; embeddings are trainable projections of those encodings.

Both accept integer ids (table lookup) or float one-hot/enc rows (matmul) —
the dual calling convention of the reference `Embedding.forward`
(embed.py:109-118).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from .. import nn

from ..utils.amp import compute_dtype
from ..ops.encoding import get_enc_len, multihot_table, position_table
from ..utils.init import kaiming_normal


def _apply_table(table: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Integer ids -> rows; float [...,N] -> matmul with the table.

    Small-table id lookups go through one_hot @ table instead of an XLA
    gather: the one-hot form is a small matmul whose TRANSPOSE is also a
    matmul (scatter-free backward for trainable tables), where a narrow-row
    gather's backward is a scatter (ARCHITECTURE §8.6; the GPU A/B is
    ROADMAP S7). Ids are clipped to match gather's out-of-bounds clamping.

    Precision: exact under amp (bf16 tables — one_hot rows are 0/1, f32
    accumulate selects one bf16 row verbatim). An f32 table is forced to
    HIGHEST dot precision so the selection stays bit-exact like the
    gather it replaces — a default-precision (TF32 or bf16) matmul would
    round the f32 values.
    """
    if jnp.issubdtype(x.dtype, jnp.integer):
        n = table.shape[0]
        if n <= 2048:  # consistent with ops/scatter._DENSE_V_LIMIT
            oh = jax.nn.one_hot(jnp.clip(x, 0, n - 1), n, dtype=table.dtype)
            prec = ("highest"
                    if jnp.dtype(table.dtype) == jnp.float32 else None)
            return jnp.matmul(oh, table, precision=prec)
        return table[x]
    if x.shape[-1] == table.shape[0]:
        return x @ table
    raise ValueError(
        f"embedding input last dim {x.shape[-1]} != num_embeddings {table.shape[0]}"
    )


class MultihotEncoder(nn.Module):
    """Frozen multi-hot base-`base` digit encoding (embed.py:197-208)."""

    max_n: int
    base: int = 2

    @property
    def features(self) -> int:
        return get_enc_len(self.max_n - 1, self.base) * self.base

    @nn.compact
    def __call__(self, x):
        table = jnp.asarray(multihot_table(self.max_n, self.base),
                            dtype=compute_dtype())
        return _apply_table(table, x)


class PositionEncoder(nn.Module):
    """Frozen sinusoidal position encoding (embed.py:211-222)."""

    features: int
    max_len: int = 512
    scale: float = 1.0

    @nn.compact
    def __call__(self, x):
        table = jnp.asarray(
            position_table(self.features, self.max_len, self.scale),
            dtype=compute_dtype())
        return _apply_table(table, x)


class Embedding(nn.Module):
    """Trainable embedding with init-by-name.

    init semantics follow the reference classes (embed.py:124-194):
      * "normal"      — N(0, 1)
      * "uniform"     — U(-1, 1)
      * "orthogonal"  — orthogonal rows
      * "equivariant" — circulant: row i = roll(row 0, i), row 0 ~ N(0, 1)
    The reference's EquivariantEmbedding trains the full materialized matrix
    (forward always consumes `self.weight`, embed.py:182-187), so we do the
    same: circulant *init*, dense trainable weight.

    `scale` multiplies the weight once at init — this folds in the
    1/(enc_dim//base) rescale of GraphAdjModelV2.create_emb_net
    (basemodel.py:1066-1071).
    """

    num_embeddings: int
    features: int
    weight_init: str = "orthogonal"   # named weight_init: `init` would
    scale: float = 1.0                # shadow nn.Module.init

    def _init_fn(self):
        init = self.weight_init

        def f(key, shape, dtype=jnp.float32):
            n, d = shape
            if init == "normal":
                w = jax.random.normal(key, shape, dtype)
            elif init == "uniform":
                w = jax.random.uniform(key, shape, dtype, minval=-1.0, maxval=1.0)
            elif init == "orthogonal":
                w = jax.nn.initializers.orthogonal()(key, shape, dtype)
            elif init == "equivariant":
                row = jax.random.normal(key, (d,), dtype)
                idx = (jnp.arange(d)[None, :] - jnp.arange(n)[:, None]) % d
                w = row[idx]
            else:
                raise ValueError(f"unknown embedding init '{init}'")
            return w * self.scale

        return f

    @nn.compact
    def __call__(self, x):
        w = self.param("weight", self._init_fn(), (self.num_embeddings, self.features))
        return _apply_table(w, x)
