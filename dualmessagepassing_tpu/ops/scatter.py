"""Message-passing primitives: gather / segment-sum / SDDMM shapes.

The JAX replacement for DGL's fused `update_all`/`apply_edges` kernels that
the reference delegates all message passing to (dmpnn.py:163-164,
compgcn.py:271-272, rgcn.py:196, rgin.py:159). Per SURVEY.md §2.3 these are
three primitives, not a UDF framework:

  * `gather_nodes`   — edge-wise gather of node rows (src or dst)
  * `scatter_sum_*`  — segment-sum of per-edge messages into node slots
  * per-edge fused compute stays ordinary jnp and lets XLA fuse

Two interchangeable backends:

  * ``onehot``  — express scatter/gather as one-hot einsums. Batched matmuls
    beat XLA's scatter on the small-graph envelopes of
    the SCM workload (V<=128, E<=512).  O(E*V*H) FLOPs, which for these sizes
    is cheaper than the memory-bound scatter it replaces.
  * ``segment`` — `.at[].add()` scatter-add (XLA scatter) for large flat
    graphs where O(E*V) is not affordable.

All functions take explicit masks; padded edges contribute zero.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

Array = jnp.ndarray

# Default V threshold under which the one-hot path replaces XLA scatter
# (chosen on earlier hardware; the GPU A/B is ROADMAP S7).
_DENSE_V_LIMIT = 2048


def gather_nodes(node_feat: Array, idx: Array,
                 method: Optional[str] = None,
                 precision=None) -> Array:
    """Gather node rows per edge.

    node_feat: [B, V, H]; idx: [B, E] -> [B, E, H].

    ``onehot`` (auto-selected for V <= _DENSE_V_LIMIT) expresses the gather
    as `one_hot(idx) @ node_feat` — a batched matmul whose TRANSPOSE is
    also a matmul.  The ``take`` path's transpose is an XLA scatter; the
    one-hot form removes every scatter from the fwd+bwd path.  ``take``
    remains for large V where O(E*V*H) FLOPs are unaffordable.

    Numerics: at DEFAULT matmul precision the one-hot contraction rounds
    the gathered f32 values (to TF32 on the GPU; ``take`` is exact). The
    production training configuration is bf16 compute anyway
    (utils/amp) — pass ``precision=jax.lax.Precision.HIGHEST`` or
    ``method="take"`` where exact f32 gathers matter.
    """
    v = node_feat.shape[-2]
    if method is None:
        method = "onehot" if v <= _DENSE_V_LIMIT else "take"
    if method == "onehot":
        oh = jax.nn.one_hot(idx, v, dtype=node_feat.dtype)
        return jnp.einsum("...ev,...vh->...eh", oh, node_feat,
                          precision=precision)
    # "take" (and the scatter backend name "segment", accepted as an alias
    # so layers can share one method flag)
    return jnp.take_along_axis(node_feat, idx[..., None], axis=-2)


def gather_scalars(table: Array, idx: Array,
                   method: Optional[str] = None,
                   precision=None) -> Array:
    """Gather per-node scalars per edge: table [B, V]; idx [B, E] -> [B, E].

    Same onehot-vs-take tradeoff (and DEFAULT-precision rounding note) as
    gather_nodes. Degree tables stay exact in bf16 up to 256;
    larger-degree envelopes should pass method="take".
    """
    v = table.shape[-1]
    if method is None:
        method = "onehot" if v <= _DENSE_V_LIMIT else "take"
    if method == "onehot":
        oh = jax.nn.one_hot(idx, v, dtype=table.dtype)
        return jnp.einsum("...ev,...v->...e", oh, table,
                          precision=precision)
    return jnp.take_along_axis(table, idx, axis=-1)


def scatter_sum_edges(
    messages: Array,
    receivers: Array,
    edge_mask: Array,
    num_nodes: int,
    method: Optional[str] = None,
) -> Array:
    """Masked segment-sum of per-edge messages into node slots.

    messages: [B, E, H]; receivers: [B, E] int; edge_mask: [B, E] bool
    -> [B, V, H].

    Equivalent of DGL's builtin reducer `fn.sum(msg, out)` (reference
    dmpnn.py:92) over a padded batch.
    """
    if method is None:
        method = "onehot" if num_nodes <= _DENSE_V_LIMIT else "segment"
    msg = jnp.where(edge_mask[..., None], messages, 0)
    if method == "onehot":
        # [B, E, V] one-hot of receivers; padded edges all-zero rows.
        oh = _masked_onehot(receivers, edge_mask, num_nodes, msg.dtype)
        # [B,E,V]^T x [B,E,H] -> [B,V,H]: a batched matmul.
        return jnp.einsum("bev,beh->bvh", oh, msg)
    elif method in ("segment", "take"):
        # "take" accepted as an alias so layers can share one method flag
        # with the gathers (which accept "segment" the same way)
        return jax.vmap(
            lambda m, r: jnp.zeros((num_nodes,) + m.shape[1:], m.dtype).at[r].add(m)
        )(msg, receivers)
    raise ValueError(f"unknown scatter method: {method}")


def scatter_sum_flat(
    messages: Array,
    receivers: Array,
    edge_mask: Array,
    num_nodes: int,
    indices_sorted: bool = False,
) -> Array:
    """Flat-graph segment-sum: messages [E, H], receivers [E] -> [V, H].

    Pass ``indices_sorted=True`` when the caller guarantees receivers are
    non-decreasing (e.g. host-side CSR sort); the hint silently corrupts
    the sum on unsorted input.
    """
    msg = jnp.where(edge_mask[..., None], messages, 0)
    return (
        jnp.zeros((num_nodes,) + msg.shape[1:], msg.dtype)
        .at[receivers]
        .add(msg, indices_are_sorted=indices_sorted)
    )


def scatter_max_edges(
    messages: Array,
    receivers: Array,
    edge_mask: Array,
    num_nodes: int,
    neg_inf: float = -1e30,
) -> Array:
    """Masked segment-max (used by max-style readouts over incident edges)."""
    msg = jnp.where(edge_mask[..., None], messages, neg_inf)
    out = jax.vmap(
        lambda m, r: jnp.full((num_nodes,) + m.shape[1:], neg_inf, m.dtype)
        .at[r]
        .max(m)
    )(msg, receivers)
    return jnp.where(out <= neg_inf / 2, 0.0, out)


def segment_softmax_edges(
    scores: Array,
    receivers: Array,
    edge_mask: Array,
    num_nodes: int,
) -> Array:
    """Per-destination softmax over incident edges (attention-style GNNs).

    scores: [B, E] -> [B, E] normalized within each receiver segment.
    """
    neg_inf = -1e30
    s = jnp.where(edge_mask, scores, neg_inf)
    seg_max = jax.vmap(
        lambda m, r: jnp.full((num_nodes,), neg_inf, m.dtype).at[r].max(m)
    )(s, receivers)
    s = s - jnp.take_along_axis(seg_max, receivers, axis=1)
    ex = jnp.where(edge_mask, jnp.exp(s), 0.0)
    seg_sum = jax.vmap(
        lambda m, r: jnp.zeros((num_nodes,), m.dtype).at[r].add(m)
    )(ex, receivers)
    denom = jnp.take_along_axis(seg_sum, receivers, axis=1)
    return ex / jnp.maximum(denom, 1e-30)


def _masked_onehot(idx: Array, mask: Array, n: int, dtype) -> Array:
    oh = jax.nn.one_hot(idx, n, dtype=dtype)
    return jnp.where(mask[..., None], oh, 0)
