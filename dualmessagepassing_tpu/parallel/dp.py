"""Data parallelism over (pattern, graph) pair batches.

SURVEY §2.4: the reference has NO distributed execution of any kind (single
--gpu_id device, train.py:1080-1083); DP here is new capability, built the
XLA way — GraphBatch leaves all carry the batch as axis 0, so data
parallelism is literally `NamedSharding(mesh, P("dp", ...))` on every leaf,
with parameters replicated and gradients all-reduced by pjit-inserted
psums.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_dp_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("dp",))


def batch_sharding(mesh: Mesh, tree: Any) -> Any:
    """Shard every array leaf along axis 0 ('dp'); scalars replicate."""
    def spec(x):
        if getattr(x, "ndim", 0) >= 1:
            return NamedSharding(mesh, P("dp", *([None] * (x.ndim - 1))))
        return NamedSharding(mesh, P())

    return jax.tree.map(spec, tree)


def replicated(mesh: Mesh, tree: Any) -> Any:
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda _: rep, tree)


def shard_batch(mesh: Mesh, *trees):
    """Device-put batch pytrees with dp sharding on axis 0."""
    out = tuple(
        jax.device_put(t, batch_sharding(mesh, t)) for t in trees
    )
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, *trees):
    out = tuple(
        jax.device_put(t, replicated(mesh, t)) for t in trees
    )
    return out if len(out) > 1 else out[0]
