"""Edge-partitioned dual message passing with shard_map.

Edges (and the E-major dual state) are sharded over an 'ep' axis; each
shard computes a partial segment-sum into the replicated node array and
one psum per layer combines them — the graph analog of sequence
parallelism.

On CPU: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
            python examples/edge_parallel.py
On a machine with GPUs set DMP_EXAMPLE_ACCEL=1 to keep the real devices.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if not os.environ.get("DMP_EXAMPLE_ACCEL"):
    # must run before any backend initialization
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from dualmessagepassing_tpu.parallel.edge_partition import (  # noqa: E402
    init_edge_parallel_params, make_edge_parallel_dmp_apply,
    pad_to_multiple, shard_flat_edges)


def main():
    devices = np.asarray(jax.devices())
    mesh = Mesh(devices, axis_names=("ep",))
    n_shards = len(devices)
    print(f"mesh: {n_shards} devices on axis 'ep'")

    rng = np.random.default_rng(0)
    V, E, H = 64, 4096, 32
    arrays = pad_to_multiple({
        "senders": rng.integers(0, V, E),
        "receivers": rng.integers(0, V, E),
        "rev_flag": rng.integers(0, 2, E).astype(bool),
    }, n_shards)

    params = init_edge_parallel_params(jax.random.PRNGKey(0),
                                       num_layers=2, hidden=H)
    fwd = make_edge_parallel_dmp_apply(mesh, V, num_layers=2)
    node_feat = jnp.asarray(rng.normal(size=(V, H)), jnp.float32)
    edge_feat = np.asarray(rng.normal(
        size=(len(arrays["senders"]), H)), np.float32)
    edge_feat[~arrays["edge_mask"]] = 0.0

    with mesh:
        sharded = shard_flat_edges(mesh, arrays)
        v_out, e_out = jax.jit(fwd)(
            params, node_feat, jnp.asarray(edge_feat),
            sharded["senders"], sharded["receivers"],
            sharded["rev_flag"], sharded["edge_mask"])
    print("node out:", v_out.shape, "edge out:", e_out.shape,
          "edge shards:", len(e_out.sharding.device_set))


if __name__ == "__main__":
    main()
