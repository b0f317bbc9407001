"""Full-psum vs owner-sharded halo exchange: measured crossover study.

Runs both edge-partitioned DMP forward
paths (parallel/edge_partition.py = replicated node state + one [V, H]
psum per layer; parallel/halo.py = owned node slices + one boundary
all_to_all per layer) on the 8-way virtual CPU mesh over synthetic
graphs of varying locality, and reports per-device collective bytes per
layer plus measured wall time.

The CPU mesh measures algorithmic traffic, not interconnect time:
collectives are memcpys, so wall-clock favors whichever path moves fewer
bytes — exactly the quantity the crossover is about. On real cards the
ratio psum_bytes/halo_bytes translates to collective time at the
interconnect's rate (NVLink: 450 GB/s each way per H100).

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python scripts/halo_bench.py [--v 100000] [--edges 1000000,4000000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


def time_fn(fn, args, iters=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--v", type=int, default=100_000)
    ap.add_argument("--edges", type=str, default="1000000,4000000")
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    from dualmessagepassing_tpu.data.synthetic import (
        generate_community_graph, generate_large_graph)
    from dualmessagepassing_tpu.parallel import (
        init_edge_parallel_params, make_edge_parallel_dmp_apply,
        pad_to_multiple, shard_flat_edges)
    from dualmessagepassing_tpu.parallel.halo import (
        ARG_ORDER, build_halo_partition, make_halo_dmp_apply,
        shard_halo_arrays)

    n = 8
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("ep",))
    V, H, L = args.v, args.h, args.layers
    params = init_edge_parallel_params(jax.random.PRNGKey(0), L, H)

    for E in (int(x) for x in args.edges.split(",")):
        graphs = {
            "power_law": generate_large_graph(V, E, seed=0)[0],
            "community95": generate_community_graph(V, E, num_communities=n,
                                                    p_intra=0.95, seed=0)[0],
        }
        for gname, trip in graphs.items():
            senders = trip[:, 0].astype(np.int32)
            receivers = trip[:, 2].astype(np.int32)
            rev = np.zeros(E, bool)
            rng = np.random.default_rng(1)
            node_feat = rng.normal(size=(V, H)).astype(np.float32)
            edge_feat = rng.normal(size=(E, H)).astype(np.float32)

            # --- full-psum path -----------------------------------------
            arrays = pad_to_multiple({"senders": senders,
                                      "receivers": receivers,
                                      "rev_flag": rev}, n)
            ef = np.zeros((len(arrays["senders"]), H), np.float32)
            ef[:E] = edge_feat
            fwd_psum = jax.jit(make_edge_parallel_dmp_apply(
                mesh, V, num_layers=L))
            with mesh:
                sh = shard_flat_edges(mesh, arrays)
                t_psum = time_fn(
                    fwd_psum,
                    (params, jnp.asarray(node_feat), jnp.asarray(ef),
                     sh["senders"], sh["receivers"], sh["rev_flag"],
                     sh["edge_mask"]),
                    args.iters)

            # --- halo path (both partitioners) ---------------------------
            for method in ("range", "degree"):
                part = build_halo_partition(senders, receivers, rev, V, n,
                                            method=method)
                sharded = shard_halo_arrays(mesh, part, node_feat, edge_feat)
                fwd_halo = jax.jit(make_halo_dmp_apply(mesh, num_layers=L))
                with mesh:
                    t_halo = time_fn(
                        fwd_halo,
                        (params, *[sharded[k] for k in ARG_ORDER]),
                        args.iters)
                # per-device collective bytes per layer
                psum_bytes = 2 * V * H * 4            # ring all-reduce
                halo_bytes = n * part["B"] * H * 4    # all_to_all payload
                print(json.dumps({
                    "V": V, "E": E, "graph": gname, "partition": method,
                    "B_max": part["B"], "Vp": part["Vp"], "Ep": part["Ep"],
                    "psum_ms": round(t_psum, 2),
                    "halo_ms": round(t_halo, 2),
                    "speedup": round(t_psum / t_halo, 2),
                    "psum_MB_per_layer": round(psum_bytes / 2**20, 2),
                    "halo_MB_per_layer": round(halo_bytes / 2**20, 2),
                    "traffic_ratio": round(psum_bytes / max(halo_bytes, 1),
                                           2),
                }), flush=True)


if __name__ == "__main__":
    main()
