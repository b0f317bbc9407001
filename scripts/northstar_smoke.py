"""100M-edge north-star DATA-PATH smoke (host side, no accelerator needed).

Exercises the full large-graph input pipeline at the SURVEY's 100M-edge
target: power-law generator -> WholeGraph CSR (both directions) ->
random-walk subgraph sampling -> static padding -> owner-sharded halo
partition.

Measured on this rig (4-core host, 125 GB RAM; 2026-08-18):
    generate 100M edges                         94 s
    WholeGraph CSR (200M directed edges)       127 s  (one-time)
    random-walk sample (10k-edge batch, d3w10)   9.8 s -> 0.92M V / 5.6M E
    pad_subgraph                                 0.3 s
    halo partition (degree) + pass plans         7.3 s
(host times; the pass plans have since been removed)

The per-batch work (sample + pad + partition) runs inside train_unc's
sampler prefetch threads, so steady-state epoch time approaches
n_batches * sample_time / n_workers.

Usage: python scripts/northstar_smoke.py [V] [E]   (defaults 1M / 100M;
       needs ~(24 bytes + CSR) * E host RAM — ~8 GB at the default)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not os.environ.get("DMP_EXAMPLE_ACCEL"):
    jax.config.update("jax_platforms", "cpu")

from dualmessagepassing_tpu.data.synthetic import generate_large_graph  # noqa: E402
from dualmessagepassing_tpu.parallel.halo_unc import (  # noqa: E402
    build_halo_sub, halo_envelope)
from dualmessagepassing_tpu.unc.data import (  # noqa: E402
    WholeGraph, compute_edgenorm, convert_subgraph_nids, negative_sampling,
    pad_subgraph, sample_subgraph_by_randomwalks)


def main():
    V = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    E = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000_000

    t0 = time.perf_counter()
    triplets, _ = generate_large_graph(V, E, num_rels=4, seed=0,
                                       power_law=True)
    print(f"generate {E/1e6:.0f}M edges: {time.perf_counter()-t0:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    g = WholeGraph(V, 4, triplets)
    print(f"WholeGraph CSR (both directions): {time.perf_counter()-t0:.1f}s "
          f"({g.num_edges} directed edges)", flush=True)

    rng = np.random.default_rng(0)
    batch = triplets[rng.integers(0, E, 10_000)]
    t0 = time.perf_counter()
    neg = negative_sampling(batch, V, 5, rng)
    seeds = np.unique(np.concatenate(
        [batch[:, 0], batch[:, 2], neg[:, 0], neg[:, 2]]))
    sub = sample_subgraph_by_randomwalks(g, seeds, depth=3, width=10, rng=rng)
    print(f"random-walk sample (10k-edge batch, depth 3 width 10): "
          f"{time.perf_counter()-t0:.1f}s -> {len(sub['nid'])} nodes / "
          f"{len(sub['senders'])} edges", flush=True)

    samples = np.concatenate([batch, neg]).copy()
    samples[:, 0] = convert_subgraph_nids(samples[:, 0], sub["nid"])
    samples[:, 2] = convert_subgraph_nids(samples[:, 2], sub["nid"])
    labels = np.zeros(len(samples), np.float32)
    labels[: len(batch)] = 1.0
    v_max = len(sub["nid"]) + 1000
    e_max = len(sub["senders"]) + 4096
    t0 = time.perf_counter()
    padded = pad_subgraph(sub, samples, labels, v_max, e_max, len(samples),
                          edge_norm=compute_edgenorm(sub))
    print(f"pad_subgraph: {time.perf_counter()-t0:.1f}s", flush=True)

    vp, epv, b = halo_envelope(v_max, e_max, 8)
    t0 = time.perf_counter()
    dev, _meta = build_halo_sub(padded, 8, vp, epv, b, method="degree")
    print(f"halo partition (degree): "
          f"{time.perf_counter()-t0:.1f}s; boundary rows "
          f"{int(dev['send_mask'].sum())}", flush=True)
    print("north-star data path OK", flush=True)


if __name__ == "__main__":
    main()
