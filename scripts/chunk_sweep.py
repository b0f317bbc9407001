"""Sweep (bsz, BENCH_CHUNKS) with the device-trace clock in ONE process.

Measures the flagship amp train step for each (bsz, chunks) config and
prints a JSON line per config: the data for choosing the auto-chunk rule
of make_train_step / bench.build_step (chunked scans bound each
microbatch's activation working set at some fixed cost per chunk).

Usage: python scripts/chunk_sweep.py "2048:1,2048:4,2048:16,512:1,512:4"
       (default sweep if no arg)
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    spec = (sys.argv[1] if len(sys.argv) > 1
            else "2048:1,2048:4,2048:8,2048:16,1024:4,512:1,512:4,256:2,128:1")
    iters = int(os.environ.get("SWEEP_ITERS", "4"))
    configs = []
    for part in spec.split(","):
        b, c = part.split(":")
        configs.append((int(b), int(c)))

    import bench
    from dualmessagepassing_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    info = bench.device_info()
    peak = bench.step_peak_flops(info["device_kind"], amp=True)
    for bsz, chunks in configs:
        os.environ["BENCH_CHUNKS"] = str(chunks)
        try:
            advance, state, flops = bench.build_step(bsz)
            step_ms, host_ms = bench.time_step(advance, state, iters)
            eps = bsz * (256 * 2 + 8 * 2) / (step_ms / 1e3)
            print(json.dumps({
                "bsz": bsz, "chunks": chunks, **info,
                "step_ms": round(step_ms, 3), "clock": "device_trace",
                "host_step_ms": round(host_ms, 3),
                "edges_per_sec": round(eps, 1),
                "mfu": round(flops / (step_ms / 1e3) / peak, 4),
            }), flush=True)
        except Exception as e:  # keep sweeping past OOM/compile failures
            print(json.dumps({"bsz": bsz, "chunks": chunks,
                              "error": str(e)[:200]}), flush=True)


if __name__ == "__main__":
    main()
