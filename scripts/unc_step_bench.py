"""A/B of UNC train-step variants on the device-trace clock, in one process.

Builds bench.build_unc_step for each variant at the bench envelope
(V=65536, E=524288, H=50, 2 layers, bf16 amp, sorted XLA scatter) and
times them in alternating rounds (A B B A ...), so drift of the card's
clock or neighbours falls on every variant alike. Prints one JSON line
per round and a summary line with each variant's median step time.

Variants: `split` (the default), `fused` (one gather over both endpoint
streams), `f32` (amp off).

Usage: python scripts/unc_step_bench.py [--variants split,fused]
       [--rounds 4] [--iters 5] [--v 65536] [--e 524288]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {
    "split": {"amp": True, "endpoints": "split"},
    "fused": {"amp": True, "endpoints": "fused"},
    "f32": {"amp": False, "endpoints": "split"},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="split,fused")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--v", type=int, default=65536)
    ap.add_argument("--e", type=int, default=524288)
    args = ap.parse_args(argv)

    import bench
    from dualmessagepassing_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    info = bench.device_info()
    names = args.variants.split(",")
    built = {n: bench.build_unc_step(args.v, args.e, flags=VARIANTS[n])
             for n in names}
    times = {n: [] for n in names}
    for r in range(args.rounds):
        order = names if r % 2 == 0 else names[::-1]
        for n in order:
            advance, state, _ = built[n]
            dev_ms, host_ms = bench.time_step(advance, state, args.iters)
            times[n].append(dev_ms)
            print(json.dumps({"round": r, "variant": n,
                              "device_step_ms": dev_ms,
                              "host_step_ms": host_ms}), flush=True)
    print(json.dumps({
        "metric": "unc_step_ab", **info, "v": args.v, "e": args.e,
        "iters": args.iters, "rounds": args.rounds,
        "median_device_step_ms": {n: statistics.median(t)
                                  for n, t in times.items()},
        "flags": {n: VARIANTS[n] for n in names}}), flush=True)


if __name__ == "__main__":
    main()
