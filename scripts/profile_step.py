"""Per-kernel breakdown of a train step from one device trace.

Builds the bench step (`--workload scm`: the flagship SCM step;
`--workload unc`: the UNC step at the bench envelope), traces `--iters`
steps after a warmup, and prints, per GPU kernel: time per step, calls per
step, op class (scatter / gather / matmul / other), the bytes its HLO
instruction's operands and result hold, and its share of the device-memory
roofline (bytes at the card's peak bandwidth over measured time). A
summary line gives each op class's share of the step. Bytes are counted
from shapes, so a share is a lower bound on how far a kernel is from its
roofline.

Usage: python scripts/profile_step.py [--workload unc] [--iters 5]
       [--top 25] [--bsz 128] [--out FILE]
Env:   BENCH_AMP / BENCH_UNC_V / BENCH_UNC_E / BENCH_UNC_ENDPOINTS as in
       bench.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=["scm", "unc"], default="unc")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--bsz", type=int, default=128)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import jax

    import bench
    from dualmessagepassing_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    info = bench.device_info()
    hbm = bench.device_peaks(info["device_kind"])["hbm"]
    if args.workload == "unc":
        v = int(os.environ.get("BENCH_UNC_V", "65536"))
        e = int(os.environ.get("BENCH_UNC_E", "524288"))
        advance, state, _ = bench.build_unc_step(v, e)
        shape = {"v": v, "e": e, **bench.unc_lever_flags()}
    else:
        advance, state, _ = bench.build_step(args.bsz)
        shape = {"bsz": args.bsz}
    sizes = bench.hlo_instruction_bytes(advance.compiled.as_text())

    for _ in range(2):
        state = advance(state)
    jax.block_until_ready(state)
    logdir = tempfile.mkdtemp(prefix="profile_step_")
    with jax.profiler.trace(logdir):
        for _ in range(args.iters):
            state = advance(state)
        jax.block_until_ready(state)

    step_ms = bench.device_step_ms(logdir, args.iters)
    rows = []
    by_class: dict = {}
    for name, (ns, calls) in bench.kernel_breakdown(logdir).items():
        ms = ns / 1e6 / args.iters
        cls = bench.kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        nbytes = sizes.get(name)
        per_call_s = ns / 1e9 / max(calls, 1)
        rows.append({
            "kernel": name, "class": cls, "ms_per_step": round(ms, 4),
            "calls_per_step": calls / args.iters,
            "bytes": nbytes,
            "roofline_share": (round(nbytes / hbm / per_call_s, 4)
                               if nbytes and per_call_s > 0 else None)})
    rows.sort(key=lambda r: -r["ms_per_step"])
    for r in rows[:args.top]:
        print(json.dumps(r))
    total = sum(by_class.values())
    summary = {
        "metric": "kernel_breakdown", "workload": args.workload, **info,
        **shape, "device_step_ms": round(step_ms, 4),
        "kernel_ms_sum": round(total, 4),
        "class_ms": {k: round(x, 4) for k, x in by_class.items()},
        "class_share": {k: round(x / total, 4) for k, x in by_class.items()},
        "hbm_bytes_per_s_peak": hbm}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
