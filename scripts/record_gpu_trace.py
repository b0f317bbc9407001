"""Record a small profiler trace of a GPU program, as a test fixture.

Runs three steps of a tiny jitted program (a row gather, a matmul and a
sorted scatter-add, each under a named scope) inside `jax.profiler.trace`
and copies the resulting `.xplane.pb` to OUT (default
`gpu_trace.xplane.pb`). It also prints every plane and line of
the trace with its event count and a few event names, which is how the
trace reduction in bench.py was written. tests/data/gpu_trace.xplane.pb
was made by this script on an NVIDIA H100.

Usage: python scripts/record_gpu_trace.py [OUT]
"""

from __future__ import annotations

import glob
import os
import shutil
import sys
import tempfile

STEPS = 3


def main(out: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        sys.exit("record_gpu_trace: JAX found no GPU")
    v, e, h = 4096, 32768, 64
    rng = np.random.default_rng(0)
    recv = jnp.asarray(np.sort(rng.integers(0, v, e)).astype(np.int32))
    send = jnp.asarray(rng.integers(0, v, e).astype(np.int32))
    table = jnp.asarray(rng.normal(size=(v, h)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(h, h)), jnp.float32)

    @jax.jit
    def step(table):
        with jax.named_scope("gather"):
            rows = table[send]
        with jax.named_scope("matmul"):
            msg = rows @ w
        with jax.named_scope("scatter"):
            agg = jnp.zeros((v, h), jnp.float32).at[recv].add(
                msg, indices_are_sorted=True)
        return jnp.tanh(agg)

    table = step(table).block_until_ready()
    logdir = tempfile.mkdtemp(prefix="gpu_trace_")
    with jax.profiler.trace(logdir):
        for _ in range(STEPS):
            table = step(table)
        table.block_until_ready()
    path = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    shutil.copy(path, out)
    print(f"trace: {out} ({os.path.getsize(out)} bytes), {STEPS} steps")

    from jax.profiler import ProfileData

    for plane in ProfileData.from_file(out).planes:
        lines = list(plane.lines)
        print(f"PLANE {plane.name!r}: {len(lines)} lines")
        for line in lines:
            evs = list(line.events)
            names = sorted({ev.name for ev in evs})
            print(f"  LINE {line.name!r}: {len(evs)} events; "
                  f"names {names[:8]}")
            for ev in evs[:3]:
                stats = list(ev.stats)
                print(f"    {ev.name!r} start {ev.start_ns} dur "
                      f"{ev.duration_ns} stats {str(stats)[:300]}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "gpu_trace.xplane.pb")
