"""Benchmark harness: DMPNN training-step throughput on the flagship config.

Measures edges/second (pattern+graph edges, reversed included) of the full
jitted training step (forward + backward + AdamW update) on the Complex
dataset envelope (reference README.md:88-92: pattern 8V/8E, graph 64V/256E,
16 labels) with reversed-edge augmentation — the heaviest published SCM
configuration.

Timing method:
  * the clock is the DEVICE trace — steps run under jax.profiler.trace and
    the per-step time is the union of the GPU's kernel intervals in the
    trace (`device_step_ms`). A run whose trace holds no GPU device
    activity fails; there is no host-clock fallback. The host-blocked time
    is reported beside it as `host_step_ms`.
  * FLOPs/step come from compiled.cost_analysis(); MFU divides by the
    dense peak of the card for the step's compute type (`PEAKS`, keyed by
    device_kind). A device kind that is not in the table is an error, and
    an implied MFU above 1.0 fails the run (the clock would be lying).
  * a batch-size scaling check (BENCH_SCALECHECK=1, default on) re-times
    at bsz/4 and fails if step time does not grow with batch size.

By default the step runs the production mixed-precision configuration
(bf16 compute, f32 master params — utils/amp.py, validated by
tests/test_amp.py; disclosed as "amp": true in the JSON). BENCH_AMP=0
measures float32 (TF32 matmuls at default precision; BENCH_PRECISION=
highest for full float32).

Prints ONE JSON line: {"metric", "value", "unit", ...extras}, naming the
platform, device kind, device count, and the card's name and power limit.

Workloads (BENCH_WORKLOAD):
  scm (default)  SCM train step (above).
  unc            UNC train step, Yelp-ish envelope (main_unc docstring).
  scm_infer      forward-only SCM serving latency/throughput — mirrors the
                 reference's per-sample eval forward time (train.py:939-940).
  unc_infer      forward-only UNC embedding export (main.py:184-209), the
                 full-graph eval pass.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Dense peaks of one card, by jax device_kind: NVIDIA's H100 data sheet,
# SXM part, without sparsity, at the full 700 W power limit. FLOP/s per
# compute type; bytes/s of device memory.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12, "tf32": 495e12, "f32": 67e12, "hbm": 3.35e12},
}


def device_peaks(kind: str) -> dict:
    """The peak table row of a device kind; unknown kinds are an error."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no peak rates recorded for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def step_peak_flops(kind: str, amp: bool) -> float:
    """Peak FLOP/s for the step's matmul type: bf16 under amp, else TF32
    at default precision or float32 at BENCH_PRECISION=highest."""
    peaks = device_peaks(kind)
    if amp:
        return peaks["bf16"]
    return peaks["f32"] if os.environ.get("BENCH_PRECISION") == "highest" \
        else peaks["tf32"]


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit from nvidia-smi."""
    import jax

    devs = jax.devices()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "not available"
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "card": smi}


# ---- trace reduction ---------------------------------------------------------

def _xplane_path(logdir_or_file: str) -> str:
    if logdir_or_file.endswith(".xplane.pb"):
        return logdir_or_file
    paths = sorted(glob.glob(os.path.join(
        logdir_or_file, "**", "*.xplane.pb"), recursive=True))
    if not paths:
        raise RuntimeError(f"no profiler trace under {logdir_or_file}")
    return paths[-1]


def device_kernel_events(logdir_or_file: str):
    """[(name, start_ns, duration_ns)] of every kernel the GPUs ran, from
    the device planes (`/device:GPU:<n>`) of the newest trace. Only the
    stream lines hold device activity; derived lines (XLA modules and ops)
    re-describe the same time and are skipped."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(_xplane_path(logdir_or_file))
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            out.extend((ev.name, ev.start_ns, ev.duration_ns)
                       for ev in line.events)
    return out


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, -np.inf
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if start > end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def device_step_ms(logdir_or_file: str, iters: int) -> float:
    """Device time per step: the union of kernel intervals over the
    traced window divided by the number of steps. Raises when the trace
    holds no GPU kernels."""
    events = device_kernel_events(logdir_or_file)
    if not events:
        raise RuntimeError("the trace holds no GPU kernel events")
    return busy_ns(events) / 1e6 / max(iters, 1)


def kernel_class(name: str) -> str:
    """Op class of a GPU kernel from the HLO instruction name XLA gives it:
    scatter, gather, matmul or other (fused elementwise/reductions)."""
    n = name.lower()
    if "scatter" in n:
        return "scatter"
    if "gather" in n:
        return "gather"
    if any(k in n for k in ("gemm", "dot", "cublas", "cutlass", "matmul")):
        return "matmul"
    return "other"


_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
                "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8}


def _shape_bytes(text: str) -> int:
    import re

    total = 0
    for dt, dims in re.findall(r"\b([a-z]+\d*)\[([\d,]*)\]", text):
        if dt in _DTYPE_BYTES:
            n = 1
            for d in filter(None, dims.split(",")):
                n *= int(d)
            total += n * _DTYPE_BYTES[dt]
    return total


def hlo_instruction_bytes(hlo_text: str) -> dict:
    """{sanitized instruction name: bytes of its operands plus its result},
    from the shapes in an optimized HLO module's text. This is the least
    memory traffic of the kernel that instruction becomes (each operand
    read once, the result written once); names are sanitized as XLA names
    GPU kernels ('.' and '-' become '_')."""
    import re

    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*?)\s"
                     r"([a-z\-]+)\((.*)$")
    parsed = []
    result_bytes = {}
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        name, result, _op, rest = m.groups()
        depth, args = 1, ""
        for ch in rest:
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                break
            args += ch
        result_bytes[name] = _shape_bytes(result)
        parsed.append((name, args))
    out = {}
    for name, args in parsed:
        if re.search(r"\b[a-z]+\d*\[", args):     # operand shapes inline
            operands = _shape_bytes(args)
        else:                                       # operands by name
            operands = sum(result_bytes.get(n, 0)
                           for n in re.findall(r"%([\w.\-]+)", args))
        out[re.sub(r"[.\-]", "_", name)] = result_bytes[name] + operands
    return out


def kernel_breakdown(logdir_or_file: str) -> dict:
    """{kernel name: [total ns, count]} over the trace's device kernels."""
    out: dict = {}
    for name, _, dur in device_kernel_events(logdir_or_file):
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += dur
        acc[1] += 1
    return out


def time_step(advance, state, iters: int):
    """(device_ms, host_blocked_ms) for `iters` calls of state = advance(state)."""
    import jax

    for _ in range(2):   # warmup
        state = advance(state)
    jax.block_until_ready(state)

    logdir = tempfile.mkdtemp(prefix="bench_trace_")
    t0 = time.perf_counter()
    with jax.profiler.trace(logdir):
        for _ in range(iters):
            state = advance(state)
        jax.block_until_ready(state)
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    dev_ms = device_step_ms(logdir, iters)
    return dev_ms, host_ms


def build_step(bsz: int, anchor: bool = False):
    """anchor=True builds the in-session float32 variant: amp off,
    unchunked, default scatter — measured in the same process as the
    default so that their ratio carries no cross-session drift."""
    import jax
    import jax.numpy as jnp
    import optax

    from dualmessagepassing_tpu import build_model
    from __graft_entry__ import _flagship_config, _make_batch

    cfg = _flagship_config()
    sm = os.environ.get("BENCH_SCATTER")
    if sm:
        cfg = cfg.replace(scatter_method=sm)
    # BENCH_HID widens the model off the flagship hid=64 (NOT a headline
    # config — an MFU-vs-width probe: arithmetic intensity scales ~H/4
    # FLOP/byte, so MFU should rise near-linearly with H if the step is
    # bound by memory traffic, flat if it is not)
    hid = int(os.environ.get("BENCH_HID", "64"))
    if hid != 64:
        cfg = cfg.replace(hid_dim=hid, pred_hid_dim=hid)
    model = build_model(cfg)
    pattern, graph = _make_batch(bsz, 8, 8, 64, 256, 16, 16)
    counts = jnp.asarray(
        np.random.default_rng(0).poisson(4.0, size=(bsz, 1)).astype(np.float32))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), pattern, graph)
    tx = optax.adamw(1e-3, weight_decay=1e-5)
    opt_state = tx.init(params)

    # bf16 compute with f32 master params is the framework's production
    # training configuration (validated: tests/test_amp.py learning +
    # gradient-alignment gates); BENCH_AMP=0 measures float32
    amp = os.environ.get("BENCH_AMP", "1") == "1" and not anchor

    def loss_fn(p, pattern, graph, counts):
        if amp:
            # bf16 forward/backward, f32 master params + loss (utils/amp.py)
            from dualmessagepassing_tpu.utils.amp import (cast_floats,
                                                          compute_dtype_scope)

            with compute_dtype_scope(jnp.bfloat16):
                out = model.apply(cast_floats(p, jnp.bfloat16),
                                  cast_floats(pattern, jnp.bfloat16),
                                  cast_floats(graph, jnp.bfloat16))
            out = cast_floats(out, jnp.float32)
        else:
            out = model.apply(p, pattern, graph)
        c_loss = jnp.mean((out["pred_c"] - counts) ** 2)
        v_loss = jnp.mean(out["pred_v"] ** 2)
        e_loss = jnp.mean(out["pred_e"] ** 2)
        return c_loss + 0.1 * (v_loss + e_loss)

    # BENCH_CHUNKS=k scans the batch as k equal microbatches inside the
    # one jitted step (identical mean gradient, smaller activation
    # working set — see scm_driver.make_train_step(accum_chunks)); auto by
    # default, mirroring make_train_step: ~128-pair chunks, bsz<=128
    # unchunked
    chunks = 1 if anchor else _effective_chunks(bsz)
    if chunks > 1 and bsz % chunks:
        chunks = 1   # indivisible batch (e.g. the scale-check bsz/4 rerun)

    def train_step(params, opt_state, pattern, graph, counts):
        if chunks <= 1:
            loss, grads = jax.value_and_grad(loss_fn)(
                params, pattern, graph, counts)
        else:
            def split(x):
                return x.reshape((chunks, x.shape[0] // chunks) + x.shape[1:])

            xs = jax.tree.map(split, (pattern, graph, counts))

            def body(g_acc, chunk):
                l, g = jax.value_and_grad(loss_fn)(params, *chunk)
                return jax.tree.map(jnp.add, g_acc, g), l

            g_sum, ls = jax.lax.scan(
                body, jax.tree.map(jnp.zeros_like, params), xs)
            grads = jax.tree.map(lambda g: g / chunks, g_sum)
            loss = ls.mean()
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    compiled = jax.jit(train_step, donate_argnums=(0, 1)).lower(
        params, opt_state, pattern, graph, counts).compile()
    ca = compiled.cost_analysis() or {}
    flops = float(ca.get("flops", float("nan")))
    if chunks > 1:
        # cost_analysis counts the lax.scan BODY once, not `chunks` times;
        # scale the model/grad share back up (the once-per-step optimizer
        # tail it also multiplies is <1% of the total at these shapes)
        flops *= chunks

    def advance(state):
        p, o, _loss = compiled(state[0], state[1], pattern, graph, counts)
        return (p, o, _loss)

    advance.compiled = compiled
    return advance, (params, opt_state, counts), flops


def _effective_chunks(bsz: int) -> int:
    """The chunk count build_step actually uses (BENCH_CHUNKS=0 = auto)."""
    chunks = int(os.environ.get("BENCH_CHUNKS", "0"))
    if chunks == 0:
        chunks = max(bsz // 128, 1)
        while bsz % chunks:
            chunks -= 1
    return chunks


def measure(bsz: int, iters: int, anchor: bool = False):
    advance, state0, flops = build_step(bsz, anchor=anchor)
    dev_ms, host_ms = time_step(advance, state0, iters)
    return dev_ms, host_ms, flops


def unc_lever_flags(anchor: bool = False) -> dict:
    """Resolve the UNC env flags ONCE (model and JSON both read this).

    anchor=True ignores the env and returns the in-session float32
    variant (amp off, split endpoints)."""
    env = os.environ.get
    if anchor:
        env = {"BENCH_AMP": "0", "BENCH_UNC_ENDPOINTS": "split"}.get
    return {
        "amp": env("BENCH_AMP", "1") == "1",
        "endpoints": env("BENCH_UNC_ENDPOINTS", "split"),
    }


def unc_sub(v: int, e: int, s: int, seed: int = 0) -> dict:
    """A receiver-sorted synthetic UNC subgraph (uniform endpoints) with
    the host-precomputed keys pad_subgraph ships."""
    R = 3
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, v, e).astype(np.int32)
    receivers = rng.integers(0, v, e).astype(np.int32)
    order = np.argsort(receivers, kind="stable")
    sub = {
        "nid": np.arange(v, dtype=np.int64),
        "senders": senders[order],
        "receivers": receivers[order],
        "edge_type": rng.integers(0, 2 * R, e).astype(np.int32)[order],
        "rev_flag": (rng.random(e) < 0.5)[order],
        "edge_mask": np.ones(e, bool),
        "node_mask": np.ones(v, bool),
        "edge_norm": (1.0 / np.maximum(
            np.bincount(receivers, minlength=v)[receivers], 1)
        ).astype(np.float32)[order][:, None],
        "samples": np.stack([
            rng.integers(0, v, s), rng.integers(0, R, s),
            rng.integers(0, v, s)], 1).astype(np.int64),
        "labels": (rng.random(s) < 0.2).astype(np.float32),
        "sample_mask": np.ones(s, bool),
    }
    sub["out_deg"] = np.bincount(sub["senders"], minlength=v).astype(
        np.float32)
    return sub


def build_unc_step(v: int, e: int, h: int = 50, layers: int = 2,
                   s: int = 60000, anchor: bool = False,
                   flags: dict = None):
    """Real UNC train step (driver's make_unc_train_step) on a synthetic
    receiver-sorted Yelp-ish envelope — the scale workload's benchmark.

    Sorted edges + bf16 amp + the host-precomputed sender sort; BENCH_AMP=0
    -> float32, BENCH_UNC_ENDPOINTS=fused -> one gather over both
    endpoint streams.
    `flags` overrides the environment (unc_lever_flags)."""
    import jax
    import jax.numpy as jnp
    import optax

    from dualmessagepassing_tpu.unc.driver import make_unc_train_step
    from dualmessagepassing_tpu.unc.model import (UNCTrainModel,
                                                  init_unc_variables)

    flags = flags or unc_lever_flags(anchor=anchor)
    sub_np = unc_sub(v, e, s)
    # the in-session anchor drops the host-precomputed keys
    if anchor:
        del sub_np["out_deg"]
    else:
        so = np.argsort(sub_np["senders"], kind="stable")
        sub_np["send_order"] = so.astype(np.int64)
        sub_np["senders_sorted"] = sub_np["senders"][so]
    if flags["endpoints"] == "fused":
        from dualmessagepassing_tpu.unc.data import add_pair_keys

        sub_np = add_pair_keys(sub_np)
    sub = {k: jnp.asarray(val) for k, val in sub_np.items()}

    model = UNCTrainModel(
        num_nodes=v, num_rels=3, h_dim=h, nlabel=0,
        num_hidden_layers=layers, dropout=0.2, reg_param=0.01,
        backbone="DMPNN", sorted_edges=not anchor)  # anchor: unsorted hint
    variables = init_unc_variables(model, jax.random.PRNGKey(0), sub)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    tx = optax.adam(1e-2)
    opt = tx.init(params)
    step = make_unc_train_step(model, tx, amp=flags["amp"])
    compiled = step.lower(params, opt, stats, sub,
                          jax.random.PRNGKey(1)).compile()
    ca = compiled.cost_analysis() or {}
    flops = float(ca.get("flops", float("nan")))

    # hoisted: an eager PRNGKey() per advance would add its own programs
    # to the measured device stream
    key = jax.random.PRNGKey(2)

    def advance(state):
        p, o, st, loss = compiled(state[0], state[1], state[2], sub, key)
        return (p, o, st, loss)

    advance.compiled = compiled
    return advance, (params, opt, stats), flops


def measure_unc(v: int, e: int, iters: int, anchor: bool = False):
    advance, state0, flops = build_unc_step(v, e, anchor=anchor)
    dev_ms, host_ms = time_step(advance, state0, iters)
    return dev_ms, host_ms, flops


def _finish(out: dict, err) -> None:
    if err:
        out["error"] = err
    print(json.dumps(out))
    if err:
        sys.exit(1)


def main_unc(info: dict):
    """BENCH_WORKLOAD=unc: one JSON line for the UNC scale workload."""
    v = int(os.environ.get("BENCH_UNC_V", "65536"))
    e = int(os.environ.get("BENCH_UNC_E", "524288"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    scale_check = os.environ.get("BENCH_SCALECHECK", "1") == "1"
    flags = unc_lever_flags()

    step_ms, host_ms, flops = measure_unc(v, e, iters)
    mfu = flops / (step_ms / 1e3) / step_peak_flops(info["device_kind"],
                                                    flags["amp"])
    eps = e / (step_ms / 1e3)

    err = None
    if mfu > 1.0:
        err = (f"IMPOSSIBLE: apparent MFU {mfu:.2f} > 1.0 "
               f"({flops:.3e} FLOP in {step_ms:.3f} ms) — clock is lying")

    scale_ratio = None
    if scale_check and err is None:
        small_ms, _, _ = measure_unc(v, e // 4, max(iters // 2, 3))
        scale_ratio = step_ms / max(small_ms, 1e-9)
        if scale_ratio < 1.5:
            err = (f"SCALE CHECK FAILED: step(E={e})={step_ms:.2f} ms vs "
                   f"step(E={e // 4})={small_ms:.2f} ms (ratio "
                   f"{scale_ratio:.2f} < 1.5) — timing not tracking compute")

    out = {
        "metric": "unc_train_edges_per_sec",
        "value": round(eps, 1),
        "unit": "edges/s",
        **info,
        "v": v, "e": e,
        "step_ms": round(step_ms, 3),
        "clock": "device_trace",
        "host_step_ms": round(host_ms, 3),
        "flops_per_step": flops,
        "mfu": round(mfu, 4),
        **flags,
    }
    if scale_ratio is not None:
        out["scale_ratio_4x"] = round(scale_ratio, 2)
    # the in-session float32 anchor (BENCH_INSESSION_ANCHOR=0 opts out)
    if os.environ.get("BENCH_INSESSION_ANCHOR", "1") == "1" and err is None:
        a_ms, _, _ = measure_unc(v, e, max(iters // 2, 3), anchor=True)
        out["anchor_step_ms"] = round(a_ms, 3)
        out["vs_f32_in_session"] = round(a_ms / step_ms, 3)
    _finish(out, err)


def build_scm_infer(bsz: int):
    """Forward-only SCM inference step (the serving path): the reference's
    only latency metric is eval forward time per sample
    (SubgraphCountingMatching/train.py:939-940, no published value).
    Same flagship Complex envelope and amp default as the train bench."""
    import jax
    import jax.numpy as jnp

    from dualmessagepassing_tpu import build_model
    from __graft_entry__ import _flagship_config, _make_batch

    cfg = _flagship_config()
    model = build_model(cfg)
    pattern, graph = _make_batch(bsz, 8, 8, 64, 256, 16, 16)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), pattern, graph)
    amp = os.environ.get("BENCH_AMP", "1") == "1"

    def forward(p, pattern, graph):
        if amp:
            from dualmessagepassing_tpu.utils.amp import (cast_floats,
                                                          compute_dtype_scope)

            with compute_dtype_scope(jnp.bfloat16):
                out = model.apply(cast_floats(p, jnp.bfloat16),
                                  cast_floats(pattern, jnp.bfloat16),
                                  cast_floats(graph, jnp.bfloat16))
            return cast_floats(out["pred_c"], jnp.float32)
        return model.apply(p, pattern, graph)["pred_c"]

    compiled = jax.jit(forward).lower(params, pattern, graph).compile()
    ca = compiled.cost_analysis() or {}
    flops = float(ca.get("flops", float("nan")))

    # iterations are independent programs; the device runs queued
    # programs in order on one stream and the trace reduction sums every
    # execution, so no dependency threading is needed
    def advance(state):
        return (compiled(params, pattern, graph),)

    return advance, (jnp.zeros((1, 1), jnp.float32),), flops


def build_unc_infer(v: int, e: int):
    """Forward-only UNC inference (the embedding-export serving path,
    unc/driver.py:make_unc_embed_step; reference main.py:184-209 exports
    embeddings with the trained model in eval mode)."""
    import jax
    import jax.numpy as jnp

    from dualmessagepassing_tpu.unc.model import (UNCTrainModel,
                                                  apply_unc_forward,
                                                  init_unc_variables)

    h = int(os.environ.get("BENCH_UNC_H", "50"))
    sub_np = unc_sub(v, e, 8)
    sub_np["sample_mask"][:] = False
    sub = {k: jnp.asarray(val) for k, val in sub_np.items()}
    flags = unc_lever_flags()
    model = UNCTrainModel(
        num_nodes=v, num_rels=3, h_dim=h, nlabel=0,
        num_hidden_layers=2, dropout=0.0, reg_param=0.01,
        backbone="DMPNN", sorted_edges=True)
    variables = init_unc_variables(model, jax.random.PRNGKey(0), sub)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    key = jax.random.PRNGKey(1)

    def forward(p, st, sub):
        (out, _pred), _ = apply_unc_forward(model, p, st, sub, key,
                                            amp=flags["amp"], train=False)
        return out[0]

    compiled = jax.jit(forward).lower(params, stats, sub).compile()
    ca = compiled.cost_analysis() or {}
    flops = float(ca.get("flops", float("nan")))

    def advance(state):
        emb = compiled(params, stats, sub)
        return (emb,)

    return advance, (jnp.zeros((v, h), jnp.float32),), flops


def main_infer(workload: str, info: dict):
    """BENCH_WORKLOAD=scm_infer|unc_infer: forward-only serving bench."""
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    amp = os.environ.get("BENCH_AMP", "1") == "1"
    if workload == "scm_infer":
        bsz = int(os.environ.get("BENCH_BSZ", "512"))
        advance, state0, flops = build_scm_infer(bsz)
        step_ms, host_ms = time_step(advance, state0, iters)
        denom_name, denom = "samples", bsz
        metric = "scm_infer_samples_per_sec"
        extras = {"bsz": bsz}
    else:
        v = int(os.environ.get("BENCH_UNC_V", "65536"))
        e = int(os.environ.get("BENCH_UNC_E", "524288"))
        advance, state0, flops = build_unc_infer(v, e)
        step_ms, host_ms = time_step(advance, state0, iters)
        denom_name, denom = "edges", e
        metric = "unc_infer_edges_per_sec"
        extras = {"v": v, "e": e, **unc_lever_flags()}

    mfu = flops / (step_ms / 1e3) / step_peak_flops(info["device_kind"], amp)
    rate = denom / (step_ms / 1e3)

    err = None
    if mfu > 1.0:
        err = (f"IMPOSSIBLE: apparent MFU {mfu:.2f} > 1.0 — clock is lying")

    # scaling gate (same spirit as the train benches; the MFU<=1 gate
    # alone is inert when cost_analysis has no flops -> mfu NaN)
    scale_ratio = None
    if os.environ.get("BENCH_SCALECHECK", "1") == "1" and err is None:
        if workload == "scm_infer":
            s_adv, s_state, _ = build_scm_infer(max(extras["bsz"] // 4, 1))
        else:
            s_adv, s_state, _ = build_unc_infer(extras["v"],
                                                extras["e"] // 4)
        small_ms, _ = time_step(s_adv, s_state, max(iters // 2, 3))
        scale_ratio = step_ms / max(small_ms, 1e-9)
        if scale_ratio < 1.5:
            err = (f"SCALE CHECK FAILED: {step_ms:.2f} ms full vs "
                   f"{small_ms:.2f} ms at 1/4 size (ratio "
                   f"{scale_ratio:.2f} < 1.5) — timing not tracking"
                   " compute")

    out = {
        "metric": metric, "value": round(rate, 1),
        "unit": f"{denom_name}/s", **info,
        "step_ms": round(step_ms, 3), "clock": "device_trace",
        "host_step_ms": round(host_ms, 3), "flops_per_step": flops,
        "mfu": round(mfu, 4), "amp": amp, **extras,
    }
    if scale_ratio is not None:
        out["scale_ratio_4x"] = round(scale_ratio, 2)
    _finish(out, err)


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dualmessagepassing_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    prec = os.environ.get("BENCH_PRECISION")
    if prec:
        import jax
        jax.config.update("jax_default_matmul_precision", prec)

    info = device_info()
    device_peaks(info["device_kind"])     # unknown device kinds stop here

    workload = os.environ.get("BENCH_WORKLOAD", "scm")
    if workload == "unc":
        main_unc(info)
        return
    if workload in ("scm_infer", "unc_infer"):
        main_infer(workload, info)
        return

    bsz = int(os.environ.get("BENCH_BSZ", "128"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    scale_check = os.environ.get("BENCH_SCALECHECK", "1") == "1"
    amp = os.environ.get("BENCH_AMP", "1") == "1"

    step_ms, host_ms, flops = measure(bsz, iters)
    mfu = flops / (step_ms / 1e3) / step_peak_flops(info["device_kind"], amp)
    # real (non-padded) edges per step: graph 256*2(rev) + pattern 8*2 per pair
    edges_per_step = bsz * (256 * 2 + 8 * 2)
    eps = edges_per_step / (step_ms / 1e3)

    err = None
    if mfu > 1.0:
        err = (f"IMPOSSIBLE: apparent MFU {mfu:.2f} > 1.0 "
               f"({flops:.3e} FLOP in {step_ms:.3f} ms) — clock is lying")

    scale_ratio = None
    if scale_check and err is None and bsz >= 4:
        small_ms, _, _ = measure(bsz // 4, max(iters // 2, 3))
        scale_ratio = step_ms / max(small_ms, 1e-9)
        if scale_ratio < 1.5:
            err = (f"SCALE CHECK FAILED: step({bsz})={step_ms:.2f} ms vs "
                   f"step({bsz // 4})={small_ms:.2f} ms (ratio "
                   f"{scale_ratio:.2f} < 1.5) — timing not tracking compute")

    out = {
        "metric": "scm_train_edges_per_sec",
        "value": round(eps, 1),
        "unit": "edges/s",
        **info,
        "bsz": bsz,
        "step_ms": round(step_ms, 3),
        "clock": "device_trace",
        "host_step_ms": round(host_ms, 3),
        "flops_per_step": flops,
        "mfu": round(mfu, 4),
        "amp": amp,
        "chunks": _effective_chunks(bsz),
    }
    hid = int(os.environ.get("BENCH_HID", "64"))
    if hid != 64:
        out["hid"] = hid
    if scale_ratio is not None:
        out["scale_ratio_4x"] = round(scale_ratio, 2)
    # the in-session float32 anchor (BENCH_INSESSION_ANCHOR=0 opts out)
    if (os.environ.get("BENCH_INSESSION_ANCHOR", "1") == "1"
            and err is None and hid == 64):
        a_ms, _a_host, _ = measure(bsz, max(iters // 2, 3), anchor=True)
        out["anchor_step_ms"] = round(a_ms, 3)
        out["vs_f32_in_session"] = round(a_ms / step_ms, 3)
    _finish(out, err)


if __name__ == "__main__":
    main()
