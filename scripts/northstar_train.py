"""100M-edge north-star END-TO-END training demo (the composed pipeline).

Extends northstar_smoke.py past plan building into real training: the full
UNC pipeline — power-law generator -> WholeGraph CSR -> random-walk
sampling + negative sampling in prefetch threads -> owner-sharded halo
partition -> >= `--steps` REAL
`make_halo_train_step` steps of UNCTrainModel (bf16 amp) on an
`--shards`-way mesh, with a full-state checkpoint written AND restored
mid-run. Emits ONE JSON line with the loss curve and the host/device
overlap fraction.

Reference loop being matched at scale:
/root/reference/UnsupervisedNodeClassification/Model/DMPNN/src/main.py:119-209
(the Yelp 30.5M-link training loop; the reference samples ~10k-edge
batches onto one GPU — here the sampled subgraph itself is sharded).

Runs on the 8-way virtual CPU mesh by default; set DMP_EXAMPLE_ACCEL=1 to
run on the machine's accelerators instead.

Usage:
    python scripts/northstar_train.py                      # 1M V / 100M E
    python scripts/northstar_train.py --v 65536 --e 2000000 --steps 6
Memory: ~(24 B + CSR) * E host RAM for the graph (~8 GB at the default)
plus the sharded activations (~20-40 GB at the default envelope).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _setup_jax(shards: int):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += f" --xla_force_host_platform_device_count={shards}"
    # Virtual devices timeslice the physical cores, so per-shard compute
    # skew at large envelopes exceeds XLA's default in-process collective
    # rendezvous terminate timeout (40 s — the run dies inside the first
    # all_to_all otherwise). Real multi-chip meshes don't timeslice.
    if "collective_call_terminate_timeout" not in flags:
        flags += (" --xla_cpu_collective_timeout_seconds=1200"
                  " --xla_cpu_collective_call_terminate_timeout_seconds=1200")
    os.environ["XLA_FLAGS"] = flags
    import jax

    if not os.environ.get("DMP_EXAMPLE_ACCEL"):
        jax.config.update("jax_platforms", "cpu")
    return jax


def run(v: int, e: int, steps: int, shards: int, batch: int = 10_000,
        depth: int = 3, width: int = 10, h_dim: int = 50, layers: int = 2,
        negative_rate: int = 5, amp: bool = True, partition: str = "degree",
        edge_slack: float = 1.5, seed: int = 0, prefetch: int = 2,
        lr: float = 1e-2, log=print) -> dict:
    jax = _setup_jax(shards)
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dualmessagepassing_tpu.data.synthetic import generate_large_graph
    from dualmessagepassing_tpu.parallel.halo_unc import (
        build_halo_sub, halo_envelope, make_halo_train_step, shard_halo_sub)
    from dualmessagepassing_tpu.train.checkpoint import (restore_params,
                                                         save_params)
    from dualmessagepassing_tpu.unc.data import WholeGraph
    from dualmessagepassing_tpu.unc.driver import (make_unc_optimizer,
                                                   sample_batch)
    from dualmessagepassing_tpu.unc.model import (UNCTrainModel,
                                                  init_unc_variables)

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    triplets, _ = generate_large_graph(v, e, num_rels=4, seed=seed,
                                       power_law=True)
    log(f"generate {e / 1e6:.1f}M edges: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    graph = WholeGraph(v, 4, triplets)
    log(f"WholeGraph CSR: {time.perf_counter() - t0:.1f}s "
        f"({graph.num_edges} directed edges)")

    s_max = batch * (1 + negative_rate)
    v_max = v

    # Size the static edge envelope from the first sampled batch (batches
    # at a fixed (batch, depth, width) vary ~1% in sampled size; 1.25x
    # slack keeps every batch inside one compiled program shape).
    t0 = time.perf_counter()
    first_edges = triplets[rng.integers(0, len(triplets), batch)]
    first = sample_batch(graph, first_edges, "randomwalk", depth, width,
                         0.5, negative_rate, v_max,
                         min(v_max * width, graph.num_edges), s_max, rng)
    sampled_v = int(first["node_mask"].sum())
    sampled_e = int(first["edge_mask"].sum())
    log(f"first sample: {time.perf_counter() - t0:.1f}s -> "
        f"{sampled_v} V / {sampled_e} E")
    e_max = min(int(1.25 * sampled_e) + 4096,
                min(v_max * width, graph.num_edges))
    # re-pad the first batch to the final envelope
    vp_env, ep_env, b_env = halo_envelope(v_max, e_max, shards,
                                          edge_slack=edge_slack)
    log(f"envelope: v_max={v_max} e_max={e_max} "
        f"(per-shard Vp={vp_env} Ep={ep_env} B={b_env})")

    mkw = dict(num_nodes=v, num_rels=4, h_dim=h_dim, nlabel=0,
               num_hidden_layers=layers, dropout=0.2, reg_param=0.01,
               backbone="DMPNN", sorted_edges=True)
    model = UNCTrainModel(ep_axis="ep", node_sharding="owner", **mkw)
    init_model = UNCTrainModel(**mkw)

    def sample_one(brng):
        edges = triplets[brng.integers(0, len(triplets), batch)]
        padded = sample_batch(graph, edges, "randomwalk", depth, width,
                              0.5, negative_rate, v_max, e_max, s_max, brng)
        nv = int(padded["node_mask"].sum())
        ne = int(padded["edge_mask"].sum())
        dev, _meta = build_halo_sub(padded, shards, vp_env, ep_env, b_env,
                                    method=partition)
        return dev, nv, ne

    mesh = Mesh(np.asarray(jax.devices()[:shards]), ("ep",))
    t0 = time.perf_counter()
    first_dev, _, _ = sample_one(np.random.default_rng(seed + 1))
    log(f"first halo partition ({partition}): "
        f"{time.perf_counter() - t0:.1f}s; boundary rows "
        f"{int(first_dev['send_mask'].sum())}")

    log("initializing parameters (jit)...")
    t0 = time.perf_counter()
    first_padded = {k: jnp.asarray(val) for k, val in first.items()}
    variables = init_unc_variables(init_model, jax.random.PRNGKey(seed),
                                   first_padded)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    tx = make_unc_optimizer(lr, steps)
    opt_state = tx.init(params)
    step = make_halo_train_step(model, tx, mesh, amp=amp)
    log(f"init {time.perf_counter() - t0:.1f}s; compiling train step (AOT)..")
    t0 = time.perf_counter()
    step.lower(params, opt_state, batch_stats,
               shard_halo_sub(mesh, first_dev),
               jax.random.PRNGKey(seed)).compile()
    compile_s = time.perf_counter() - t0
    log(f"compile {compile_s:.1f}s; training {steps} steps...")

    # Prefetch threads carry sampling + halo partitioning off the critical
    # path (the same scheme as train_unc; the AOT compile above happened
    # before any thread started).
    from concurrent.futures import ThreadPoolExecutor

    losses = []
    step_s = []
    blocked_s = 0.0
    sample_s = 0.0
    ckpt_verified = False
    ckpt_at = steps // 2
    ckpt_dir = tempfile.mkdtemp(prefix="northstar_ckpt_")

    child_rngs = rng.spawn(steps)

    def timed_sample(brng):
        t = time.perf_counter()
        out = sample_one(brng)
        return out, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=max(prefetch, 1)) as pool:
        window = max(2 * prefetch, 1)
        futures = {i: pool.submit(timed_sample, child_rngs[i])
                   for i in range(min(window, steps))}
        for k in range(steps):
            t_wait = time.perf_counter()
            (dev, nv, ne), s_time = futures.pop(k).result()
            blocked_s += time.perf_counter() - t_wait
            sample_s += s_time
            nxt = k + window
            if nxt < steps:
                futures[nxt] = pool.submit(timed_sample, child_rngs[nxt])
            sub = shard_halo_sub(mesh, dev)
            t_step = time.perf_counter()
            params, opt_state, batch_stats, loss = step(
                params, opt_state, batch_stats, sub,
                jax.random.fold_in(jax.random.PRNGKey(seed), k))
            loss = float(loss)   # sync
            step_s.append(time.perf_counter() - t_step)
            losses.append(loss)
            log(f"step {k:03d} | loss {loss:.4f} | {nv} V / {ne} E | "
                f"step {step_s[-1]:.1f}s")

            if k == ckpt_at:
                # full-state checkpoint written AND restored mid-run
                path = os.path.join(ckpt_dir, "mid")
                state = {"params": jax.device_get(params),
                         "opt_state": jax.device_get(opt_state),
                         "batch_stats": jax.device_get(batch_stats),
                         "step": k}
                save_params(path, state)
                restored = restore_params(path, like=state)
                leaves_a = jax.tree.leaves(state["params"])
                leaves_b = jax.tree.leaves(restored["params"])
                ckpt_verified = all(
                    np.array_equal(np.asarray(x), np.asarray(y))
                    for x, y in zip(leaves_a, leaves_b)) and \
                    int(restored["step"]) == k
                # continue FROM the restored state (proves resume works)
                params = restored["params"]
                opt_state = restored["opt_state"]
                batch_stats = restored["batch_stats"]
                log(f"checkpoint saved+restored at step {k} "
                    f"(verified={ckpt_verified})")

    # overlap fraction: how much host sampling time was hidden behind the
    # device steps (1.0 = fully overlapped; blocked_s is time the train
    # loop spent waiting on the sampler threads)
    overlap = 1.0 - blocked_s / max(sample_s, 1e-9)
    half = max(len(losses) // 2, 1)
    result = {
        "metric": "northstar_halo_train_loss",
        "value": round(losses[-1], 4),
        "unit": "bce+reg",
        "graph_v": v, "graph_e_directed": graph.num_edges,
        "sampled_v": sampled_v, "sampled_e": sampled_e,
        "envelope": {"v_max": v_max, "e_max": e_max, "vp": vp_env,
                     "ep": ep_env, "b": b_env},
        "shards": shards, "amp": bool(amp),
        "partition": partition, "steps": steps,
        "losses": [round(x, 4) for x in losses],
        "loss_first": round(losses[0], 4),
        "loss_last_half_mean": round(sum(losses[half:])
                                     / max(len(losses) - half, 1), 4),
        "loss_decreased": losses[-1] < losses[0],
        "checkpoint_verified": ckpt_verified,
        "compile_s": round(compile_s, 1),
        "step_s_avg": round(sum(step_s) / max(len(step_s), 1), 2),
        "sample_s_avg": round(sample_s / max(steps, 1), 2),
        "sample_overlap_fraction": round(max(overlap, 0.0), 3),
        "platform": jax.devices()[0].platform,
    }
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--v", type=int, default=1_000_000)
    ap.add_argument("--e", type=int, default=100_000_000)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--width", type=int, default=10)
    ap.add_argument("--h-dim", type=int, default=50)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--amp", type=int, default=1)
    ap.add_argument("--partition", default="degree")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    result = run(args.v, args.e, args.steps, args.shards, batch=args.batch,
                 depth=args.depth, width=args.width, h_dim=args.h_dim,
                 layers=args.layers, amp=bool(args.amp),
                 partition=args.partition)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
