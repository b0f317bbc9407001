"""The performance levers in one script: bf16 mixed precision, in-step
microbatching, owner-sharded execution and the endpoint-gather layouts.

SCM: `make_train_step(amp=True, accum_chunks=k)` — bf16 compute with f32
master params scanned as k microbatches (a smaller activation working
set; identical mean gradient for the bsz-denominated losses). UNC:
`train_unc(amp=True, ep_devices=N, ep_mode="halo", ep_partition="bfs")`
composes the levers with owner-sharded execution. What each is worth on
the GPU is in PERF.md.

On CPU: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
            python examples/performance_levers.py
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
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def scm_amp_microbatched():
    from dualmessagepassing_tpu import ModelConfig, build_model
    from dualmessagepassing_tpu.data.dataset import GraphAdjDataset
    from dualmessagepassing_tpu.data.synthetic import generate_dataset
    from dualmessagepassing_tpu.train import (TrainState, make_optimizer,
                                              make_train_step)

    data = generate_dataset(32, seed=0, pv=3, pe=3, gv=8, ge=16,
                            num_vlabels=2, num_elabels=2,
                            p_v_max=4, p_e_max=4, g_v_max=8, g_e_max=16)
    cfg = ModelConfig(max_ngv=8, max_ngvl=2, max_nge=16, max_ngel=2,
                      max_npv=4, max_npvl=2, max_npe=4, max_npel=2,
                      hid_dim=16, pred_return_weights="nodeedge")
    model = build_model(cfg)
    ds = GraphAdjDataset(data)
    _, pattern, graph, counts, (nw, ew) = ds.batchify(range(16), "nodeedge")
    params = jax.jit(model.init)(jax.random.PRNGKey(0), pattern, graph)
    tx = make_optimizer(lr=1e-3)
    # bf16 compute + 4 microbatches scanned inside ONE jitted step
    step = make_train_step(model, tx, return_weights="nodeedge",
                           amp=True, accum_chunks=4)
    state, losses = step(TrainState.create(params, tx), pattern, graph,
                         counts, nw, ew, 0.2, 0.1, 0.0, 1e-4, 1.0,
                         jax.random.PRNGKey(1))
    print(f"SCM amp+chunked step: loss {float(losses['total']):.4f}")


def unc_all_levers():
    from dualmessagepassing_tpu.unc.driver import train_unc

    rng = np.random.default_rng(0)
    src = rng.integers(0, 30, 150)
    dst = (src + rng.integers(1, 30, 150)) % 30
    rel = rng.integers(0, 2, 150)
    t = np.stack([src, rel, dst], 1).astype(np.int64)
    embs, coverage = train_unc(
        t, 30, 2, h_dim=8, n_layers=1, graph_batch_size=50,
        sample_depth=2, sample_width=5, n_epochs=2, v_max=30, e_max=150,
        seed=0,
        ep_devices=min(8, len(jax.devices())),  # owner-sharded over 'ep'
        ep_mode="halo",                         # boundary all_to_all
        ep_partition="bfs",                     # locality-aware owners
        amp=True,                               # bf16 backbone
        log=lambda s: None)
    print(f"UNC halo+bfs+amp: coverage {coverage:.2f}, "
          f"emb shape {embs.shape}")


def unc_single_device_cotangent_levers():
    """Single-device layout: the fused 2E endpoint gather
    (scripts/unc_step_bench.py A/Bs it on the card)."""
    from dualmessagepassing_tpu.unc.driver import train_unc

    rng = np.random.default_rng(0)
    src = rng.integers(0, 30, 150)
    dst = (src + rng.integers(1, 30, 150)) % 30
    rel = rng.integers(0, 2, 150)
    t = np.stack([src, rel, dst], 1).astype(np.int64)
    embs, coverage = train_unc(
        t, 30, 2, h_dim=8, n_layers=1, graph_batch_size=50,
        sample_depth=2, sample_width=5, n_epochs=2, v_max=30, e_max=150,
        seed=0,
        endpoint_gather="fused",   # ONE [2E] gather / cotangent scatter
        log=lambda s: None)
    print(f"UNC fused endpoints: coverage {coverage:.2f}, "
          f"emb shape {embs.shape}")


if __name__ == "__main__":
    scm_amp_microbatched()
    unc_all_levers()
    unc_single_device_cotangent_levers()
