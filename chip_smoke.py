#!/usr/bin/env python3
"""Smoke run of the SCM and UNC training paths on NVIDIA GPUs.

One process runs every phase, through the functions the CLIs use:

  * SCM: the flagship DMPNN (Complex envelope: pattern 8V/8E, graph
    64V/256E, 16 labels, reversed edges; hid 64, 3+3 layers) trains a few
    steps at batch 512 with bf16 compute through make_train_step /
    train_epoch (cli/scm_train.py's path), then saves and restores a
    checkpoint;
  * UNC: train_unc on a heterogeneous graph made from a seed at PubMed's
    published size (63,109 nodes, 10 link types, 244,986 links; h_dim 50,
    2 layers, 10,000-edge batches, random walks of depth 3 and width 10),
    then the exported embeddings are written out;
  * references: the SCM forward (pred_c, pred_v, pred_e) and one UNC train
    step's loss and gradients on the GPU against the same computation on
    the CPU device of this process, in float32 at
    `jax.default_matmul_precision("highest")` (rtol 1e-4, the tests'
    golden tolerance), then at default precision (TF32 matmuls) and with
    bf16 compute, each against its stated tolerance.

`--devices 4` runs only the multi-GPU paths users start with
`--dp_devices` (SCM) and `--ep_devices N --ep_mode psum|halo` (UNC): one
data-parallel SCM step and one ep-psum and one halo UNC step on four GPUs,
each against the single-GPU step on the same batch.

Step times printed here are smoke timings of a few steps, not a benchmark.
The script exits non-zero without a result when JAX finds no GPU. Its last
line is one JSON object naming the device.

Usage: python chip_smoke.py [--devices 4]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Workload sizes; `FULL` is what the script runs, `TINY` is for tests
    on the CPU."""

    scm_bsz: int = 512
    scm_steps: int = 3
    ref_bsz: int = 64
    unc_nodes: int = 63_109
    unc_rels: int = 10
    unc_links: int = 244_986
    unc_batch: int = 10_000
    unc_steps: int = 3
    h_dim: int = 50
    depth: int = 3
    width: int = 10
    negative_rate: int = 5


FULL = Sizes()
TINY = Sizes(scm_bsz=8, scm_steps=2, ref_bsz=4, unc_nodes=300, unc_rels=3,
             unc_links=1500, unc_batch=200, unc_steps=2, h_dim=8, depth=2,
             width=4, negative_rate=2)

# float32 at "highest": the golden tolerance of the tests
RTOL_F32 = 1e-4
# default-precision and bf16 runs: max |gpu - cpu| over max |cpu|
# (TF32 keeps 10 mantissa bits, bf16 keeps 7)
TOL_TF32 = 2e-2
TOL_BF16 = 1e-1


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def gpu_name_and_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        return out or "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: not available ({type(e).__name__})"


# ---- measurement helpers -----------------------------------------------------

def _leaves(tree):
    import jax

    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def max_norm_err(got, want) -> float:
    """max |got - want| over max |want|, over all leaves together."""
    g, w = _leaves(got), _leaves(want)
    num = max((float(np.max(np.abs(a - b))) for a, b in zip(g, w)
               if a.size), default=0.0)
    den = max((float(np.max(np.abs(b))) for b in w if b.size), default=0.0)
    return num / max(den, 1e-30)


def assert_close_f32(name, got, want):
    """Elementwise rtol=RTOL_F32, with an absolute floor of RTOL_F32 times
    the largest magnitude in the whole tree: elements that cancel to ~0
    (a bias ahead of a batch norm gets a zero gradient) carry only
    summation-order noise."""
    g, w = _leaves(got), _leaves(want)
    atol = RTOL_F32 * max((float(np.max(np.abs(b))) for b in w if b.size),
                          default=0.0)
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a, b, rtol=RTOL_F32, atol=atol,
                                   err_msg=f"{name} leaf {i}")
    log(f"  {name}: float32 highest, max err {max_norm_err(got, want):.3e} "
        f"of max |ref| (rtol {RTOL_F32}) OK")


def check_tol(name, got, want, tol, what):
    err = max_norm_err(got, want)
    ok = err <= tol
    log(f"  {name}: {what}, max err {err:.3e} of max |ref| "
        f"(tolerance {tol}) {'OK' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} {what}: error {err} > {tol}")


def report_compiled(name, compiled, seconds):
    log(f"  {name}: compile {seconds:.2f} s")
    try:
        ma = compiled.memory_analysis()
        log(f"  {name}: memory_analysis argument "
            f"{ma.argument_size_in_bytes} B, output "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
            f"generated code {ma.generated_code_size_in_bytes} B")
    except Exception as e:  # noqa: BLE001 — the field set varies by backend
        log(f"  {name}: memory_analysis unavailable ({e!r})")


def report_peak(device, name):
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"  {name}: peak_bytes_in_use "
        f"{peak if peak is not None else 'not reported'}")


def smoke_times(name, fn, n=3):
    """Host-clock times of n calls that each end in block_until_ready."""
    import jax

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"  {name}: smoke timing (not a benchmark), ms per step "
        + ", ".join(f"{t:.3f}" for t in times))


# ---- SCM ---------------------------------------------------------------------

def scm_config(sz: Sizes, amp: bool = True, dp_devices: int = 1):
    """The flagship config through the CLI's parser (cli/config.py)."""
    from dualmessagepassing_tpu.cli.config import get_train_config

    return get_train_config([
        "--train_batch_size", str(sz.scm_bsz), "--train_epochs", "1",
        "--max_npv", "8", "--max_npe", "8", "--max_npvl", "16",
        "--max_npel", "16", "--max_ngv", "64", "--max_nge", "256",
        "--max_ngvl", "16", "--max_ngel", "16", "--add_rev", "True",
        "--hid_dim", "64", "--pred_hid_dim", "64",
        "--rep_num_pattern_layers", "3", "--rep_num_graph_layers", "3",
        "--filter_net", "ScalarFilter",
        "--match_weights", "nodeedge", "--match_loss_w", "1.0",
        "--amp", str(amp),
        "--dp_devices", str(dp_devices),
        "--save_model_dir", tempfile.gettempdir()])


def scm_datasets(sz: Sizes, seed: int = 0):
    """Complex-envelope pairs made from `seed`, wrapped as
    cli/scm_train.build_datasets wraps them. 0-3 copies of the pattern are
    planted into each graph: at 16 labels a random graph holds almost no
    match, and all-zero counts would leave the count head at its zero
    init."""
    from dualmessagepassing_tpu.data.dataset import (CollateView,
                                                     GraphAdjDataset,
                                                     collate_kind_for)
    from dualmessagepassing_tpu.data.synthetic import generate_pair

    rng = np.random.default_rng(seed)
    pairs = [generate_pair(rng, pv=8, pe=8, gv=64, ge=256, num_vlabels=16,
                           num_elabels=16, p_v_max=8, p_e_max=8,
                           g_v_max=64, g_e_max=256, pair_id=str(i),
                           plant=i % 4)
             for i in range(sz.scm_bsz * sz.scm_steps)]
    return {"train": CollateView(GraphAdjDataset(pairs),
                                 collate_kind_for("DMPNN"))}


def scm_setup(sz: Sizes, amp: bool = True, dp_devices: int = 1):
    """(config, datasets, model, variables) as cli/scm_train.py builds them."""
    import jax

    from dualmessagepassing_tpu.cli.config import (process_model_config,
                                                   to_model_config)
    from dualmessagepassing_tpu.models.scm_models import build_model
    from dualmessagepassing_tpu.train.schedules import derive_schedule_config
    from __graft_entry__ import _flagship_config

    config = scm_config(sz, amp, dp_devices)
    datasets = scm_datasets(sz)
    for ds in datasets.values():
        ds.dataset.add_reversed_edges(config["max_npel"], config["max_ngel"])
    neigenv, eeigenv = datasets["train"].dataset.compute_eigenvalue_bounds()
    model_cfg = to_model_config(process_model_config(config)).replace(
        init_neigenv=neigenv, init_eeigenv=eeigenv)
    flagship = _flagship_config()
    for f in ("max_ngv", "max_nge", "max_npv", "max_npe", "hid_dim",
              "rep_num_pattern_layers", "rep_num_graph_layers", "rep_net"):
        assert getattr(model_cfg, f) == getattr(flagship, f), f
    model = build_model(model_cfg)
    _, pattern, graph, _, _ = datasets["train"].batchify(range(2), "none")
    variables = jax.jit(model.init)(jax.random.PRNGKey(config["seed"]),
                                    pattern, graph)
    config.update(derive_schedule_config(len(datasets["train"]), config))
    return config, datasets, model, variables


def _scm_step_args(config, datasets, idx, key):
    import jax.numpy as jnp

    _, pattern, graph, counts, (nw, ew) = datasets["train"].batchify(
        idx, config["match_weights"])
    f = jnp.float32
    # neg_slp, match_loss_w, match_reg_w, rep_reg_w, lr multiplier
    return (pattern, graph, counts, nw, ew, f(0.2), f(1.0), f(0.0), f(0.0),
            f(1.0), key)


def run_scm(sz: Sizes, device):
    """Train a few flagship steps; returns (model, trained variables,
    reference batch)."""
    import jax

    from dualmessagepassing_tpu.train import (BucketSampler, TrainState,
                                              make_optimizer,
                                              make_train_step, train_epoch)
    from dualmessagepassing_tpu.train.checkpoint import (restore_state,
                                                         save_state)

    log(f"[scm] flagship DMPNN, batch {sz.scm_bsz}, amp on, "
        f"{sz.scm_steps} steps")
    config, datasets, model, variables = scm_setup(sz)
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(variables))
    log(f"  model: {n_params} parameters; train pairs "
        f"{len(datasets['train'])}")
    tx = make_optimizer(config["lr"], config["weight_decay"],
                        config["max_grad_norm"])
    state = TrainState.create(variables, tx)
    step = make_train_step(model, tx, config["bp_loss"],
                           config["match_weights"],
                           eval_metric=config["eval_metric"], amp=True)
    args = _scm_step_args(config, datasets, range(sz.scm_bsz),
                          jax.random.PRNGKey(1))
    t0 = time.perf_counter()
    compiled = step.lower(state, *args).compile()
    report_compiled("scm train step", compiled, time.perf_counter() - t0)

    sampler = BucketSampler(datasets["train"].sizes(), ["g_len", "p_len"],
                            sz.scm_bsz, seed=0)
    t0 = time.perf_counter()
    state, totals = train_epoch(state, step, datasets["train"], sampler,
                                config, 0, jax.random.PRNGKey(2))
    log(f"  train_epoch: {len(sampler)} steps in "
        f"{time.perf_counter() - t0:.2f} s (first call includes "
        f"compile-cache load), loss {totals['total']:.6f}")
    assert np.isfinite(totals["total"]), totals
    report_peak(device, "scm")

    def one():
        nonlocal state
        state, losses = step(state, *args)
        return losses["total"]

    smoke_times("scm train step", one)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "epoch0")
        save_state(path, state)
        back = restore_state(path, like=state)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    log(f"  checkpoint: {len(jax.tree_util.tree_leaves(state))} leaves "
        "saved and restored exactly")
    _, pattern, graph, _, _ = datasets["train"].batchify(
        range(sz.ref_bsz), "none")
    return model, state.variables(), (pattern, graph)


@contextlib.contextmanager
def _precision(p):
    import jax

    if p is None:
        yield
    else:
        with jax.default_matmul_precision(p):
            yield


def scm_reference(model, variables, batch, accel, cpu):
    """SCM forward on `accel` against the same forward on `cpu`."""
    import jax
    import jax.numpy as jnp

    from dualmessagepassing_tpu.utils.amp import (cast_floats,
                                                  compute_dtype_scope)

    log(f"[scm reference] forward on {accel.platform} vs {cpu.platform}, "
        f"batch {batch[0].batch_size}")

    def fwd(v, p, g):
        out = model.apply(v, p, g)
        return out["pred_c"], out["pred_v"], out["pred_e"]

    def fwd_amp(v, p, g):
        with compute_dtype_scope(jnp.bfloat16):
            out = model.apply(cast_floats(v, jnp.bfloat16),
                              cast_floats(p, jnp.bfloat16),
                              cast_floats(g, jnp.bfloat16))
        return cast_floats((out["pred_c"], out["pred_v"], out["pred_e"]),
                           jnp.float32)

    def run(fn, dev, prec):
        args = jax.device_put((variables, *batch), dev)
        with _precision(prec):
            return jax.device_get(jax.jit(fn)(*args))

    names = ("pred_c", "pred_v", "pred_e")
    want = run(fwd, cpu, "highest")
    assert min(float(np.max(np.abs(x))) for x in want) > 0, \
        "all-zero predictions make the comparison vacuous"
    for got, check in ((run(fwd, accel, "highest"), None),
                       (run(fwd, accel, None), "tf32"),
                       (run(fwd_amp, accel, None), "bf16")):
        for name, g, w in zip(names, got, want):
            if check is None:
                assert_close_f32(name, g, w)
            elif check == "tf32":
                check_tol(name, g, w, TOL_TF32, "default precision (TF32)")
            else:
                check_tol(name, g, w, TOL_BF16, "bf16 compute (amp)")


# ---- UNC ---------------------------------------------------------------------

def make_hin(sz: Sizes, seed: int = 0):
    """Heavy-tailed triplets at the requested counts, made from `seed`."""
    from dualmessagepassing_tpu.data.synthetic import generate_large_graph

    triplets, _ = generate_large_graph(sz.unc_nodes, sz.unc_links,
                                       num_rels=sz.unc_rels, seed=seed,
                                       power_law=True)
    return triplets


def seed_nodes_for(triplets, n_edges: int, seed: int = 0):
    """Nodes whose incident links number at least `n_edges` (train_unc
    trains on links touching the seed nodes, as the reference does with
    seed_node.dat)."""
    rng = np.random.default_rng(seed)
    n = int(triplets[:, [0, 2]].max()) + 1
    deg = np.bincount(triplets[:, 0], minlength=n) + np.bincount(
        triplets[:, 2], minlength=n)
    order = rng.permutation(n)
    k = int(np.searchsorted(np.cumsum(deg[order]), n_edges)) + 1
    return set(int(x) for x in order[:k])


def unc_kwargs(sz: Sizes):
    return dict(h_dim=sz.h_dim, n_layers=2, lr=1e-2, reg_param=1e-2,
                negative_rate=sz.negative_rate, dropout=0.2,
                graph_batch_size=sz.unc_batch, graph_split_size=0.5,
                sampler="randomwalk", sample_depth=sz.depth,
                sample_width=sz.width)


def run_unc(sz: Sizes, device):
    """train_unc for a few steps, then write the exported embeddings."""
    from dualmessagepassing_tpu.unc import save_embeddings
    from dualmessagepassing_tpu.unc.driver import train_unc

    triplets = make_hin(sz)
    seeds = seed_nodes_for(triplets, sz.unc_batch * sz.unc_steps)
    log(f"[unc] train_unc on {sz.unc_nodes} nodes, {sz.unc_rels} link "
        f"types, {len(triplets)} links; h_dim {sz.h_dim}, 2 layers, "
        f"batch {sz.unc_batch}, randomwalk depth {sz.depth} width "
        f"{sz.width}, amp on; {len(seeds)} seed nodes")
    marks = {}

    def unc_log(msg):
        marks.setdefault(msg.split("...")[0].split(";")[0], time.perf_counter())
        log(f"  train_unc: {msg}")

    t0 = time.perf_counter()
    embs, coverage = train_unc(triplets, sz.unc_nodes, sz.unc_rels,
                               n_epochs=1, seed_nodes=seeds, amp=True,
                               log=unc_log, **unc_kwargs(sz))
    total = time.perf_counter() - t0
    if "compiling train step (AOT)" in marks and "compile done" in marks:
        log(f"  train step compile "
            f"{marks['compile done'] - marks['compiling train step (AOT)']:.2f}"
            f" s; train_unc total {total:.2f} s (includes the export pass)")
    assert embs.shape == (sz.unc_nodes, sz.h_dim), embs.shape
    assert np.isfinite(embs).all()
    report_peak(device, "unc")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "emb.dat")
        save_embeddings(path, "chip_smoke", embs)
        with open(path) as f:
            n_lines = sum(1 for _ in f)
    assert n_lines == sz.unc_nodes + 1, n_lines
    log(f"  export: {sz.unc_nodes} embeddings written, coverage "
        f"{coverage * 100:.1f}%")
    return triplets


def unc_batch(sz: Sizes, triplets, seed: int = 1, e_multiple: int = 1):
    """One padded training batch at the train_unc envelope."""
    from dualmessagepassing_tpu.parallel.ep_unc import pad_e_max
    from dualmessagepassing_tpu.unc.data import WholeGraph
    from dualmessagepassing_tpu.unc.driver import sample_batch

    graph = WholeGraph(sz.unc_nodes, sz.unc_rels, triplets)
    rng = np.random.default_rng(seed)
    v_max = sz.unc_nodes
    e_max = pad_e_max(min(v_max * sz.width, graph.num_edges), e_multiple)
    edges = triplets[rng.permutation(len(triplets))[:sz.unc_batch]]
    return sample_batch(graph, edges, "randomwalk", sz.depth, sz.width, 0.5,
                        sz.negative_rate, v_max, e_max,
                        sz.unc_batch * (1 + sz.negative_rate), rng,
                        send_keys=e_multiple == 1)


def unc_model(sz: Sizes, **kw):
    from dualmessagepassing_tpu.unc.model import UNCTrainModel

    return UNCTrainModel(num_nodes=sz.unc_nodes, num_rels=sz.unc_rels,
                         h_dim=sz.h_dim, nlabel=0, num_hidden_layers=2,
                         dropout=0.2, reg_param=1e-2, backbone="DMPNN",
                         sorted_edges=True, **kw)


def unc_loss_fn(model, amp):
    from dualmessagepassing_tpu.unc.model import (UNCTrainModel,
                                                  apply_unc_forward)

    def loss(params, stats, sub, key):
        (out, _), _ = apply_unc_forward(model, params, stats, sub, key,
                                        amp=amp)
        return model.apply({"params": params}, out, sub["edge_type"],
                           sub["edge_mask"], sub["samples"], sub["labels"],
                           sub["sample_mask"], sub["node_mask"],
                           method=UNCTrainModel.unsupervised_loss)

    return loss


def unc_reference(sz: Sizes, triplets, accel, cpu):
    """One UNC train step's loss and gradients, GPU against CPU; the
    compiled amp train step's memory and smoke timings."""
    import jax
    import jax.numpy as jnp
    import optax

    from dualmessagepassing_tpu.unc.driver import make_unc_train_step
    from dualmessagepassing_tpu.unc.model import init_unc_variables

    padded = unc_batch(sz, triplets)
    log(f"[unc reference] loss and gradients on {accel.platform} vs "
        f"{cpu.platform}; sampled {int(padded['node_mask'].sum())} nodes, "
        f"{int(padded['edge_mask'].sum())} edges (envelope "
        f"{len(padded['node_mask'])} / {len(padded['edge_mask'])})")
    model = unc_model(sz)
    sub = {k: jax.device_put(jnp.asarray(v), accel) for k, v in padded.items()}
    variables = init_unc_variables(model, jax.random.PRNGKey(0), sub)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    key = jax.random.PRNGKey(3)

    def run(amp, dev, prec):
        args = jax.device_put((params, stats, sub, key), dev)
        with _precision(prec):
            return jax.device_get(jax.jit(jax.value_and_grad(
                unc_loss_fn(model, amp)))(*args))

    want = run(False, cpu, "highest")
    for got, check in ((run(False, accel, "highest"), None),
                       (run(False, accel, None), "tf32"),
                       (run(True, accel, None), "bf16")):
        for name, g, w in zip(("loss", "gradients"), got, want):
            if check is None:
                assert_close_f32(name, g, w)
            elif check == "tf32":
                check_tol(name, g, w, TOL_TF32, "default precision (TF32)")
            else:
                check_tol(name, g, w, TOL_BF16, "bf16 compute (amp)")

    tx = optax.adam(1e-2)
    opt = tx.init(params)
    step = make_unc_train_step(model, tx, amp=True)
    t0 = time.perf_counter()
    compiled = step.lower(params, opt, stats, sub, key).compile()
    report_compiled("unc train step", compiled, time.perf_counter() - t0)
    state = [params, opt, stats]

    def one():
        state[0], state[1], state[2], loss = compiled(*state, sub, key)
        return loss

    smoke_times("unc train step", one)
    report_peak(accel, "unc reference")


# ---- four devices ------------------------------------------------------------

def scm_dp_check(sz: Sizes, devices):
    """One data-parallel SCM step on `devices` against one device, same
    global batch (float32, highest precision, unchunked). The update is
    plain SGD, so updated parameters differ only as much as gradients do
    (an Adam-family first step is sign(grad) and flips on noise-level
    gradients)."""
    import jax
    import optax

    from dualmessagepassing_tpu.parallel.dp import make_dp_mesh
    from dualmessagepassing_tpu.train import (TrainState, dp_replicate_state,
                                              make_train_step)

    n = len(devices)
    log(f"[scm dp] --dp_devices {n} vs 1 device, flagship, batch "
        f"{sz.scm_bsz}")
    config, datasets, model, variables = scm_setup(sz, amp=False,
                                                   dp_devices=n)
    tx = optax.sgd(config["lr"])
    args = _scm_step_args(config, datasets, range(sz.scm_bsz),
                          jax.random.PRNGKey(1))
    # host copies: each step donates its state, so each gets fresh buffers
    host = jax.device_get(TrainState.create(variables, tx))
    with jax.default_matmul_precision("highest"):
        one = make_train_step(model, tx, config["bp_loss"],
                              config["match_weights"], accum_chunks=1)
        s1, l1 = one(jax.device_put(host, devices[0]),
                     *jax.device_put(args, devices[0]))
        mesh = make_dp_mesh(n, devices=devices)
        dp = make_train_step(model, tx, config["bp_loss"],
                             config["match_weights"], accum_chunks=1,
                             mesh=mesh)
        sn, ln = dp(dp_replicate_state(mesh, host), *args)
    assert_close_f32(f"dp x{n} loss", ln["total"], l1["total"])
    assert_close_f32(f"dp x{n} updated params", sn.params, s1.params)


def unc_ep_checks(sz: Sizes, triplets, devices):
    """One ep-psum and one halo UNC train step on `devices` against the
    single-device step on the same batch (float32, highest precision,
    plain SGD as in scm_dp_check)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from dualmessagepassing_tpu.parallel.ep_unc import (make_ep_train_step,
                                                        shard_sub)
    from dualmessagepassing_tpu.parallel.halo_unc import (
        build_halo_sub, halo_envelope, make_halo_train_step, shard_halo_sub)
    from dualmessagepassing_tpu.unc.driver import make_unc_train_step
    from dualmessagepassing_tpu.unc.model import init_unc_variables

    n = len(devices)
    padded = unc_batch(sz, triplets, e_multiple=n)
    log(f"[unc ep] --ep_devices {n} psum and halo vs 1 device; sampled "
        f"{int(padded['node_mask'].sum())} nodes, "
        f"{int(padded['edge_mask'].sum())} edges")
    model = unc_model(sz)
    sub = {k: jax.device_put(jnp.asarray(v), devices[0])
           for k, v in padded.items()}
    variables = init_unc_variables(model, jax.random.PRNGKey(0), sub)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    tx = optax.sgd(1e-2)
    key = jax.random.PRNGKey(3)
    mesh = Mesh(np.asarray(devices), ("ep",))
    with jax.default_matmul_precision("highest"):
        p1, _, _, l1 = make_unc_train_step(model, tx)(
            params, tx.init(params), stats, sub, key)
        ep_step = make_ep_train_step(unc_model(sz, ep_axis="ep"), tx, mesh)
        pe, _, _, le = ep_step(params, tx.init(params), stats,
                               shard_sub(mesh, padded), key)
        vp, ep, b = halo_envelope(len(padded["nid"]),
                                  len(padded["senders"]), n)
        dev, _ = build_halo_sub(padded, n, vp, ep, b)
        halo_step = make_halo_train_step(
            unc_model(sz, ep_axis="ep", node_sharding="owner"), tx, mesh)
        ph, _, _, lh = halo_step(params, tx.init(params), stats,
                                 shard_halo_sub(mesh, dev), key)
    for name, loss, p in (("ep-psum", le, pe), ("halo", lh, ph)):
        assert_close_f32(f"{name} x{n} loss", loss, l1)
        assert_close_f32(f"{name} x{n} updated params", p, p1)


# ---- entry point -------------------------------------------------------------

def run_single(sz: Sizes, accel, cpu):
    model, variables, batch = run_scm(sz, accel)
    scm_reference(model, variables, batch, accel, cpu)
    triplets = run_unc(sz, accel)
    unc_reference(sz, triplets, accel, cpu)


def run_multi(sz: Sizes, devices):
    scm_dp_check(sz, devices)
    unc_ep_checks(sz, make_hin(sz), devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4: run only the four-GPU paths")
    args = ap.parse_args(argv)

    import jax

    # the CPU device of this process runs the references
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devices[0].platform!r}); this "
             "script runs only on NVIDIA GPUs")
    if len(devices) < args.devices:
        fail(f"--devices {args.devices} needs {args.devices} GPUs, JAX "
             f"found {len(devices)}")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import dualmessagepassing_tpu
        from dualmessagepassing_tpu import native
        from dualmessagepassing_tpu.utils.compile_cache import (
            enable_compile_cache)
    except ImportError as e:
        fail(f"the dualmessagepassing_tpu package is not beside this "
             f"script ({e})")
    cache = enable_compile_cache()

    import jaxlib

    log(gpu_name_and_power())
    log(f"python {sys.version.split()[0]}, jax {jax.__version__}, jaxlib "
        f"{jaxlib.__version__}, package {dualmessagepassing_tpu.__version__}")
    log(f"devices: {[f'{d.id}:{d.device_kind}' for d in devices]}")
    log(f"native host kernels loaded: {native.available()}")
    log(f"compile cache: {cache}")
    t0 = time.perf_counter()
    if args.devices == 1:
        run_single(FULL, devices[0], jax.devices("cpu")[0])
    else:
        run_multi(FULL, devices[:args.devices])
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
