"""SCM training/evaluation driver: jitted train step, epoch loops, metrics.

Reference: /root/reference/SubgraphCountingMatching/train.py:449-1061.
Differences forced by the static-shape XLA design:
  * one jitted train_step covers every schedule step — schedule scalars
    (neg_slope, loss weights, lr multiplier) enter as traced arguments;
  * batches come from the bucket samplers at a fixed (V_max, E_max)
    envelope, so a single compiled program serves the whole epoch.

Evaluation metrics (train.py:847-1061): MAE, MSE, RMSE on relu'd counts,
AUC of count>0 detection, MNED/MEED (mean per-graph L1 distance between
predicted and gold node/edge weight vectors), plus timing.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from ..nn import struct

from ..graph import GraphBatch
from .losses import scm_loss
from .schedules import lr_schedule, scalar_schedule


@struct.dataclass
class TrainState:
    params: Any          # trainable "params" collection
    batch_stats: Any     # BatchNorm running stats ({} if none)
    opt_state: Any
    step: jnp.ndarray    # scalar int32

    @classmethod
    def create(cls, variables, tx) -> "TrainState":
        params = variables["params"]
        stats = variables.get("batch_stats", {})
        return cls(params, stats, tx.init(params), jnp.int32(0))

    def variables(self):
        v = {"params": self.params}
        if self.batch_stats:
            v["batch_stats"] = self.batch_stats
        return v


def make_optimizer(lr: float, weight_decay: float = 1e-5,
                   max_grad_norm: float = 8.0) -> optax.GradientTransformation:
    """AdamW(amsgrad) + global-norm clip (train.py:1231, clip 8.0).

    optax has no amsgrad flag on adamw; compose amsgrad + decoupled weight
    decay + clip explicitly to match torch AdamW(amsgrad=True).
    """
    chain = []
    if max_grad_norm and max_grad_norm > 0:
        chain.append(optax.clip_by_global_norm(max_grad_norm))
    chain.append(optax.scale_by_amsgrad())
    if weight_decay:
        chain.append(optax.add_decayed_weights(weight_decay))
    chain.append(optax.scale(-lr))
    return optax.chain(*chain)


def make_train_step(model, tx, bp_loss: str = "MSE",
                    return_weights: str = "none",
                    eval_metric: Optional[str] = None,
                    amp: bool = False,
                    accum_chunks: Optional[int] = None,
                    mesh=None) -> Callable:
    """Jitted (state, batch, scalars) -> (state, losses).

    amp=True runs the model forward/backward in bfloat16 (f32 master
    params and optimizer state; losses/regularizers in f32; the model's
    gate/table dtype pins follow utils.amp's trace-time compute dtype) —
    halving activation bytes is the lever for a step bound by memory
    traffic (ARCHITECTURE.md §8.4).

    accum_chunks=k > 1 computes the batch gradient as a lax.scan of k
    sequential microbatches (grads and losses averaged over equal-size
    chunks; one optimizer update). It bounds the activation working set:
    at large batch every fusion's [B, E, H] intermediates round-trip
    device memory, while a chunk's working set is smaller. Whether it
    pays on the GPU is unmeasured (ROADMAP).

    accum_chunks=None (the round-5 DEFAULT) auto-selects ~128-pair
    chunks from the traced batch size (largest k <= bsz//128 dividing
    bsz; 1 under data parallelism, where the per-device batch is already
    small). Pass an explicit int (1 = never chunk) to override.

    Equivalence scope: every bsz-denominated component (count loss,
    match losses/regs) recombines EXACTLY (chunk sizes are equal by
    construction). The rep regularizer divides by the chunk's TRUE mask
    count, so when graph sizes vary across chunks its chunk-mean weights
    each chunk's per-element mean equally instead of element-weighting —
    a deviation of order rep_reg_w (default 1e-4) times the relative
    size spread; the bucket samplers group similar sizes, keeping it
    negligible. Chunked dropout draws per-chunk RNGs and BatchNorm (when
    present) sees chunks sequentially — stochastic details only."""

    use_node_w = "node" in return_weights
    use_edge_w = "edge" in return_weights

    def refine(kind, w):
        """Weight targets follow the model's length refinement
        (train.py:630,641) — e.g. CNN pooling changes the sequence length."""
        if w is None:
            return None
        fn = getattr(model, f"refine_{kind}_weights", None)
        if fn is None:
            return w
        return fn(w[..., None])[..., 0]

    def chunk_grads(params, batch_stats, pattern, graph, counts,
                    node_weights, edge_weights, scal, dropout_rng):
        """(grads, losses, new_stats) of the mean loss over one chunk."""
        neg_slope, match_loss_w, match_reg_w, rep_reg_w = scal

        def loss_fn(params):
            if amp:
                from ..utils.amp import cast_floats, compute_dtype_scope

                with compute_dtype_scope(jnp.bfloat16):
                    variables = {"params": cast_floats(params, jnp.bfloat16)}
                    if batch_stats:
                        variables["batch_stats"] = batch_stats
                    out, mutated = model.apply(
                        variables, cast_floats(pattern, jnp.bfloat16),
                        cast_floats(graph, jnp.bfloat16), train=True,
                        rngs={"dropout": dropout_rng},
                        mutable=["batch_stats"])
                out = cast_floats(out, jnp.float32)
            else:
                variables = {"params": params}
                if batch_stats:
                    variables["batch_stats"] = batch_stats
                out, mutated = model.apply(
                    variables, pattern, graph, train=True,
                    rngs={"dropout": dropout_rng}, mutable=["batch_stats"])
            losses = scm_loss(
                out, counts,
                node_weights if use_node_w else None,
                edge_weights if use_edge_w else None,
                bp_loss=bp_loss, neg_slope=neg_slope,
                match_loss_w=match_loss_w, match_reg_w=match_reg_w,
                rep_reg_w=rep_reg_w, eval_metric=eval_metric,
            )
            return losses["total"], (losses, mutated.get("batch_stats", {}))

        grads, (losses, new_stats) = jax.grad(loss_fn, has_aux=True)(params)
        return grads, losses, new_stats

    @functools.partial(jax.jit, donate_argnums=(0,))
    def train_step(state: TrainState, pattern: GraphBatch, graph: GraphBatch,
                   counts, node_weights, edge_weights,
                   neg_slope, match_loss_w, match_reg_w, rep_reg_w,
                   lr_mult, dropout_rng):
        node_weights = refine("node", node_weights) if use_node_w else node_weights
        edge_weights = refine("edge", edge_weights) if use_edge_w else edge_weights
        scal = (neg_slope, match_loss_w, match_reg_w, rep_reg_w)
        batch = (pattern, graph, counts, node_weights, edge_weights)

        bsz = counts.shape[0]
        if accum_chunks is None:
            # auto (trace-time: bsz is static): largest k <= bsz//128
            # that divides bsz; under DP the per-device batch is already
            # chunk-sized, so stay unchunked unless asked explicitly
            k = 1
            if mesh is None:
                k = max(bsz // 128, 1)
                while bsz % k:
                    k -= 1
        else:
            k = accum_chunks
        if k <= 1:
            grads, losses, new_stats = chunk_grads(
                state.params, state.batch_stats, *batch, scal, dropout_rng)
        else:
            if bsz % k:
                raise ValueError(
                    f"batch size {bsz} not divisible by accum_chunks {k}")

            def split(x):
                return x.reshape((k, x.shape[0] // k) + x.shape[1:])

            chunks = jax.tree.map(split, batch)
            rngs = jax.random.split(dropout_rng, k)

            def body(carry, xs):
                g_acc, stats = carry
                chunk, rng = xs
                g, losses, new_stats = chunk_grads(
                    state.params, stats, *chunk, scal, rng)
                g_acc = jax.tree.map(jnp.add, g_acc, g)
                return (g_acc, new_stats if stats else stats), losses

            g0 = jax.tree.map(jnp.zeros_like, state.params)
            (g_sum, new_stats), per_chunk = jax.lax.scan(
                body, (g0, state.batch_stats), (chunks, rngs))
            grads = jax.tree.map(lambda g: g / k, g_sum)
            # equal-size chunks -> mean over chunk means == batch mean
            losses = jax.tree.map(lambda x: jnp.mean(x, axis=0), per_chunk)

        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        updates = jax.tree.map(lambda u: u * lr_mult, updates)
        params = optax.apply_updates(state.params, updates)
        stats = new_stats if state.batch_stats else state.batch_stats
        return TrainState(params, stats, opt_state, state.step + 1), losses

    if mesh is None:
        return train_step

    # --- data-parallel wrapper (SURVEY §2.4 DP row; new capability, the
    # reference is single-device): the SAME traced program runs SPMD over
    # the mesh — batch leaves committed to a 'dp' axis-0 sharding, state
    # replicated (dp_replicate_state below), and GSPMD inserts the psum
    # for the gradient all-reduce. Correctness is placement-only: every
    # loss is a batch mean, so the logical program is unchanged.
    from ..parallel.dp import replicate as _dp_replicate, shard_batch
    ndev = int(mesh.devices.size)
    inner_step = train_step

    def dp_train_step(state, pattern, graph, counts, node_weights,
                      edge_weights, *scal):
        bsz = counts.shape[0]
        # ragged final curriculum batch: replicate (computed redundantly
        # on every device for one batch per epoch) rather than crash
        put = shard_batch if bsz % ndev == 0 else _dp_replicate
        pattern, graph, counts, node_weights, edge_weights = put(
            mesh, pattern, graph, counts, node_weights, edge_weights)
        return inner_step(state, pattern, graph, counts, node_weights,
                          edge_weights, *scal)

    return dp_train_step


def dp_replicate_state(mesh, state: "TrainState") -> "TrainState":
    """Commit a TrainState replicated over a DP mesh (params + opt state
    live once per device; jit then compiles the train step SPMD)."""
    from ..parallel.dp import replicate

    return replicate(mesh, state)


def make_eval_step(model) -> Callable:
    @jax.jit
    def eval_step(variables, pattern: GraphBatch, graph: GraphBatch):
        out = model.apply(variables, pattern, graph, train=False)
        return (out["pred_c"], out["pred_v"], out["pred_e"],
                out["g_v_mask"], out["g_e_mask"])

    return eval_step


def train_epoch(
    state: TrainState,
    train_step: Callable,
    dataset,
    sampler,
    config: Dict[str, Any],
    epoch: int,
    rng_key,
    log_fn: Optional[Callable[[str], None]] = None,
    writer=None,
    data_type: str = "train",
) -> Tuple[TrainState, Dict[str, float]]:
    """One epoch over sampler batches (train.py:486-784).

    Two schedule clocks, matching the reference exactly:
      * scalar schedules (neg_slp, loss weights) advance on
        `epoch * full_epoch_steps + batch_id` where full_epoch_steps ignores
        the curriculum's used_ratio — the reference's len(data_loader)
        inherits BucketSampler.__len__ (sampler.py:76-77, train.py:451-452);
      * the LR schedule advances once per yielded batch (scheduler.step(),
        train.py:685-686) — cumulative count carried by state.step.
    """
    epoch_steps = len(sampler)
    full_epoch_steps = getattr(sampler, "full_len", epoch_steps)
    total_steps = config.get("train_epochs", 100) * max(full_epoch_steps, 1)
    neg_slp_s = scalar_schedule(config.get("neg_pred_slp", 0.2), total_steps)
    match_w_s = scalar_schedule(config.get("match_loss_w", 0.0), total_steps)
    match_r_s = scalar_schedule(config.get("match_reg_w", 0.0), total_steps)
    rep_r_s = scalar_schedule(config.get("rep_reg_w", 0.0), total_steps)
    from ..constants import MIN_PERCENT
    lr_s = lr_schedule(
        config.get("scheduler", "constant"),
        num_warmup_steps=config.get("num_warmup_steps", 0),
        num_schedule_steps=config.get("num_schedule_steps", total_steps),
        num_cycles=config.get("num_cycles", 2),
        min_percent=config.get("min_percent", MIN_PERCENT),
    )
    return_weights = config.get("pred_return_weights", "none")
    # cumulative LR clock (reference scheduler.step() per yielded batch)
    lr_step0 = int(state.step)

    keys = None
    # device-side loss accumulation: reading a loss back every step would
    # force a sync and serialize host collate with device compute; keep
    # per-step losses on device and read once at epoch end
    pending = []
    sched_vals = []
    bszs = []
    n = 0
    total_edges = 0
    try:
        host_sizes = dataset.sizes()
    except AttributeError:
        host_sizes = None
    import time as _time
    t_epoch = _time.perf_counter()
    for batch_id, idx in enumerate(sampler):
        ids, pattern, graph, counts, (nw, ew) = dataset.batchify(
            idx, return_weights)
        step = epoch * full_epoch_steps + batch_id     # scalar clock
        lr_mult = lr_s(lr_step0 + batch_id)            # LR clock
        rng_key, drop_key = jax.random.split(rng_key)
        # placeholder weight targets (EdgeSeqBatch has one mask for both)
        v_mask = getattr(graph, "node_mask", None)
        if v_mask is None:
            v_mask = graph.mask
        e_mask = getattr(graph, "edge_mask", None)
        if e_mask is None:
            e_mask = graph.mask
        scal = dict(neg_slp=neg_slp_s(step), match_loss_w=match_w_s(step),
                    match_reg_w=match_r_s(step), rep_reg_w=rep_r_s(step),
                    lr=lr_mult * config.get("lr", 1e-3), step=step)
        state, losses = train_step(
            state, pattern, graph, counts,
            nw if nw is not None else jnp.zeros(v_mask.shape, jnp.float32),
            ew if ew is not None else jnp.zeros(e_mask.shape, jnp.float32),
            jnp.float32(scal["neg_slp"]), jnp.float32(scal["match_loss_w"]),
            jnp.float32(scal["match_reg_w"]), jnp.float32(scal["rep_reg_w"]),
            jnp.float32(lr_mult), drop_key,
        )
        bsz = counts.shape[0]
        # count real edges host-side (a device read here would serialize
        # host collate with device compute)
        if host_sizes is not None:
            total_edges += sum(host_sizes[i]["g_len"] + host_sizes[i]["p_len"]
                               for i in idx)
        n += bsz
        if keys is None:
            keys = tuple(losses.keys())
        pending.append({k: losses[k] for k in keys})
        sched_vals.append(scal)
        bszs.append(bsz)
        # a sync every 8 steps bounds the un-synced dispatch chain
        if len(pending) % 8 == 0:
            jax.block_until_ready(losses["total"])
        if log_fn and batch_id % config.get("log_every", 100) == 0 \
                and batch_id > 0:
            log_fn(f"epoch {epoch} step {batch_id}/{epoch_steps} "
                   f"loss {float(pending[-1]['total']):.6f}")
    jax.block_until_ready(state.params)
    dt = _time.perf_counter() - t_epoch
    keys = keys or ()
    totals = {k: 0.0 for k in keys}
    for losses, bsz in zip(pending, bszs):
        for k in keys:
            totals[k] += float(losses[k]) * bsz
    # per-step TensorBoard scalars (reference train.py:688-724) — written
    # after the epoch's sync point so logging never forces a mid-epoch
    # device sync; values and step axis are identical to the reference's
    if writer is not None:
        bp = config.get("bp_loss", "MSE")
        em = config.get("eval_metric", "MAE")
        for losses, scal in zip(pending, sched_vals):
            s = scal["step"]
            if "eval_metric" in losses:
                writer.add_scalar("%s/eval-%s" % (data_type, em),
                                  float(losses["eval_metric"]), s)
            writer.add_scalar("%s/train-%s" % (data_type, bp),
                              float(losses["total"]), s)
            writer.add_scalar("train/lr", scal["lr"], s)
            writer.add_scalar("train/neg_slp", scal["neg_slp"], s)
            writer.add_scalar("train/match_loss_w", scal["match_loss_w"], s)
            writer.add_scalar("train/match_v_loss",
                              float(losses["match_v_loss"]), s)
            writer.add_scalar("train/match_e_loss",
                              float(losses["match_e_loss"]), s)
            writer.add_scalar("train/match_reg_w", scal["match_reg_w"], s)
            writer.add_scalar("train/match_v_reg",
                              float(losses["match_v_reg"]), s)
            writer.add_scalar("train/match_e_reg",
                              float(losses["match_e_reg"]), s)
            writer.add_scalar("train/rep_reg_w", scal["rep_reg_w"], s)
            writer.add_scalar("train/rep_reg", float(losses["rep_reg"]), s)
    out = {k: v / max(n, 1) for k, v in totals.items()}
    out["edges_per_sec"] = total_edges / dt if dt > 0 else 0.0
    return state, out


def roc_auc(labels, scores) -> float:
    """Area under the ROC curve of `scores` for boolean `labels`, from
    average ranks (ties share their mean rank): the Mann-Whitney U
    statistic over n_pos * n_neg. NaN when one class is absent."""
    labels = np.asarray(labels, bool).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(scores.size, np.float64)
    # average rank per run of equal scores (1-based)
    starts = np.flatnonzero(np.r_[True, sorted_scores[1:] != sorted_scores[:-1]])
    ends = np.r_[starts[1:], scores.size]
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def evaluate_epoch(
    params,
    eval_step: Callable,
    dataset,
    sampler,
    return_weights: str = "none",
    model=None,
) -> Dict[str, Any]:
    """Eval metrics suite (train.py:847-1061). `model` is needed only for
    architectures whose refine hooks change sequence lengths (CNN) so the
    weight targets can follow (train.py:630,641)."""

    def refine(kind, w):
        if w is None or model is None:
            return w
        fn = getattr(model, f"refine_{kind}_weights", None)
        if fn is None:
            return w
        return fn(w[..., None])[..., 0]
    preds, golds = [], []
    all_ids = []
    neds, eeds = [], []
    t_total = 0.0
    n_items = 0
    for idx in sampler:
        ids, pattern, graph, counts, (nw, ew) = dataset.batchify(
            idx, return_weights)
        t0 = time.perf_counter()
        pred_c, pred_v, pred_e, g_v_mask, g_e_mask = eval_step(
            params, pattern, graph)
        pred_c.block_until_ready()
        t_total += time.perf_counter() - t0
        n_items += counts.shape[0]
        all_ids.extend(ids)
        preds.append(np.asarray(pred_c)[:, 0])
        golds.append(np.asarray(counts)[:, 0])
        if pred_v is not None and nw is not None:
            nw_r = refine("node", nw)
            pv = np.maximum(np.asarray(pred_v), 0) * np.asarray(g_v_mask)
            w = np.asarray(nw_r) * np.asarray(g_v_mask)
            neds.append(np.abs(pv - w).sum(axis=1))
        if pred_e is not None and ew is not None:
            ew_r = refine("edge", ew)
            pe = np.maximum(np.asarray(pred_e), 0) * np.asarray(g_e_mask)
            w = np.asarray(ew_r) * np.asarray(g_e_mask)
            eeds.append(np.abs(pe - w).sum(axis=1))

    pred = np.concatenate(preds) if preds else np.zeros(0)
    gold = np.concatenate(golds) if golds else np.zeros(0)
    pred_relu = np.maximum(pred, 0)
    ae = np.abs(pred_relu - gold)
    se = (pred_relu - gold) ** 2
    results: Dict[str, Any] = {
        "MAE": float(ae.mean()) if len(ae) else float("nan"),
        "MSE": float(se.mean()) if len(se) else float("nan"),
        "RMSE": float(np.sqrt(se.mean())) if len(se) else float("nan"),
        "time_avg": t_total / max(n_items, 1),
        "time_total": t_total,
    }
    # AUC of count>0 detection (train.py:1002-1015)
    if len(gold) and (gold > 0).any() and (gold <= 0).any():
        results["AUC"] = roc_auc(gold > 0, pred_relu)
    else:
        results["AUC"] = float("nan")
    results["MNED"] = float(np.concatenate(neds).mean()) if neds else float("nan")
    results["MEED"] = float(np.concatenate(eeds).mean()) if eeds else float("nan")
    # per-sample dumps (reference results JSONs carry raw predictions and
    # errors, train.py:853-881)
    results["ids"] = all_ids
    results["predictions"] = pred_relu.tolist()
    results["counts"] = gold.tolist()
    results["AE"] = ae.tolist()
    results["SE"] = se.tolist()
    if neds:
        results["NED"] = np.concatenate(neds).tolist()
    if eeds:
        results["EED"] = np.concatenate(eeds).tolist()
    return results
