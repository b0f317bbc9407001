"""Pinned full-convergence SCM runs across dataset families.

Trains the flagship DMPNN counting+matching configuration with the
reference training recipe (train.py:1231-1372: AdamW amsgrad wd 1e-5
clip 8.0, cosine-with-warmup-and-restart LR, annealed leaky slope,
match losses, early stop on train-loss AND dev-metric staleness) to
EARLY STOP on an in-repo planted synthetic set, records the full
per-epoch metric trajectory, and gates reruns against the stored
artifact.

`--family` selects the dataset envelope (all four reference families,
SubgraphCountingMatching/README.md:24-117):
  complex — pattern 8V/8E, graph 64V/256E, 16 labels, planted matches.
            Gold weights are SPARSE (~16% nodes / ~3% edges nonzero) so
            the zero predictor is nearly unbeatable; held-out matching
            is settled negative here across data scale, capacity and
            training length (ARCHITECTURE §11).
  er      — UNLABELED Erdős–Rényi: pattern <=4V/10E, graph <=10V/48E,
            1 vertex/edge label (README.md:38-39: max_npvl 1 max_ngvl 1).
            Matches are abundant, gold weights DENSE — the zero
            predictor is weak by construction. This is the round-5
            envelope that settles whether held-out matching is learnable
            anywhere in the framework (VERDICT r4 item 1).
  mutag   — MUTAG-like: pattern <=4V/3E with 2/2 labels, graph <=28V/66E
            with 7/4 labels (README.md:107-108), planted matches.
            Intermediate gold-weight density.

NOT in the default test suite (a full run is ~10-30 min). Usage:
    python scripts/scm_convergence.py --out SCM_CONVERGENCE.json   # record
    python scripts/scm_convergence.py --family er --out SCM_CONVERGENCE_ER.json
    python scripts/scm_convergence.py --check SCM_CONVERGENCE.json # gate
The gate compares final dev MAE/MSE/MNED/MEED at generous tolerances
(0.15 rel) — far above run-to-run jitter at fixed seeds, far below a
real regression. It runs on the default JAX device (--cpu forces the
CPU); on a CPU-only rig pass --pairs 96 --max-epochs 8 for a smoke-scale version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _family_spec(family: str) -> dict:
    """Generation + envelope parameters per reference dataset family
    (SubgraphCountingMatching/README.md:24-117). Each spec gives the
    per-pair sampler kwargs (`sample(rng)`), the fixed caps, the label
    vocab sizes, the count-tail rejection cap, and the reference batch
    size for that family's published command line."""
    if family == "complex":
        return dict(
            caps=dict(p_v_max=8, p_e_max=8, g_v_max=64, g_e_max=256),
            nvl=16, nel=16, p_nvl=16, p_nel=16, count_cap=60, bsz=128,
            sample=lambda rng: dict(pv=8, pe=8, gv=64, ge=256,
                                    plant=int(rng.integers(0, 4))),
            envelope="Complex+rev (8V/8E pattern, 64V/512E graph)")
    if family == "er":
        # Unlabeled ER (README.md:38-39): EVERY injective embedding with
        # the right edges is a match, so counts are naturally large and
        # gold node/edge weights dense — no planting needed. Pattern
        # sizes sampled across the cap range like the published set.
        return dict(
            caps=dict(p_v_max=4, p_e_max=10, g_v_max=10, g_e_max=48),
            nvl=1, nel=1, p_nvl=1, p_nel=1, count_cap=256, bsz=64,
            sample=lambda rng: (lambda pv: dict(
                pv=pv, pe=int(rng.integers(pv, min(10, 3 * pv) + 1)),
                gv=10, ge=int(rng.integers(24, 49)), plant=0))(
                    int(rng.integers(3, 5))),
            envelope="ER+rev (<=4V/10E unlabeled pattern, 10V/<=48E graph)")
    if family == "mutag":
        # MUTAG-like (README.md:107-108): pattern labels are a SUBSET of
        # the graph vocab (2/2 of 7/4); random label agreement is rare so
        # matches are planted, but the tiny pattern (<=3 edges) on a
        # 28V/66E graph leaves weights denser than Complex.
        return dict(
            caps=dict(p_v_max=4, p_e_max=3, g_v_max=28, g_e_max=66),
            nvl=7, nel=4, p_nvl=2, p_nel=2, count_cap=96, bsz=32,
            sample=lambda rng: (lambda pv: dict(
                pv=pv, pe=3, gv=28, ge=int(rng.integers(50, 67)),
                plant=int(rng.integers(1, 4))))(int(rng.integers(3, 5))),
            envelope="MUTAG+rev (<=4V/3E 2/2-label pattern, "
                     "28V/<=66E 7/4-label graph)")
    raise ValueError(f"unknown family {family!r} "
                     "(choose complex | er | mutag)")


def _family_model_config(spec: dict, hid: int):
    """ModelConfig for a family envelope with reversed-edge augmentation
    (train.py:1150-1158 doubles E and edge labels). Flagship Complex
    matches __graft_entry__._flagship_config exactly."""
    from dualmessagepassing_tpu import ModelConfig

    caps = spec["caps"]
    return ModelConfig(
        max_ngv=caps["g_v_max"], max_ngvl=spec["nvl"],
        max_nge=caps["g_e_max"] * 2, max_ngel=spec["nel"] * 2,
        max_npv=caps["p_v_max"], max_npvl=spec["p_nvl"],
        max_npe=caps["p_e_max"] * 2, max_npel=spec["p_nel"] * 2,
        hid_dim=hid, rep_num_pattern_layers=3, rep_num_graph_layers=3,
        pred_hid_dim=hid, filter_net="ScalarFilter",
        pred_return_weights="nodeedge")


def run(pairs: int, max_epochs: int, early_stop: int, bsz: int, lr: float,
        amp: bool, seed: int, probe_steps: int = 600, hid: int = 64,
        family: str = "complex", log=print) -> dict:
    import jax

    from dualmessagepassing_tpu import build_model
    from dualmessagepassing_tpu.data.dataset import GraphAdjDataset
    from dualmessagepassing_tpu.data.synthetic import generate_pair
    from dualmessagepassing_tpu.train import (
        BucketSampler, TrainState, evaluate_epoch, make_eval_step,
        make_optimizer, make_train_step, train_epoch)

    spec = _family_spec(family)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    def one_pair(i):
        # reject-resample the count tail: a planted pattern with many
        # automorphisms (or an unlabeled near-clique) can blow up to
        # hundreds of matches, and a handful of such outliers dominates
        # the MSE objective (the published sets' generators control
        # their count distributions too)
        while True:
            rec = generate_pair(rng, num_vlabels=spec["nvl"],
                                num_elabels=spec["nel"],
                                p_num_vlabels=spec["p_nvl"],
                                p_num_elabels=spec["p_nel"],
                                pair_id=f"P{i}-G{i}",
                                **spec["caps"], **spec["sample"](rng))
            if rec["counts"] <= spec["count_cap"]:
                return rec

    data = [one_pair(i) for i in range(pairs)]
    n_dev = max(pairs // 6, 8)
    train_ds = GraphAdjDataset(data[: pairs - 2 * n_dev])
    dev_ds = GraphAdjDataset(data[pairs - 2 * n_dev: pairs - n_dev])
    test_ds = GraphAdjDataset(data[pairs - n_dev:])
    for ds in (train_ds, dev_ds, test_ds):
        ds.add_reversed_edges(spec["p_nel"], spec["nel"])  # train.py:1150-1158
    counts = [d["counts"] for d in data]
    log(f"dataset[{family}]: {pairs} pairs in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"counts mean {np.mean(counts):.2f} max {max(counts)} "
        f"zero-frac {np.mean(np.asarray(counts) == 0):.2f}")

    cfg = _family_model_config(spec, hid)
    model = build_model(cfg)

    # Trivial-predictor baselines (round-4 honesty fix): the gold
    # occurrence weights are SPARSE (median 0 — ~16% of nodes / ~3% of
    # edges nonzero on this envelope), so an all-zeros predictor scores
    # MNED/MEED equal to the mean gold mass. Any claim that matching
    # GENERALIZES must beat these numbers on dev, not merely improve on
    # a mid-training transient (round 4 measured dev-MNED 91.7 -> 55.7
    # "improvement" against a zero-predictor floor of 51.6 — the
    # transient, not the learning, was the 91.7).
    def zero_baseline(ds, sampler):
        neds, eeds, absc = [], [], []
        for bidx in sampler:
            _, _, graph, counts, (nw, ew) = ds.batchify(bidx, "nodeedge")
            nw_r = np.asarray(model.refine_node_weights(
                np.asarray(nw)[..., None]))[..., 0]
            ew_r = np.asarray(model.refine_edge_weights(
                np.asarray(ew)[..., None]))[..., 0]
            gvm = np.asarray(graph.node_mask)
            gem = np.asarray(graph.edge_mask) & ~np.asarray(graph.rev_flag)
            neds.append(np.abs(nw_r * gvm).sum(axis=1))
            eeds.append(np.abs(ew_r * gem).sum(axis=1))
            absc.append(np.abs(np.asarray(counts)[:, 0]))
        return {"MNED": round(float(np.concatenate(neds).mean()), 6),
                "MEED": round(float(np.concatenate(eeds).mean()), 6),
                "MAE": round(float(np.concatenate(absc).mean()), 6)}
    _, pattern, graph, _, _ = train_ds.batchify(range(min(bsz, 8)), "none")
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), pattern, graph)
    tx = make_optimizer(lr=lr)   # AdamW amsgrad wd 1e-5 clip 8.0
    state = TrainState.create(params, tx)
    step = make_train_step(model, tx, bp_loss="MSE",
                           return_weights="nodeedge", amp=amp)
    n_train = pairs - 2 * n_dev
    steps_per_epoch = max(n_train // bsz, 1)
    # reference warmup/cycle formulas (train.py:1246-1254, pinned by
    # tests/test_schedules.py)
    warmup = int(steps_per_epoch * 0.5 * min(0.06 * max_epochs, early_stop))
    config = {
        "train_epochs": max_epochs, "lr": lr,
        "neg_pred_slp": "anneal_cosine$1.0$0.01",   # config.py:145-146
        # reference matching recipe (config.py:495-506): full-weight match
        # loss + cosine-annealed match regularizer. Round 3 ran 0.1/0.0 and
        # the matching metrics never moved (VERDICT r3 missing-item 1); the
        # planted overfit probe shows the head learns fine once weighted.
        "match_loss_w": 1.0, "match_reg_w": "anneal_cosine$0.01$0.0",
        "rep_reg_w": 1e-5,
        "scheduler": "cosine_with_warmup_and_restart",
        "num_warmup_steps": warmup,
        "num_schedule_steps": max_epochs * steps_per_epoch,
        "num_cycles": max(max_epochs * steps_per_epoch // 20000, 1),
        "pred_return_weights": "nodeedge", "bp_loss": "MSE",
    }
    eval_step = make_eval_step(model)
    dev_sampler = BucketSampler(dev_ds.sizes(), ["g_len", "p_len"],
                                batch_size=bsz, seed=0, shuffle=False)
    test_sampler = BucketSampler(test_ds.sizes(), ["g_len", "p_len"],
                                 batch_size=bsz, seed=0, shuffle=False)
    # train-fit eval split: same size as dev, drawn from SEEN pairs —
    # matching learning is provable here even when dev generalization
    # is data-bound (ARCHITECTURE §11)
    # (data[:n_dev] records were already rev-augmented IN PLACE through
    # train_ds above — GraphAdjDataset wraps the same dicts)
    fit_ds = GraphAdjDataset(data[:n_dev])
    fit_sampler = BucketSampler(fit_ds.sizes(), ["g_len", "p_len"],
                                batch_size=bsz, seed=0, shuffle=False)
    baselines = {"dev_zero": zero_baseline(dev_ds, dev_sampler),
                 "train_zero": zero_baseline(fit_ds, fit_sampler)}
    log(f"zero-predictor baselines: {json.dumps(baselines)}")

    # TRUE pre-training eval (epoch -1): the matching_learned gate
    # anchors its improvement ratio here. Anchoring at the end of epoch
    # 0 proved platform-fragile — on the accelerator the matching head
    # converges
    # WITHIN the first epoch (dev MNED 53.7 after epoch 0 vs 91.7 on
    # CPU; same recipe/seed), so a ratio against epoch-0 reads ~1.0
    # even though the trained end state matches the CPU run exactly.
    dev0 = evaluate_epoch(state.variables(), eval_step, dev_ds,
                          dev_sampler, return_weights="nodeedge",
                          model=model)
    pre_row = {"epoch": -1, "train_loss": None,
               "dev_MAE": round(dev0["MAE"], 6),
               "dev_MSE": round(dev0["MSE"], 6),
               "dev_RMSE": round(dev0["RMSE"], 6),
               "dev_AUC": round(dev0["AUC"], 6),
               "dev_MNED": round(dev0["MNED"], 6),
               "dev_MEED": round(dev0["MEED"], 6), "epoch_s": 0.0}
    log(json.dumps(pre_row))

    trajectory = [pre_row]
    best_dev = float("inf")
    best_loss = float("inf")
    stale_dev = stale_loss = 0
    rng_key = jax.random.PRNGKey(seed + 1)
    stopped_at = max_epochs - 1
    for epoch in range(max_epochs):
        sampler = BucketSampler(train_ds.sizes(), ["g_len", "p_len"],
                                batch_size=bsz, seed=epoch)
        sampler.set_epoch(epoch)
        rng_key, ep_key = jax.random.split(rng_key)
        t0 = time.perf_counter()
        state, totals = train_epoch(state, step, train_ds, sampler,
                                    config, epoch, ep_key)
        dev = evaluate_epoch(state.variables(), eval_step, dev_ds,
                             dev_sampler, return_weights="nodeedge",
                             model=model)
        row = {"epoch": epoch,
               "train_loss": round(float(totals["total"]), 6),
               "dev_MAE": round(dev["MAE"], 6),
               "dev_MSE": round(dev["MSE"], 6),
               "dev_RMSE": round(dev["RMSE"], 6),
               "dev_AUC": round(dev["AUC"], 6),
               "dev_MNED": round(dev["MNED"], 6),
               "dev_MEED": round(dev["MEED"], 6),
               "epoch_s": round(time.perf_counter() - t0, 1)}
        trajectory.append(row)
        log(json.dumps(row))
        # early stop when BOTH train loss and dev metric are stale
        # (train.py:1368-1372)
        stale_loss = 0 if totals["total"] < best_loss else stale_loss + 1
        best_loss = min(best_loss, float(totals["total"]))
        stale_dev = 0 if dev["MAE"] < best_dev else stale_dev + 1
        best_dev = min(best_dev, float(dev["MAE"]))
        if stale_loss > early_stop and stale_dev > early_stop:
            stopped_at = epoch
            break

    test = evaluate_epoch(state.variables(), eval_step, test_ds,
                          test_sampler, return_weights="nodeedge",
                          model=model)
    fit = evaluate_epoch(state.variables(), eval_step, fit_ds,
                         fit_sampler, return_weights="nodeedge",
                         model=model)
    train_fit = {k: round(fit[k], 6) for k in ("MAE", "MNED", "MEED")}

    # --- matching-machinery overfit probe (ARCHITECTURE §11): a FRESH
    # model fit to `probe_pairs` seen pairs until it reproduces their
    # gold occurrence weights. This is the gate that proves head, match
    # losses, refine hooks, and VJPs end-to-end; it is data-scale
    # independent, unlike train_fit above — at the flagship 4096-pair
    # recipe the model does not memorize its train split (train-fit
    # MNED ~= the zero floor) even though counting generalizes, so a
    # train-fit-based gate measured regime, not machinery (measured on
    # the accelerator and the CPU alike).
    probe_pairs = min(16, n_train)
    probe_ds = GraphAdjDataset(data[:probe_pairs])   # rev-aug'd in place
    probe_sampler = BucketSampler(probe_ds.sizes(), ["g_len", "p_len"],
                                  batch_size=probe_pairs, seed=0,
                                  shuffle=False)
    probe_zero = zero_baseline(probe_ds, probe_sampler)
    _, p_pat, p_graph, p_counts, (p_nw, p_ew) = probe_ds.batchify(
        range(probe_pairs), "nodeedge")
    p_params = jax.jit(model.init)(jax.random.PRNGKey(seed + 101),
                                   p_pat, p_graph)
    p_state = TrainState.create(p_params, tx)
    import jax.numpy as jnp
    p_key = jax.random.PRNGKey(seed + 102)
    t0 = time.perf_counter()
    for i in range(probe_steps):
        p_key, d_key = jax.random.split(p_key)
        p_state, p_losses = step(
            p_state, p_pat, p_graph, p_counts, p_nw, p_ew,
            jnp.float32(0.01), jnp.float32(1.0), jnp.float32(0.0),
            jnp.float32(0.0), jnp.float32(1.0), d_key)
        if i % 8 == 7:   # bound the un-synced dispatch chain
            jax.block_until_ready(p_losses["total"])
    jax.block_until_ready(p_state.params)
    p_fit = evaluate_epoch(p_state.variables(), eval_step, probe_ds,
                           probe_sampler, return_weights="nodeedge",
                           model=model)
    probe = {"pairs": probe_pairs, "steps": probe_steps,
             "zero": probe_zero,
             "MNED": round(p_fit["MNED"], 6),
             "MEED": round(p_fit["MEED"], 6),
             "MNED_vs_zero": round(
                 p_fit["MNED"] / max(probe_zero["MNED"], 1e-9), 6),
             "MEED_vs_zero": round(
                 p_fit["MEED"] / max(probe_zero["MEED"], 1e-9), 6),
             "probe_s": round(time.perf_counter() - t0, 1)}
    log(f"overfit probe: {json.dumps(probe)}")
    return {
        "metric": "scm_convergence_dev_MAE",
        "value": round(best_dev, 6),
        "unit": "MAE",
        "config": {"pairs": pairs, "bsz": bsz, "lr": lr, "amp": amp,
                   "seed": seed, "max_epochs": max_epochs,
                   "early_stop": early_stop, "hid": hid, "family": family,
                   "envelope": spec["envelope"]},
        "platform": jax.devices()[0].platform,
        "stopped_at_epoch": stopped_at,
        "final": {"dev_MAE": trajectory[-1]["dev_MAE"],
                  "dev_MSE": trajectory[-1]["dev_MSE"],
                  "dev_RMSE": trajectory[-1]["dev_RMSE"],
                  "dev_AUC": trajectory[-1]["dev_AUC"],
                  "dev_MNED": trajectory[-1]["dev_MNED"],
                  "dev_MEED": trajectory[-1]["dev_MEED"],
                  "test_MAE": round(test["MAE"], 6),
                  "test_MSE": round(test["MSE"], 6),
                  "test_RMSE": round(test["RMSE"], 6),
                  "test_AUC": round(test["AUC"], 6),
                  "test_MNED": round(test["MNED"], 6),
                  "test_MEED": round(test["MEED"], 6)},
        "best_dev_MAE": round(best_dev, 6),
        "baselines": baselines,
        "train_fit": train_fit,
        "overfit_probe": probe,
        "matching_learned": matching_learned(trajectory, baselines,
                                             train_fit, probe),
        "trajectory": trajectory,
    }


def matching_learned(trajectory, baselines=None, train_fit=None,
                     probe=None) -> dict:
    """Did the matching task learn? Round-4 semantics (honesty fix):

    The meaningful yardstick is the ZERO-PREDICTOR (gold weights are
    sparse — an all-zeros prediction scores MNED/MEED = mean gold mass),
    not the epoch-0 eval: the first-epoch transient over-predicts, so a
    "falls 91.7 -> 55.7" trajectory can sit entirely ABOVE the 51.6
    zero floor. Gate:
      * head_learns — a FRESH model overfit to `probe` seen pairs beats
        the zero predictor on them by 2x (the matching machinery —
        head, losses, refine hooks, VJPs — demonstrably learns).
        Probe-based, because at the flagship data scale the full run's
        own train split does NOT memorize (train-fit MNED ~= the zero
        floor on both CPU and accelerator) — a train-fit gate measures the
        training regime, not the machinery;
      * train/dev ratios vs their zero floors are RECORDED as regime
        evidence (dev crossing below 1.0 means real held-out matching
        skill; data-scale dependent — §11).
    Falls back to the old epoch-anchored ratios when called on a legacy
    artifact without baselines."""
    import numpy as _np

    rows = [r for r in trajectory if r["epoch"] >= 0]
    base = trajectory[0]   # epoch -1 pre-training row when present
    q = max(len(rows) // 4, 1)
    out = {}
    for k in ("dev_MNED", "dev_MEED"):
        tail = float(_np.mean([r[k] for r in rows[-q:]]))
        out[k + "_vs_untrained"] = round(tail / max(base[k], 1e-9), 6)
        if baselines is not None:
            zk = baselines["dev_zero"][k[4:]]   # dev_MNED -> MNED
            out[k + "_vs_zero"] = round(tail / max(zk, 1e-9), 6)
    if baselines is None or train_fit is None:
        out["ok"] = bool(out["dev_MNED_vs_untrained"] < 0.7
                         and out["dev_MEED_vs_untrained"] < 0.7)
        return out
    tz = baselines["train_zero"]
    out["train_MNED_vs_zero"] = round(
        train_fit["MNED"] / max(tz["MNED"], 1e-9), 6)
    out["train_MEED_vs_zero"] = round(
        train_fit["MEED"] / max(tz["MEED"], 1e-9), 6)
    if probe is not None:
        out["head_learns"] = bool(probe["MNED_vs_zero"] < 0.5
                                  and probe["MEED_vs_zero"] < 0.5)
    else:   # legacy artifact recorded before the probe existed
        out["head_learns"] = bool(out["train_MNED_vs_zero"] < 0.9
                                  and out["train_MEED_vs_zero"] < 0.9)
    out["dev_beats_zero"] = bool(out["dev_MNED_vs_zero"] < 1.0
                                 and out["dev_MEED_vs_zero"] < 1.0)
    out["ok"] = out["head_learns"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="complex",
                    choices=["complex", "er", "mutag"],
                    help="reference dataset family envelope (README.md:24-117)")
    ap.add_argument("--pairs", type=int, default=768)
    ap.add_argument("--max-epochs", type=int, default=60)
    ap.add_argument("--early-stop", type=int, default=5)
    ap.add_argument("--bsz", type=int, default=None,
                    help="default: the family's published batch size")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--amp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--probe-steps", type=int, default=600,
                    help="overfit-probe length (the machinery gate)")
    ap.add_argument("--hid", type=int, default=64,
                    help="hid_dim/pred_hid_dim override (capacity axis)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", default=None,
                    help="gate final metrics against this stored JSON")
    args = ap.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    bsz = args.bsz or _family_spec(args.family)["bsz"]
    result = run(args.pairs, args.max_epochs, args.early_stop, bsz,
                 args.lr, bool(args.amp), args.seed,
                 probe_steps=args.probe_steps, hid=args.hid,
                 family=args.family)
    print(json.dumps({k: v for k, v in result.items() if k != "trajectory"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.check:
        with open(args.check) as f:
            ref = json.load(f)["final"]
        bad = []
        import math

        for k, v in ref.items():
            got = result["final"][k]
            if math.isnan(got) != math.isnan(v):
                # NaN AUC means the split lost a count class (reduced
                # --pairs reruns): abs(nan - v) compares False and would
                # silently pass — flag the definedness change explicitly
                bad.append(f"{k}: expected {v}, got {got} (NaN mismatch)")
            elif math.isnan(got):
                continue
            elif k.endswith("AUC"):
                # AUC lives in [0,1]: absolute tolerance
                if abs(got - v) > 0.05:
                    bad.append(f"{k}: expected {v}, got {got}")
            elif abs(got - v) > 0.15 * max(abs(v), 1e-6):
                bad.append(f"{k}: expected {v}, got {got}")
        if not result["matching_learned"]["ok"]:
            bad.append(f"matching did not learn: {result['matching_learned']}")
        with open(args.check) as f:
            ref_ml = json.load(f).get("matching_learned", {})
        if ref_ml.get("dev_beats_zero") and not (
                result["matching_learned"].get("dev_beats_zero")):
            # the pinned artifact proved HELD-OUT matching skill (dense-
            # gold envelopes, e.g. ER — round 5); a rerun losing it is a
            # capability regression, not jitter
            bad.append("dev_beats_zero regressed: pinned artifact beat the "
                       f"zero predictor, rerun did not "
                       f"({result['matching_learned']})")
        if bad:
            print("CONVERGENCE GATE FAILED: " + "; ".join(bad))
            sys.exit(1)
        print("convergence gate OK")
    return result


if __name__ == "__main__":
    main()
