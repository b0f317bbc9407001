"""SCM training CLI — the reference train.py main loop (train.py:1064-1398).

python -m dualmessagepassing_tpu.cli.scm_train --synthetic True ...
python -m dualmessagepassing_tpu.cli.scm_train --pattern_dir ... \
    --graph_dir ... --metadata_dir ... --rep_net DMPNN --match_weights node,edge

Loop structure mirrors the reference: per-epoch curriculum training split,
bucketed dev/test evaluation, results JSONs, best-epoch checkpoints, early
stop when both the train loss and the dev metric stall.
"""

from __future__ import annotations

import datetime
import math
import os
import sys
from typing import Dict

import numpy as np


def build_datasets(config, logger):
    import os as _os

    from ..data.dataset import GraphAdjDataset
    from ..data.synthetic import generate_dataset
    from ..graph import single_graph
    from ..utils.io import load_data

    # preprocessed-dataset cache (reference train.py:114-134: .pt reload)
    cache_dir = config.get("save_data_dir")
    if cache_dir and all(
            _os.path.exists(_os.path.join(cache_dir, f"{k}_dataset.pkl"))
            for k in ("train", "dev", "test")):
        logger.info(f"loading cached datasets from {cache_dir}")
        datasets = {
            k: GraphAdjDataset().load(
                _os.path.join(cache_dir, f"{k}_dataset.pkl"))
            for k in ("train", "dev", "test")
        }
        from ..data.dataset import CollateView, collate_kind_for
        kind = collate_kind_for(config["rep_net"])
        datasets = {
            k: CollateView(v, kind, config.get("lrp_seq_len", 4),
                           auto_envelope=config.get("auto_envelope", False))
            for k, v in datasets.items()
        }
        for k, v in datasets.items():
            logger.info("%8d %s data loaded (cache)" % (len(v), k))
        return datasets

    if config["synthetic"]:
        logger.info("generating synthetic Erdos-Renyi datasets")
        n = config["synthetic_pairs"]
        kw = dict(
            pv=config["max_npv"], pe=min(config["max_npe"], 2 * config["max_npv"]),
            gv=config["max_ngv"], ge=config["max_nge"],
            num_vlabels=config["max_ngvl"], num_elabels=config["max_ngel"],
            p_v_max=config["max_npv"], p_e_max=config["max_npe"],
            g_v_max=config["max_ngv"], g_e_max=config["max_nge"],
        )
        datasets = {
            "train": GraphAdjDataset(generate_dataset(n, seed=config["seed"], **kw)),
            "dev": GraphAdjDataset(
                generate_dataset(max(n // 8, 1), seed=config["seed"] + 1, **kw)),
            "test": GraphAdjDataset(
                generate_dataset(max(n // 8, 1), seed=config["seed"] + 2, **kw)),
        }
    else:
        logger.info("loading datasets from %s / %s / %s" % (
            config["pattern_dir"], config["graph_dir"], config["metadata_dir"]))
        splits, _shared = load_data(config["pattern_dir"], config["graph_dir"],
                                    config["metadata_dir"])

        def to_record(x):
            p, g = x["pattern"], x["graph"]
            return {
                "id": x["id"],
                "pattern": single_graph(
                    p["num_nodes"], p["senders"], p["receivers"],
                    p["node_labels"], p["edge_labels"],
                    v_max=config["max_npv"], e_max=config["max_npe"]),
                "graph": single_graph(
                    g["num_nodes"], g["senders"], g["receivers"],
                    g["node_labels"], g["edge_labels"],
                    v_max=config["max_ngv"], e_max=config["max_nge"]),
                "counts": x["counts"],
                "subisomorphisms": x["subisomorphisms"],
                "node_weights": None, "edge_weights": None,
            }

        datasets = {k: GraphAdjDataset([to_record(x) for x in v])
                    for k, v in splits.items()}
    if cache_dir:
        _os.makedirs(cache_dir, exist_ok=True)
        for k, v in datasets.items():
            v.save(_os.path.join(cache_dir, f"{k}_dataset.pkl"))
        logger.info(f"datasets cached to {cache_dir}")
    from ..data.dataset import CollateView, collate_kind_for
    kind = collate_kind_for(config["rep_net"])
    datasets = {
        k: CollateView(v, kind, config.get("lrp_seq_len", 4),
                       auto_envelope=config.get("auto_envelope", False))
        for k, v in datasets.items()
    }
    for k, v in datasets.items():
        logger.info("%8d %s data loaded" % (len(v), k))
    return datasets


def main(argv=None):
    import jax
    import jax.numpy as jnp

    from .config import get_train_config, process_model_config, to_model_config
    from ..models.scm_models import build_model
    from ..train import (BucketSampler, CurriculumSampler, TrainState,
                         evaluate_epoch, make_eval_step, make_optimizer,
                         make_train_step, train_epoch)
    from ..train.checkpoint import save_state
    from ..utils.compile_cache import enable_compile_cache
    from ..utils.io import save_config, save_results
    from ..utils.log import generate_best_line, init_logger

    config = get_train_config(argv)
    enable_compile_cache()
    ts = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    save_dir = os.path.join(
        config["save_model_dir"],
        "%s_%s_%s" % (config["rep_net"], config["pred_net"], ts))
    os.makedirs(save_dir, exist_ok=True)
    logger = init_logger(os.path.join(save_dir, "log.txt"),
                         log_tag=config["rep_net"])
    save_config(config, os.path.join(save_dir, "config.json"))
    # TensorBoard scalars (reference train.py:18,688-724,1018-1025)
    try:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(os.path.join(save_dir, "tb"))
    except ImportError:
        writer = None

    datasets = build_datasets(config, logger)

    # loop removal / reversed edges / eigenvalue bounds (train.py:1111-1186)
    if config.get("remove_loops"):
        for ds in datasets.values():
            ds.dataset.remove_loops()
    if config["add_rev"]:
        for ds in datasets.values():
            ds.dataset.add_reversed_edges(config["max_npel"],
                                          config["max_ngel"])
    if config["convert_dual"]:
        from ..data.dual import convert_dataset_to_dual
        for ds in datasets.values():
            convert_dataset_to_dual(ds.dataset)
    neigenv, eeigenv = datasets["train"].dataset.compute_eigenvalue_bounds()
    logger.info(f"eigenvalue bounds: node {neigenv:.2f} edge {eeigenv:.2f}")

    model_cfg = to_model_config(process_model_config(config)).replace(
        init_neigenv=neigenv, init_eeigenv=eeigenv)
    model = build_model(model_cfg)

    ids, pattern, graph, counts, _ = datasets["train"].batchify(
        range(min(2, len(datasets["train"]))), "none")
    # jitted init: an eager init dispatches every op separately
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(config["seed"]), pattern, graph)
    n_params = sum(x.size for x in jax.tree.leaves(variables))
    logger.info(f"model built: {n_params} parameters")

    # finetune: restore a previous run's best checkpoint and expand it onto
    # this (possibly larger-vocab) model (train.py:90-111,1209-1223 +
    # basemodel.py:167-219)
    if config.get("load_model_dir"):
        from ..train.checkpoint import expand_params, restore_state
        from ..utils.io import load_config as _load_cfg
        from ..utils.log import get_best_epochs
        src = config["load_model_dir"]
        src_cfg = _load_cfg(os.path.join(src, "config.json"))
        best = get_best_epochs(os.path.join(src, "log.txt"))
        src_epoch = best["eval-" + src_cfg["eval_metric"]]["dev"][0]
        logger.info(f"finetuning from {src} epoch {src_epoch}")
        src_state = restore_state(os.path.join(src, f"epoch{src_epoch}"))
        variables = {
            "params": expand_params(src_state.params, variables["params"],
                                    pre_pad=True),
            **({"batch_stats": variables["batch_stats"]}
               if "batch_stats" in variables else {}),
        }

    tx = make_optimizer(config["lr"], config["weight_decay"],
                        config["max_grad_norm"])
    # gradient accumulation (reference train_grad_steps, train.py:679-684)
    if config.get("train_grad_steps", 1) > 1:
        import optax
        tx = optax.MultiSteps(tx, config["train_grad_steps"])
    state = TrainState.create(variables, tx)
    # derived warmup/cycles for the LR schedule (reference train.py:1231-1254)
    from ..train.schedules import derive_schedule_config
    config.update(derive_schedule_config(len(datasets["train"]), config))
    logger.info("schedule: warmup %d steps, horizon %d, cycles %.3f,"
                " min_percent %g" % (
                    config["num_warmup_steps"], config["num_schedule_steps"],
                    config["num_cycles"], config["min_percent"]))
    # data parallelism over the pair batch (--dp_devices N): batch leaves
    # sharded on a 'dp' mesh axis, state replicated, grad psum by GSPMD
    mesh = None
    if config.get("dp_devices", 1) > 1:
        from ..parallel.dp import make_dp_mesh
        from ..train.scm_driver import dp_replicate_state
        n_avail = len(jax.devices())
        if config["dp_devices"] > n_avail:
            raise ValueError(
                f"--dp_devices {config['dp_devices']} but only {n_avail} "
                f"devices are visible")
        if config["train_batch_size"] % config["dp_devices"]:
            # misdivision silently degrades EVERY batch to the replicated
            # fallback (N-times redundant compute) — refuse loudly
            raise ValueError(
                f"--train_batch_size {config['train_batch_size']} must be "
                f"divisible by --dp_devices {config['dp_devices']}")
        mesh = make_dp_mesh(config["dp_devices"])
        state = dp_replicate_state(mesh, state)
        logger.info(f"data parallel: {config['dp_devices']} devices on 'dp'")
    train_step = make_train_step(model, tx, config["bp_loss"],
                                 config["match_weights"],
                                 eval_metric=config["eval_metric"],
                                 amp=config.get("amp", False),
                                 accum_chunks=(config.get(
                                     "train_microbatch_chunks", 0) or None),
                                 mesh=mesh)
    eval_step = make_eval_step(model)

    sizes = {k: v.sizes() for k, v in datasets.items()}
    warmup = config["curriculum_warmup_epochs"]
    if warmup < 0:
        warmup = max(1, int(0.2 * config["train_epochs"]))

    metric = config["eval_metric"]
    higher_better = metric == "AUC"
    best_dev = -float("inf") if higher_better else float("inf")
    best_train_loss = float("inf")
    stale_loss = stale_metric = 0
    rng = jax.random.PRNGKey(config["seed"])
    import numpy as _np
    for epoch in range(config["train_epochs"]):
        used_ratio = min(1.0, 0.5 + 0.5 * epoch / max(warmup, 1))
        # per-epoch train_ratio subsetting (train.py:1266-1290)
        train_sizes = sizes["train"]
        subset = None
        if config.get("train_ratio", 1.0) < 1.0:
            sub_rng = _np.random.default_rng(config["seed"] + epoch)
            n_keep = max(1, int(len(train_sizes) * config["train_ratio"]))
            subset = sub_rng.permutation(len(train_sizes))[:n_keep]
            train_sizes = [train_sizes[i] for i in subset]
        sampler = CurriculumSampler(
            train_sizes, ["p_len", "g_len"], used_ratio,
            config["train_batch_size"], group_by=["g_len", "p_len"],
            shuffle=True, seed=config["seed"])
        sampler.set_epoch(epoch)
        if subset is not None:
            _sub = subset
            sampler = type("S", (), {
                "__iter__": (lambda self, s=sampler, m=_sub:
                             iter(m[b] for b in s)),
                "__len__": lambda self, s=sampler: len(s),
                "full_len": property(lambda self, s=sampler: s.full_len),
            })()
        from ..utils.profiling import trace
        with trace(config.get("profile_dir") if epoch == 0 else None):
            state, totals = train_epoch(
                state, train_step, datasets["train"], sampler, config,
                epoch, rng, log_fn=logger.info, writer=writer)
        logger.info("train throughput: %.0f edges/s"
                    % totals.get("edges_per_sec", 0.0))
        logger.info("data_type: %-10s\tepoch: %05d/%05d\tloss: %.6f" % (
            "train", epoch, config["train_epochs"], totals["total"]))
        if writer:
            for k, v in totals.items():
                writer.add_scalar(f"train/{k}", v, epoch)

        results = {}
        for split in ("dev", "test"):
            ev = BucketSampler(sizes[split], ["g_len", "p_len"],
                               config["eval_batch_size"],
                               seed=config["seed"])
            res = evaluate_epoch(
                state.variables(), eval_step, datasets[split], ev,
                return_weights=config["match_weights"], model=model)
            results[split] = res
            logger.info("data_type: %-10s\tepoch: %05d/%05d\t%s" % (
                split, epoch, config["train_epochs"],
                "\t".join(f"{k}: {v:.6f}" for k, v in res.items()
                          if isinstance(v, float))))
            save_results(res, os.path.join(
                save_dir, f"{split}_results{epoch}.json"))
            if writer:
                for k, v in res.items():
                    if isinstance(v, float):
                        writer.add_scalar(f"{split}/{k}", v, epoch)

        dev_metric = results["dev"].get(metric, float("nan"))
        improved = (dev_metric > best_dev if higher_better
                    else dev_metric < best_dev)
        if improved:
            best_dev = dev_metric
            stale_metric = 0
            save_state(os.path.join(save_dir, f"epoch{epoch}"), state)
            for split in ("dev", "test"):
                logger.info(generate_best_line(
                    split, epoch, config["train_epochs"],
                    **{("eval-" + metric): results[split].get(metric)}))
        else:
            stale_metric += 1
        if totals["total"] < best_train_loss:
            best_train_loss = totals["total"]
            stale_loss = 0
        else:
            stale_loss += 1
        if (stale_loss > config["early_stop_rounds"]
                and stale_metric > config["early_stop_rounds"]):
            logger.info(f"early stop at epoch {epoch}")
            break
    if writer:
        writer.close()
    logger.info("training done; best dev %s: %.6f" % (metric, best_dev))
    return save_dir


if __name__ == "__main__":
    main()
