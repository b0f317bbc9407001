"""SCM evaluation CLI — reference evaluate.py (evaluate.py:44-245).

Loads config.json + the best epoch from log.txt, restores the checkpoint,
and runs evaluate_epoch over train/dev/test, writing eval result JSONs.

python -m dualmessagepassing_tpu.cli.scm_evaluate --load_model_dir <dir>
"""

from __future__ import annotations

import argparse
import datetime
import os


def build_parser():
    parser = argparse.ArgumentParser("scm-evaluate")
    parser.add_argument("--load_model_dir", type=str, required=True)
    # optional overrides: evaluate the trained model on a DIFFERENT dataset
    # (reference evaluate.py:44-77 takes the data dirs on its own command
    # line; the transfer setting — train small, evaluate large — needs them)
    parser.add_argument("--pattern_dir", type=str, default=None)
    parser.add_argument("--graph_dir", type=str, default=None)
    parser.add_argument("--metadata_dir", type=str, default=None)
    parser.add_argument("--save_data_dir", type=str, default=None)
    parser.add_argument("--eval_batch_size", type=int, default=None)
    return parser


def main(argv=None):
    import jax

    from .config import process_model_config, to_model_config
    from .scm_train import build_datasets
    from ..models.scm_models import build_model
    from ..train import (BucketSampler, TrainState, evaluate_epoch,
                         make_eval_step, make_optimizer)
    from ..train.checkpoint import restore_state
    from ..utils.compile_cache import enable_compile_cache
    from ..utils.io import load_config, save_results
    from ..utils.log import get_best_epochs, init_logger

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    path = args.load_model_dir

    config = load_config(os.path.join(path, "config.json"))
    for key in ("pattern_dir", "graph_dir", "metadata_dir",
                "save_data_dir", "eval_batch_size"):
        val = getattr(args, key)
        if val is not None:
            config[key] = val
    best = get_best_epochs(os.path.join(path, "log.txt"))
    metric = "eval-" + config["eval_metric"]
    epoch = best[metric]["dev"][0]

    logger = init_logger(os.path.join(path, "eval_log.txt"),
                         log_tag=config["rep_net"])
    logger.info(f"evaluating best dev epoch {epoch}")

    datasets = build_datasets(config, logger)
    if config["add_rev"]:
        for ds in datasets.values():
            ds.dataset.add_reversed_edges(config["max_npel"],
                                          config["max_ngel"])
    if config.get("convert_dual"):
        from ..data.dual import convert_dataset_to_dual
        for ds in datasets.values():
            convert_dataset_to_dual(ds.dataset)
    neigenv, eeigenv = datasets["train"].dataset.compute_eigenvalue_bounds()
    model_cfg = to_model_config(process_model_config(config)).replace(
        init_neigenv=neigenv, init_eeigenv=eeigenv)
    model = build_model(model_cfg)

    ids, pattern, graph, counts, _ = datasets["train"].batchify(
        range(min(2, len(datasets["train"]))), "none")
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(config["seed"]), pattern, graph)
    tx = make_optimizer(config["lr"], config["weight_decay"],
                        config["max_grad_norm"])
    like = TrainState.create(variables, tx)
    state = restore_state(os.path.join(path, f"epoch{epoch}"), like=like)

    eval_step = make_eval_step(model)
    ts = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    for split, ds in datasets.items():
        sampler = BucketSampler(ds.sizes(), ["g_len", "p_len"],
                                config["eval_batch_size"],
                                seed=config["seed"])
        res = evaluate_epoch(state.variables(), eval_step, ds, sampler,
                             return_weights=config["match_weights"],
                             model=model)
        logger.info("%s: %s" % (
            split, "  ".join(f"{k}: {v:.6f}" for k, v in res.items()
                             if isinstance(v, float))))
        save_results(res, os.path.join(
            path, f"eval_{split}_results_{ts}.json"))


if __name__ == "__main__":
    main()
