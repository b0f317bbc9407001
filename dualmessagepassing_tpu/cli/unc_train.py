"""UNC training CLI — the reference Model/*/src/main.py argparse surface
(main.py:221-304) over the unc/ drivers.

python -m dualmessagepassing_tpu.cli.unc_train \
    --link data/link.dat --output emb.dat --model DMPNN \
    --n_hidden 50 --n_layers 2 --sampler randomwalk
"""

from __future__ import annotations

import argparse
import os
import time


def get_args(argv=None):
    p = argparse.ArgumentParser("unc-train")
    p.add_argument("--link", type=str, required=True)
    p.add_argument("--node", type=str, default="")
    p.add_argument("--label", type=str, default="")
    p.add_argument("--output", type=str, default="emb.dat")
    p.add_argument("--model", type=str, default="DMPNN",
                   choices=["DMPNN", "CompGCN", "RGCN", "RGIN"])
    p.add_argument("--supervised", type=str, default="False")
    p.add_argument("--attributed", type=str, default="False")
    p.add_argument("--n_hidden", "--n-hidden", type=int, default=50)
    p.add_argument("--n_layers", "--n-layers", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--regularization", type=float, default=1e-2)
    p.add_argument("--negative_sample", "--negative-sample", type=int, default=5)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--graph_batch_size", "--graph-batch-size", type=int, default=10000)
    p.add_argument("--label_batch_size", "--label-batch-size", type=int, default=512)
    p.add_argument("--graph_split_size", "--graph-split-size", type=float, default=0.5)
    p.add_argument("--sampler", type=str, default="randomwalk",
                   choices=["randomwalk", "neighbor"])
    p.add_argument("--sample_depth", "--sample-depth", type=int, default=3)
    p.add_argument("--sample_width", "--sample-width", type=int, default=10)
    p.add_argument("--n_epochs", "--n-epochs", type=int, default=50)
    p.add_argument("--grad_norm", "--grad-norm", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gpu", type=int, default=-1,
                   help="accepted for reference compatibility; unused")
    p.add_argument("--ep_devices", type=int, default=0,
                   help="edge-partition the model over the first N devices "
                        "(0 = single-device); unsupervised mode only")
    p.add_argument("--ep_mode", type=str, default="psum",
                   choices=["psum", "halo"],
                   help="node-state placement under --ep_devices: 'psum' "
                        "replicates nodes (per-layer [V,H] all-reduce); "
                        "'halo' owner-shards them (boundary all_to_all)")
    p.add_argument("--ep_partition", type=str, default="degree",
                   choices=["degree", "range", "bfs"],
                   help="halo node partitioner (ep_mode=halo): 'bfs' is "
                        "the locality-aware region grower")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="save full training state (params/opt/BN/clocks) "
                        "per epoch and resume from it when present")
    p.add_argument("--amp", type=str, default="False",
                   help="bf16 backbone forward/backward with f32 master "
                        "params and f32 loss (utils/amp)")
    # single-device endpoint-gather layout (exact-equivalence tested)
    p.add_argument("--endpoint_gather", type=str, default="split",
                   choices=["split", "fused"],
                   help="'fused': one gather over the concatenated [2E] "
                        "endpoint stream (one cotangent scatter per "
                        "layer instead of two); single-device only")
    return p.parse_args(argv)


def main(argv=None):
    import numpy as np

    from ..unc import (load_label, load_supervised, load_unsupervised,
                       save_embeddings, train_unc)
    from ..unc.driver import train_unc_supervised
    from ..utils.compile_cache import enable_compile_cache

    args = get_args(argv)
    enable_compile_cache()

    def log(msg):
        print(time.strftime("%a, %d %b %Y %H:%M:%S +0000: ") + msg,
              flush=True)

    log("start loading...")
    attributed = args.attributed == "True"
    supervised = args.supervised == "True"

    seed_nodes = set()
    seed_path = (args.node.replace("node.dat", "seed_node.dat")
                 if args.node else
                 os.path.join(os.path.dirname(args.link), "seed_node.dat"))
    if os.path.exists(seed_path):
        seed_nodes = set(int(l) for l in open(seed_path))

    if supervised:
        train_pool, train_labels, nlabels, multi = load_label(args.label)
        triplets, n, r, train_indices, ntrain, attrs = load_supervised(
            args.link, args.node, train_pool, attributed)
        log("finish loading...")
        variables, model = train_unc_supervised(
            triplets, n, r, train_indices, train_labels, nlabels,
            multi=multi, h_dim=args.n_hidden, n_layers=args.n_layers,
            lr=args.lr, reg_param=args.regularization,
            dropout=args.dropout, graph_batch_size=args.graph_batch_size,
            label_batch_size=args.label_batch_size,
            graph_split_size=args.graph_split_size, sampler=args.sampler,
            sample_depth=args.sample_depth, sample_width=args.sample_width,
            n_epochs=args.n_epochs, grad_norm=args.grad_norm,
            backbone=args.model, node_attri=attrs, seed=args.seed,
            amp=args.amp.lower() in ("true", "1"), log=log)
        embs = np.asarray(variables["params"]["model"]["node_emb"])
    else:
        triplets, n, r, attrs = load_unsupervised(
            args.link, args.node, attributed)
        log("finish loading...")
        embs, coverage = train_unc(
            triplets, n, r, h_dim=args.n_hidden, n_layers=args.n_layers,
            lr=args.lr, reg_param=args.regularization,
            negative_rate=args.negative_sample, dropout=args.dropout,
            graph_batch_size=args.graph_batch_size,
            graph_split_size=args.graph_split_size, sampler=args.sampler,
            sample_depth=args.sample_depth, sample_width=args.sample_width,
            n_epochs=args.n_epochs, grad_norm=args.grad_norm,
            backbone=args.model, seed_nodes=seed_nodes or None,
            node_attri=attrs, seed=args.seed,
            ep_devices=args.ep_devices or None, ep_mode=args.ep_mode,
            ep_partition=args.ep_partition,
            checkpoint_dir=args.checkpoint_dir or None,
            amp=args.amp.lower() in ("true", "1"),
            endpoint_gather=args.endpoint_gather,
            log=log)

    log("start output...")
    header = str(vars(args))
    if seed_nodes:
        idx = np.asarray(sorted(seed_nodes))
        save_embeddings(args.output, header, embs[idx], index=idx)
    else:
        save_embeddings(args.output, header, embs)
    log("done")


if __name__ == "__main__":
    main()
