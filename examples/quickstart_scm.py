"""Minimal SCM quickstart: build a model, forward, one train step.

Run: python examples/quickstart_scm.py
"""

import os
import sys

# allow running directly from a repo checkout: examples/.. is the package root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from dualmessagepassing_tpu import (ModelConfig, batch_graphs, build_model,
                                    single_graph)


def make_batch(rng, bsz=4):
    pats, gras = [], []
    for _ in range(bsz):
        pats.append(single_graph(
            4, rng.integers(0, 4, 6), rng.integers(0, 4, 6),
            node_labels=rng.integers(0, 3, 4),
            edge_labels=rng.integers(0, 3, 6), v_max=4, e_max=6))
        gras.append(single_graph(
            8, rng.integers(0, 8, 16), rng.integers(0, 8, 16),
            node_labels=rng.integers(0, 3, 8),
            edge_labels=rng.integers(0, 3, 16), v_max=8, e_max=16))
    return batch_graphs(pats), batch_graphs(gras)


def main():
    rng = np.random.default_rng(0)
    pattern, graph = make_batch(rng)
    cfg = ModelConfig(max_ngv=8, max_ngvl=3, max_nge=16, max_ngel=3,
                      max_npv=4, max_npvl=3, max_npe=6, max_npel=3,
                      hid_dim=32, rep_net="DMPNN")
    model = build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), pattern, graph)
    # always jit: un-jitted apply dispatches eagerly, op by op
    out = jax.jit(model.apply)(params, pattern, graph)
    print("pred_c:", np.asarray(out["pred_c"]).ravel())

    counts = jnp.asarray(rng.poisson(2.0, (4, 1)).astype(np.float32))
    tx = optax.adamw(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            o = model.apply(p, pattern, graph)
            return jnp.mean((o["pred_c"] - counts) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss

    params, opt_state, loss = step(params, opt_state)
    print("loss after one step:", float(loss))


if __name__ == "__main__":
    main()
