"""Data-parallel training step over a device mesh.

On CPU: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
            python examples/multichip_dp.py
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
    # must run before any backend initialization (calling
    # jax.default_backend() here would already initialize one)
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from dualmessagepassing_tpu import ModelConfig, build_model  # noqa: E402
from dualmessagepassing_tpu.parallel.dp import (  # noqa: E402
    make_dp_mesh, replicate, shard_batch)
from examples.quickstart_scm import make_batch  # noqa: E402


def main():
    n_dev = len(jax.devices())
    mesh = make_dp_mesh()
    print(f"mesh: {n_dev} devices on axis 'dp'")

    rng = np.random.default_rng(0)
    pattern, graph = make_batch(rng, bsz=2 * n_dev)
    cfg = ModelConfig(max_ngv=8, max_ngvl=3, max_nge=16, max_ngel=3,
                      max_npv=4, max_npvl=3, max_npe=6, max_npel=3,
                      hid_dim=32, rep_net="DMPNN")
    model = build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), pattern, graph)

    # batch sharded over 'dp', params replicated; XLA inserts the psum
    pattern = shard_batch(mesh, pattern)
    graph = shard_batch(mesh, graph)
    params = replicate(mesh, params)
    counts = shard_batch(
        mesh, jnp.asarray(rng.poisson(2.0, (2 * n_dev, 1)).astype(np.float32)))

    tx = optax.adamw(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, pattern, graph, counts):
        def loss_fn(p):
            o = model.apply(p, pattern, graph)
            return jnp.mean((o["pred_c"] - counts) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss

    params, opt_state, loss = step(params, opt_state, pattern, graph, counts)
    print("dp train-step loss:", float(loss))


if __name__ == "__main__":
    main()
