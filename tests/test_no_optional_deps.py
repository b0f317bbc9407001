"""The package trains without flax, orbax, sklearn or tensorboardX.

A child process blocks those imports, then runs one SCM and one UNC
train step and a checkpoint round trip through the package alone — the
machine with the GPU is only sure to have JAX, optax, numpy and scipy.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import importlib.abc
import sys

BLOCKED = {"flax", "orbax", "sklearn", "tensorboardX"}


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked for this test: {name}")
        return None


sys.meta_path.insert(0, Block())
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import optax

from dualmessagepassing_tpu import build_model
from dualmessagepassing_tpu.train import (TrainState, make_optimizer,
                                          make_train_step)
from dualmessagepassing_tpu.train.checkpoint import restore_state, save_state
from dualmessagepassing_tpu.unc.driver import make_unc_train_step
from dualmessagepassing_tpu.unc.model import UNCTrainModel, init_unc_variables
from tests.test_scm_model import make_pair_batch, small_config
from tests.test_unc import make_tiny_padded

rng = np.random.default_rng(0)
pattern, graph = make_pair_batch(rng)
model = build_model(small_config())
tx = make_optimizer(1e-3)
state = TrainState.create(model.init(jax.random.PRNGKey(0), pattern, graph),
                          tx)
step = make_train_step(model, tx, "MSE", "nodeedge", amp=True)
f = jnp.float32
counts = jnp.ones((2, 1), f)
nw = jnp.zeros(graph.node_mask.shape, f)
ew = jnp.zeros(graph.edge_mask.shape, f)
state, losses = step(state, pattern, graph, counts, nw, ew, f(0.2), f(0.0),
                     f(0.0), f(0.0), f(1.0), jax.random.PRNGKey(1))
assert np.isfinite(float(losses["total"]))
save_state(sys.argv[1], state)
back = restore_state(sys.argv[1], like=state)
assert int(back.step) == 1

sub = {k: jnp.asarray(v) for k, v in make_tiny_padded(rng).items()}
unc = UNCTrainModel(num_nodes=20, num_rels=3, h_dim=8, num_hidden_layers=2,
                    reg_param=0.01, sorted_edges=True)
variables = init_unc_variables(unc, jax.random.PRNGKey(0), sub)
utx = optax.adam(1e-2)
params = variables["params"]
out = make_unc_train_step(unc, utx, amp=True)(
    params, utx.init(params), variables.get("batch_stats", {}), sub,
    jax.random.PRNGKey(2))
assert np.isfinite(float(out[3]))
assert not BLOCKED & {m.split(".")[0] for m in sys.modules}
print("trained without optional packages")
'''


def test_train_steps_without_optional_packages(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", CHILD,
                        str(tmp_path / "ckpt")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "trained without optional packages" in r.stdout
