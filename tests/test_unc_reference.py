"""The UNC model's XLA path against a plain float32 reference.

The model routes its row gathers through custom VJPs (_take_rows,
_take_rows_perm: f32-accumulating, sorted-index backward scatters) and
its aggregation through a sorted f32 scatter-add. The reference swaps
those three for plain `table[idx]` and `jax.ops.segment_sum`, leaving
autodiff's own transposes; loss and gradients must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualmessagepassing_tpu.unc import model as unc_model
from dualmessagepassing_tpu.unc.data import add_pair_keys
from dualmessagepassing_tpu.unc.model import (UNCTrainModel,
                                              apply_unc_forward,
                                              init_unc_variables)

from tests.test_unc import make_tiny_padded


def _reference_primitives(monkeypatch):
    monkeypatch.setattr(unc_model, "_take_rows",
                        lambda table, idx, sorted_idx=False: table[idx])
    monkeypatch.setattr(unc_model, "_take_rows_perm",
                        lambda table, idx, order, idx_sorted: table[idx])
    monkeypatch.setattr(
        unc_model, "_segment_sum_f32",
        lambda msg, receivers, v, h, sorted_edges: jax.ops.segment_sum(
            msg.astype(jnp.float32), receivers, num_segments=v
        ).astype(msg.dtype))


def _loss_and_grads(model, variables, sub):
    stats = variables.get("batch_stats", {})

    def loss(params):
        (out, _), _ = apply_unc_forward(model, params, stats, sub,
                                        jax.random.PRNGKey(1))
        return model.apply({"params": params}, out, sub["edge_type"],
                           sub["edge_mask"], sub["samples"], sub["labels"],
                           sub["sample_mask"], sub["node_mask"],
                           method=UNCTrainModel.unsupervised_loss)

    return jax.jit(jax.value_and_grad(loss))(variables["params"])


@pytest.mark.parametrize("backbone,layout", [
    ("DMPNN", "split"), ("DMPNN", "fused"), ("DMPNN", "unsorted"),
    ("CompGCN", "split"), ("RGCN", "split"), ("RGIN", "split"),
])
def test_unc_step_matches_segment_sum_reference(rng, monkeypatch, backbone,
                                                layout):
    padded = make_tiny_padded(rng)
    if layout == "fused":
        padded = add_pair_keys(padded)
    sub = {k: jnp.asarray(v) for k, v in padded.items()}
    model = UNCTrainModel(num_nodes=20, num_rels=3, h_dim=8, nlabel=0,
                          num_hidden_layers=2, dropout=0.0, reg_param=0.01,
                          backbone=backbone,
                          sorted_edges=layout != "unsorted")
    variables = init_unc_variables(model, jax.random.PRNGKey(0), sub)
    loss, grads = _loss_and_grads(model, variables, sub)
    _reference_primitives(monkeypatch)
    ref_loss, ref_grads = _loss_and_grads(model, variables, sub)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    ref_flat = jax.tree_util.tree_leaves(ref_grads)
    scale = max(float(np.max(np.abs(g))) for g in ref_flat)
    for (path, g), r in zip(flat, ref_flat):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=str(path))
