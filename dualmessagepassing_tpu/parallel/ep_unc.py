"""Edge-partitioned execution of the REAL UNC model.

Runs `UNCTrainModel` — the full DualGraphConv / CompGCN / R-GCN / R-GIN
stack with update MLPs, batch norm, edge_norm, DistMult loss and all three
regularizers (reference Model/DMPNN/src/model.py:117-280, 632-737) — under
`shard_map` with the edge/dual-node state sharded across the 'ep' mesh axis
and node state replicated (V << E for the target workloads: Yelp 30.5M
edges over 82K nodes).

Collective schedule per layer (see unc/model.py `ep_axis`):
  * one psum completes the node aggregation ([V, H]),
  * one psum for out-degrees (reused), two [H]-wide psums for each
    BatchNorm's global statistics,
and per loss: [R,H]/scalar psums for the per-relation edge means and the
edge-stream regularizer sums. Gradients need no manual collectives —
shard_map's transpose inserts the psums for the replicated parameters.

The simplified demonstration layer lives in parallel/edge_partition.py;
this module is the production path wired into train_unc(ep_devices=...).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..unc.model import UNCTrainModel

# per-edge arrays sharded over 'ep'; everything else replicated.
EDGE_KEYS = ("senders", "receivers", "edge_type", "rev_flag", "edge_mask",
             "edge_norm")


def _shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def sub_specs(sub: Dict[str, jnp.ndarray]) -> Dict[str, P]:
    return {k: (P("ep") if k in EDGE_KEYS else P()) for k in sub}


def shard_sub(mesh: Mesh, sub: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    """device_put a padded flat subgraph with edge arrays sharded over 'ep'.

    The edge envelope (e_max) must divide the mesh size — round it up with
    `pad_e_max` when building the envelope."""
    n = mesh.devices.size
    e = len(sub["senders"])
    if e % n:
        raise ValueError(f"e_max={e} not divisible by mesh size {n}; "
                         f"use pad_e_max")
    out = {}
    for k, v in sub.items():
        spec = P("ep") if k in EDGE_KEYS else P()
        out[k] = jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))
    return out


def pad_e_max(e_max: int, n_devices: int) -> int:
    return -(-e_max // n_devices) * n_devices


def make_ep_model(**model_kwargs) -> UNCTrainModel:
    """UNCTrainModel configured for the 'ep' axis."""
    return UNCTrainModel(ep_axis="ep", **model_kwargs)


def _out_spec(model: UNCTrainModel):
    """PartitionSpecs of the backbone's output tuple: the edge stream (z/r
    per edge) is 'ep'-sharded; node embeddings and per-relation means are
    replicated (completed by in-model psums)."""
    if model.backbone == "DMPNN":     # (h, z, r_bar)
        return (P(), P("ep"), P())
    if model.backbone == "CompGCN":   # (h, r)
        return (P(), P("ep"))
    return (P(),)                     # (h,)


def make_ep_apply(model: UNCTrainModel, mesh: Mesh) -> Callable:
    """Jitted edge-partitioned forward: (variables, sub) -> (out_tuple, pred).

    Forward-only (train=False); for training use make_ep_train_step."""

    @jax.jit
    def fwd(variables, sub):
        def inner(variables, sub):
            out, pred = model.apply(variables, sub, train=False)
            # pred is None in unsupervised mode; shard_map outputs must be
            # arrays, so substitute a scalar placeholder
            return out, (pred if pred is not None else jnp.zeros(()))

        return _shard_map(
            inner, mesh,
            in_specs=(P(), sub_specs(sub)),
            out_specs=(_out_spec(model), P()),
        )(variables, sub)

    return fwd


def make_ep_train_step(model: UNCTrainModel, tx, mesh: Mesh,
                       amp: bool = False) -> Callable:
    """Jitted edge-partitioned unsupervised train step with the FULL loss:
    DistMult BCE + reg_param * (w_rel/embedding/edge_fc-alignment regs)
    (reference model.py:691-723), Adam/any-optax update.

    Matches make_unc_train_step's signature:
      (params, opt_state, batch_stats, sub, dropout_rng)
        -> (params, opt_state, batch_stats, loss)
    Parameter gradients come out all-reduced by shard_map's transpose.
    amp=True runs the backbone in bf16 with f32 master params / loss
    (unc.model.apply_unc_forward).
    """
    import optax

    from ..unc.model import apply_unc_forward

    @jax.jit
    def step(params, opt_state, batch_stats, sub, dropout_rng):
        spec = sub_specs(sub)

        def loss_fn(p):
            def inner(p, batch_stats, sub, rng):
                (out, _pred), new_stats = apply_unc_forward(
                    model, p, batch_stats, sub, rng, amp=amp)
                loss = model.apply(
                    {"params": p}, out, sub["edge_type"], sub["edge_mask"],
                    sub["samples"], sub["labels"], sub["sample_mask"],
                    sub["node_mask"],
                    method=UNCTrainModel.unsupervised_loss)
                return loss, new_stats

            # loss and BN stats are psum-completed inside the model, hence
            # identical on every shard -> replicated out_specs
            return _shard_map(
                inner, mesh,
                in_specs=(P(), P(), spec, P()),
                out_specs=(P(), P()),
            )(p, batch_stats, sub, dropout_rng)

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, (new_stats if batch_stats else batch_stats), loss

    return step
