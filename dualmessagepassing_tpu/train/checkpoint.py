"""Checkpoints as .npz files keyed by tree path + model expansion to
larger vocabularies.

Reference behavior: the SCM driver saves `state_dict` per best epoch
(train.py:1334-1340) WITHOUT optimizer state; `model.expand` grows a trained
model to a larger vocab by zero-initializing new weights and copying the old
values into the *tail* slices (basemodel.py:167-219 + expand_dimensions,
utils/dl.py:157-191) — the multihot encoding grows at the front (new
most-significant digit blocks), so old rows live at the tail.

Our build saves the full TrainState (params + batch stats + optimizer
state + step), enabling true resume; the reference's params-only style
remains available via save_params. Each leaf is one array of the archive,
named by its `jax.tree_util.keystr` path. Restoring into a template
(`like=`) rebuilds any pytree, optax states included; without one, only
trees of nested dicts (params, batch_stats) can be rebuilt.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .scm_driver import TrainState


def _npz(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(_npz(path))


def _flatten(tree) -> Dict[str, np.ndarray]:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}


def save_params(path: str, tree) -> str:
    """Write every leaf of `tree` to `<path>.npz` (params-only checkpoints
    are the reference's epoch{E}.pt analog); returns the file name. The
    file is replaced atomically."""
    out = _npz(path)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, out)
    return out


_DICT_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def _unflatten_dicts(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = _DICT_KEY.findall(key)
        if "".join(f"['{p}']" for p in parts) != key:
            raise ValueError(
                f"checkpoint leaf {key} is not inside nested dicts; "
                "restore it with like=")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def restore_params(path: str, like=None):
    """Read `<path>.npz` into the structure of `like`, or into nested
    dicts when `like` is None."""
    with np.load(_npz(path)) as f:
        flat = {k: f[k] for k in f.files}
    if like is None:
        return _unflatten_dicts(flat)
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    missing = [jax.tree_util.keystr(p) for p, _ in paths
               if jax.tree_util.keystr(p) not in flat]
    if missing:
        raise KeyError(f"checkpoint {_npz(path)} lacks {missing[:3]}")
    return jax.tree_util.tree_unflatten(
        treedef, [flat[jax.tree_util.keystr(p)] for p, _ in paths])


def save_state(path: str, state: TrainState):
    save_params(path, {
        "params": state.params,
        "batch_stats": state.batch_stats,
        "opt_state": state.opt_state,
        "step": state.step,
    })


def restore_state(path: str, like: Optional[TrainState] = None) -> TrainState:
    """Restore a saved TrainState. Without `like`, the optimizer state
    cannot be rebuilt and comes back as None (params-only use: evaluation,
    finetuning)."""
    if like is not None:
        d = restore_params(path, {
            "params": like.params,
            "batch_stats": like.batch_stats,
            "opt_state": like.opt_state,
            "step": like.step,
        })
        opt_state = d["opt_state"]
    else:
        with np.load(_npz(path)) as f:
            flat = {k: f[k] for k in f.files
                    if not k.startswith("['opt_state']")}
        d = _unflatten_dicts(flat)
        opt_state = None
    to_dev = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return TrainState(to_dev(d["params"]), to_dev(d.get("batch_stats", {})),
                      to_dev(opt_state), jnp.asarray(d["step"]))


# =============================================================================
# expansion
# =============================================================================

def expand_params(old_tree, new_tree, pre_pad: bool = True):
    """Copy old leaves into the (tail if pre_pad) slices of new leaves.

    New leaves keep their fresh values where no old value exists; where a
    matching leaf exists the new leaf is zeroed and the old values are
    copied in (expand_dimensions semantics, utils/dl.py:157-191).
    Leaves are matched by tree path; mismatched ranks raise.
    """
    old_flat = _flatten_with_paths(old_tree)
    new_flat = _flatten_with_paths(new_tree)
    out = {}
    for path, new_leaf in new_flat.items():
        old_leaf = old_flat.get(path)
        if old_leaf is None:
            out[path] = new_leaf
            continue
        old_leaf = jnp.asarray(old_leaf)
        new_leaf = jnp.asarray(new_leaf)
        if old_leaf.shape == new_leaf.shape:
            out[path] = old_leaf
            continue
        if old_leaf.ndim != new_leaf.ndim:
            raise ValueError(f"rank mismatch at {path}")
        base = jnp.zeros_like(new_leaf)
        idx = tuple(
            slice(n - o, None) if pre_pad else slice(0, o)
            for o, n in zip(old_leaf.shape, new_leaf.shape)
        )
        out[path] = base.at[idx].set(old_leaf)
    return _unflatten_with_paths(out, new_tree)


def _flatten_with_paths(tree):
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + (k,), v)
        else:
            flat[prefix] = node

    rec((), tree)
    return flat


def _unflatten_with_paths(flat, like):
    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(prefix + (k,), v) for k, v in node.items()}
        return flat[prefix]

    return rec((), like)
