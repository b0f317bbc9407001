"""The .npz checkpoints: full TrainState round trips (optax state
included), restores without a template, and atomic overwrites."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dualmessagepassing_tpu.train import TrainState, make_optimizer
from dualmessagepassing_tpu.train.checkpoint import (
    checkpoint_exists, restore_params, restore_state, save_params,
    save_state)


def _state(tx):
    params = {"enc": {"w": jnp.arange(6.0).reshape(2, 3)},
              "head": {"b": jnp.asarray([0.5, -1.0])}}
    state = TrainState.create({"params": params,
                               "batch_stats": {"bn": {"mean": jnp.ones(3)}}},
                              tx)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    updates, opt = tx.update(grads, state.opt_state, params)
    return TrainState(optax.apply_updates(params, updates), state.batch_stats,
                      opt, jnp.int32(7))


@pytest.mark.parametrize("tx", [make_optimizer(1e-3), optax.adam(1e-2),
                                optax.MultiSteps(optax.sgd(0.1), 2)],
                         ids=["amsgrad_chain", "adam", "multisteps"])
def test_state_round_trip_with_optimizer_state(tmp_path, tx):
    state = _state(tx)
    save_state(str(tmp_path / "epoch3"), state)
    assert checkpoint_exists(str(tmp_path / "epoch3"))
    back = restore_state(str(tmp_path / "epoch3"), like=state)
    a, ta = jax.tree_util.tree_flatten(state)
    b, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_restore_without_template_rebuilds_dicts(tmp_path):
    state = _state(make_optimizer(1e-3))
    save_state(str(tmp_path / "ck"), state)
    back = restore_state(str(tmp_path / "ck"))
    assert back.opt_state is None and int(back.step) == 7
    np.testing.assert_array_equal(np.asarray(back.params["enc"]["w"]),
                                  np.asarray(state.params["enc"]["w"]))
    np.testing.assert_array_equal(
        np.asarray(back.batch_stats["bn"]["mean"]), np.ones(3))
    with pytest.raises(ValueError, match="like="):
        restore_params(str(tmp_path / "ck"))   # the optax state needs like=


def test_params_overwrite_and_missing_leaf(tmp_path):
    path = str(tmp_path / "latest")
    save_params(path, {"params": {"w": np.zeros(2)}, "epoch": 0})
    save_params(path, {"params": {"w": np.ones(2)}, "epoch": 1})
    assert sorted(os.listdir(tmp_path)) == ["latest.npz"]
    got = restore_params(path, like={"params": {"w": 0}, "epoch": 0})
    np.testing.assert_array_equal(got["params"]["w"], np.ones(2))
    assert int(got["epoch"]) == 1
    with pytest.raises(KeyError):
        restore_params(path, like={"params": {"w": 0, "b": 0}})


def test_save_params_names_the_file(tmp_path):
    out = save_params(str(tmp_path / "x.npz"), {"a": np.arange(3)})
    assert out.endswith("x.npz") and os.path.exists(out)
