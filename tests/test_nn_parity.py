"""The in-repo module layer (dualmessagepassing_tpu/nn.py) against flax.

Each case builds the same model twice: once from this package, and once
from a second copy of the package whose `nn` module is `flax.linen`.
`init` must give bit-identical variable trees and `apply` equal outputs,
including dropout masks and updated BatchNorm statistics in train mode.
The cases skip where flax is not installed.
"""

import dataclasses
import functools
import importlib.util
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dualmessagepassing_tpu
from dualmessagepassing_tpu import build_model, nn

from tests.test_edgeseq import make_seq_batch, seq_config
from tests.test_scm_model import make_pair_batch, small_config

_TWIN = "_dmp_flax_twin"


@functools.lru_cache(maxsize=None)
def _flax_twin():
    """Import a second copy of the package whose `nn` is flax.linen."""
    fnn = pytest.importorskip("flax.linen")
    import flax.struct

    shim = types.ModuleType(_TWIN + ".nn")
    shim.__dict__.update(
        {k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("_")})
    shim.struct = flax.struct
    pkg_dir = pathlib.Path(dualmessagepassing_tpu.__file__).parent
    spec = importlib.util.spec_from_file_location(
        _TWIN, pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    pkg = importlib.util.module_from_spec(spec)
    pkg.nn = shim
    sys.modules[_TWIN] = pkg
    sys.modules[_TWIN + ".nn"] = shim
    spec.loader.exec_module(pkg)
    return pkg


def _twin_module(name):
    _flax_twin()
    return importlib.import_module(
        name.replace("dualmessagepassing_tpu", _TWIN, 1))


def _to_twin(x):
    """Rebuild this package's pytree dataclasses as the twin's classes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(_twin_module(type(x).__module__), type(x).__name__)
        return cls(**{f.name: _to_twin(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _to_twin(v) for k, v in x.items()}
    return x


def _assert_same(a, b):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def _check_model(ours, theirs, args, train_kwargs=None):
    key = jax.random.PRNGKey(3)
    v_ours = ours.init(key, *args)
    v_theirs = theirs.init(key, *_to_twin(args))
    _assert_same(v_ours, v_theirs)
    _assert_same(ours.apply(v_ours, *args),
                 theirs.apply(v_theirs, *_to_twin(args)))
    if train_kwargs is not None:
        kw = dict(train_kwargs, rngs={"dropout": jax.random.PRNGKey(7)},
                  mutable=["batch_stats"])
        _assert_same(ours.apply(v_ours, *args, **kw),
                     theirs.apply(v_theirs, *_to_twin(args), **kw))


def _scm_inputs(rep_net, rng):
    if rep_net in ("CNN", "RNN", "TXL"):
        return make_seq_batch(rng), seq_config
    if rep_net in ("LRP", "DMPLRP"):
        from dualmessagepassing_tpu.data.dataset import GraphAdjDataset
        from dualmessagepassing_tpu.data.synthetic import generate_dataset
        data = generate_dataset(8, seed=9, pv=3, pe=3, gv=6, ge=10,
                                num_vlabels=2, num_elabels=2, p_v_max=4,
                                p_e_max=4, g_v_max=6, g_e_max=10)
        _, p, g, _, _ = GraphAdjDataset(data).batchify_lrp(range(4), "none")
        cfg = functools.partial(
            small_config, max_ngv=6, max_ngvl=2, max_nge=10, max_ngel=2,
            max_npv=4, max_npvl=2, max_npe=4, max_npel=2, hid_dim=8,
            pred_hid_dim=8)
        return (p, g), cfg
    return make_pair_batch(rng), small_config


_REP_EXTRA = {
    "DMPNN": {"rep_dmpnn_batch_norm": True, "rep_remat": True},
    "CompGCN": {"rep_compgcn_batch_norm": True},
    "RGCN": {"rep_rgcn_num_bases": 2},
    "RGIN": {"rep_rgin_num_bases": 2, "rep_rgin_batch_norm": True},
    "LRP": {},
    "DMPLRP": {},
    "CNN": {},
    "RNN": {"rep_rnn_type": "GRU", "rep_rnn_bidirectional": True,
            "rep_rnn_layer_norm": True},
    "TXL": {"rep_txl_seg_len": 8, "rep_txl_mem_len": 8},
}


@pytest.mark.parametrize("pred_net,pred_extra", [
    ("SumPredictNet", {}),
    ("DIAMNet", {"pred_mem_len": 3, "pred_mem_init": "circular_lstm"}),
])
@pytest.mark.parametrize("rep_net", sorted(_REP_EXTRA))
def test_scm_model_matches_flax(rng, rep_net, pred_net, pred_extra):
    (pattern, graph), make_cfg = _scm_inputs(rep_net, rng)
    cfg = make_cfg(rep_net=rep_net, pred_net=pred_net, rep_dropout=0.2,
                   pred_dropout=0.2, **_REP_EXTRA[rep_net], **pred_extra)
    theirs = _twin_module("dualmessagepassing_tpu.models.scm_models")
    _check_model(build_model(cfg), theirs.build_model(cfg),
                 (pattern, graph), train_kwargs={"train": True})


@pytest.mark.parametrize("backbone", ["DMPNN", "CompGCN", "RGCN", "RGIN"])
def test_unc_model_matches_flax(rng, backbone):
    from dualmessagepassing_tpu.unc.model import (
        UNCTrainModel, init_unc_variables)
    from tests.test_unc import make_tiny_padded

    sub = {k: jnp.asarray(v) for k, v in make_tiny_padded(rng).items()}
    kw = dict(num_nodes=20, num_rels=3, h_dim=8, nlabel=0,
              num_hidden_layers=2, dropout=0.2, reg_param=0.01,
              backbone=backbone)
    twin = _twin_module("dualmessagepassing_tpu.unc.model")
    ours, theirs = UNCTrainModel(**kw), twin.UNCTrainModel(**kw)
    key = jax.random.PRNGKey(1)
    v_ours = init_unc_variables(ours, key, sub)
    v_theirs = twin.init_unc_variables(theirs, key, sub)
    _assert_same(v_ours, v_theirs)
    run = dict(train=True, mutable=["batch_stats"],
               rngs={"dropout": jax.random.PRNGKey(2)})
    _assert_same(ours.apply(v_ours, sub, **run),
                 theirs.apply(v_theirs, sub, **run))


def _layer_cases():
    """(name, builder(nn) -> module, input shapes, kwargs of the call)."""
    def rnn(cell, **kw):
        def build(m):
            return m.RNN(getattr(m, cell)(5), **kw)
        return build

    def birnn(m):
        return m.Bidirectional(m.RNN(m.GRUCell(3)), m.RNN(m.GRUCell(3)))

    def remat_dense(m):
        class Block(m.Module):
            @m.compact
            def __call__(self, x, train):
                x = m.Dense(6)(x)
                return m.Dropout(0.3)(x, deterministic=not train)

        class Outer(m.Module):
            @m.compact
            def __call__(self, x, train):
                return m.remat(Block, static_argnums=(2,))(name="blk")(
                    x, train)
        return Outer()

    return [
        ("Dense", lambda m: m.Dense(7), (3, 4), {}),
        ("Conv", lambda m: m.Conv(6, kernel_size=(2,), strides=(1,),
                                  padding=[(1, 1)]), (2, 9, 4), {}),
        ("LayerNorm", lambda m: m.LayerNorm(), (3, 4), {}),
        ("Dropout", lambda m: m.Dropout(0.4), (3, 4),
         {"deterministic": False}),
        ("LSTM", rnn("OptimizedLSTMCell", return_carry=True), (2, 6, 4),
         {"seq_lengths": jnp.asarray([6, 3])}),
        ("GRU", rnn("GRUCell"), (2, 6, 4), {}),
        ("SimpleCell", rnn("SimpleCell", reverse=True, keep_order=True),
         (2, 6, 4), {}),
        ("Bidirectional", birnn, (2, 6, 4), {}),
        ("remat", remat_dense, (3, 4), {"train": True}),
    ]


@pytest.mark.parametrize("case", _layer_cases(), ids=lambda c: c[0])
def test_layer_matches_flax(rng, case):
    _, build, shape, kwargs = case
    fnn = _flax_twin().nn
    x = jnp.asarray(rng.normal(size=shape), jnp.float32)
    rngs = {"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5)}
    v_ours = build(nn).init(rngs, x, **kwargs)
    v_theirs = build(fnn).init(rngs, x, **kwargs)
    _assert_same(v_ours, v_theirs)
    drop = {"dropout": jax.random.PRNGKey(6)}
    _assert_same(build(nn).apply(v_ours, x, rngs=drop, **kwargs),
                 build(fnn).apply(v_theirs, x, rngs=drop, **kwargs))

    def loss(v, m):
        return jnp.sum(jax.tree_util.tree_leaves(
            m.apply(v, x, rngs=drop, **kwargs))[-1] ** 2)

    _assert_same(jax.grad(loss)(v_ours, build(nn)),
                 jax.grad(loss)(v_theirs, build(fnn)))


def test_struct_dataclass_is_a_pytree():
    @nn.struct.dataclass
    class Pair:
        a: jnp.ndarray
        n: int = nn.struct.field(pytree_node=False)

    p = Pair(jnp.ones(3), 4)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 1
    q = jax.tree_util.tree_unflatten(treedef, [leaves[0] * 2])
    assert q.n == 4 and float(q.a.sum()) == 6.0
    assert p.replace(n=5).n == 5
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.n = 1
