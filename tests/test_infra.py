"""Tests for IO (GML/CSV/config), logging, dual conversion, checkpointing,
and parameter expansion."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualmessagepassing_tpu.utils.io import (
    load_config,
    load_data,
    parse_gml,
    read_gml_graph,
    read_metadata_csv,
    save_config,
    save_results,
    str2bool,
    str2list,
    str2value,
)
from dualmessagepassing_tpu.utils.log import (
    generate_best_line,
    generate_log_line,
    get_best_epochs,
)

GML = """graph [
  directed 1
  node [ id 0 label "1" ]
  node [ id 1 label "0" ]
  node [ id 2 label "1" ]
  edge [ source 0 target 1 label "0" key 0 ]
  edge [ source 1 target 2 label "1" key 0 ]
]"""


def test_parse_gml(tmp_path):
    p = tmp_path / "g.gml"
    p.write_text(GML)
    g = read_gml_graph(str(p))
    assert g["num_nodes"] == 3
    np.testing.assert_array_equal(g["senders"], [0, 1])
    np.testing.assert_array_equal(g["receivers"], [1, 2])
    np.testing.assert_array_equal(g["node_labels"], [1, 0, 1])
    np.testing.assert_array_equal(g["edge_labels"], [0, 1])


def test_metadata_csv(tmp_path):
    p = tmp_path / "P_N1_E1.csv"
    p.write_text('g_id,counts,subisomorphisms\nG_0,2,"[[0,1],[1,2]]"\nG_1,0,"[]"\n')
    meta = read_metadata_csv(str(p))
    assert meta["G_0"]["counts"] == 2
    assert meta["G_0"]["subisomorphisms"].shape == (2, 2)
    assert meta["G_1"]["counts"] == 0


def test_load_data_splits(tmp_path):
    pdir = tmp_path / "patterns"
    gdir = tmp_path / "graphs"
    mdir = tmp_path / "metadata"
    pdir.mkdir(); mdir.mkdir()
    (pdir / "P_0.gml").write_text(GML)
    sub = gdir / "P_0"
    sub.mkdir(parents=True)
    for i in range(10):
        (sub / f"G_{i}.gml").write_text(GML)
    rows = ["g_id,counts,subisomorphisms"] + [
        f'G_{i},1,"[[0,1,2]]"' for i in range(10)]
    (mdir / "P_0.csv").write_text("\n".join(rows) + "\n")
    splits, shared = load_data(str(pdir), str(gdir), str(mdir))
    assert not shared
    # g_idx % 10: 0 -> dev, 1 -> test, others train
    assert len(splits["train"]) == 8
    assert len(splits["dev"]) == 1
    assert len(splits["test"]) == 1
    assert splits["dev"][0]["id"] == "P_0-G_0"


def test_str_helpers():
    assert str2bool("True") and not str2bool("no")
    assert str2list("1, 2,null,x") == [1, 2, "x"]
    assert str2value("0.5") == 0.5
    assert str2value("anneal_cosine$1$0") == "anneal_cosine$1$0"


def test_config_roundtrip(tmp_path):
    cfg = {"lr": 1e-3, "rep_net": "DMPNN"}
    save_config(cfg, str(tmp_path / "config.json"))
    assert load_config(str(tmp_path / "config.json")) == cfg
    save_results({"pred": np.arange(3), "x": np.float32(1.5)},
                 str(tmp_path / "r.json"))


def test_best_epoch_roundtrip(tmp_path):
    lines = [
        generate_log_line("train", epoch=3, total_epochs=10, reg=0.1),
        generate_best_line("dev", 7, 100, **{"eval-MAE": 0.123}),
        generate_best_line("test", 9, 100, **{"eval-MAE": 0.456}),
    ]
    p = tmp_path / "log.txt"
    p.write_text("\n".join(lines) + "\n")
    best = get_best_epochs(str(p))
    assert best["eval-MAE"]["dev"] == (7, 0.123)
    assert best["eval-MAE"]["test"] == (9, 0.456)


def test_dual_conversion():
    from dualmessagepassing_tpu import single_graph
    from dualmessagepassing_tpu.data.dual import convert_to_dual_record

    # triangle 0->1->2->0 : dual has 3 nodes and 3 edges (e_i -> e_{i+1})
    rec = single_graph(3, [0, 1, 2], [1, 2, 0],
                       node_labels=[5, 6, 7], edge_labels=[1, 2, 3])
    dual = convert_to_dual_record(rec)
    assert int(dual["n_node"]) == 3
    assert int(dual["n_edge"]) == 3
    # dual node labels = primal edge labels
    np.testing.assert_array_equal(dual["node_label"][:3], [1, 2, 3])
    # handshake: dual edge count = sum over nodes of indeg*outdeg
    em = dual["edge_mask"]
    # dual edge (e1 -> e2) where dst(e1) == src(e2); labels = shared node label
    for s, r, l in zip(dual["senders"][em], dual["receivers"][em],
                       dual["edge_label"][em]):
        shared = rec["receivers"][s]
        assert shared == rec["senders"][r]
        assert l == rec["node_label"][shared]


def test_dual_dataset_counts_preserved():
    from dualmessagepassing_tpu.data.dataset import GraphAdjDataset
    from dualmessagepassing_tpu.data.dual import convert_dataset_to_dual
    from dualmessagepassing_tpu.data.synthetic import generate_dataset

    data = generate_dataset(6, seed=2, pv=3, pe=3, gv=6, ge=10,
                            num_vlabels=2, num_elabels=2,
                            p_v_max=3, p_e_max=3, g_v_max=6, g_e_max=10)
    ds = GraphAdjDataset(data)
    counts = [x["counts"] for x in ds.data]
    convert_dataset_to_dual(ds)
    assert [x["counts"] for x in ds.data] == counts
    ids, pattern, graph, c, _ = ds.batchify(range(6), "none")
    assert pattern.max_nodes == 3  # dual V envelope = primal E envelope


def test_checkpoint_roundtrip(tmp_path, rng):
    from dualmessagepassing_tpu import ModelConfig, build_model
    from dualmessagepassing_tpu.train import TrainState, make_optimizer
    from dualmessagepassing_tpu.train.checkpoint import (
        restore_state, save_state)
    from tests.test_scm_model import make_pair_batch, small_config

    pattern, graph = make_pair_batch(rng)
    model = build_model(small_config())
    variables = model.init(jax.random.PRNGKey(0), pattern, graph)
    tx = make_optimizer(1e-3)
    state = TrainState.create(variables, tx)
    save_state(str(tmp_path / "ckpt"), state)
    restored = restore_state(str(tmp_path / "ckpt"), like=state)
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_expand_params():
    from dualmessagepassing_tpu.train.checkpoint import expand_params

    old = {"emb": {"weight": jnp.arange(6.0).reshape(2, 3)},
           "fc": {"bias": jnp.asarray([1.0, 2.0])}}
    new = {"emb": {"weight": jnp.ones((4, 5))},
           "fc": {"bias": jnp.zeros((2,))},
           "extra": {"w": jnp.full((2, 2), 7.0)}}
    out = expand_params(old, new, pre_pad=True)
    w = np.asarray(out["emb"]["weight"])
    # old block in the tail, zeros elsewhere
    np.testing.assert_array_equal(w[2:, 2:], np.arange(6.0).reshape(2, 3))
    assert w[:2].sum() == 0 and w[:, :2].sum() == 0
    np.testing.assert_array_equal(np.asarray(out["fc"]["bias"]), [1.0, 2.0])
    np.testing.assert_array_equal(np.asarray(out["extra"]["w"]), 7.0 * np.ones((2, 2)))


def test_dense_parts_equals_concat(rng):
    """Dense(parts=[...]) is the concat-free equivalent of Dense(concat):
    identical params, identical output — incl. rank-broadcast parts."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dualmessagepassing_tpu.models.layers import Dense

    b, l, h = 3, 5, 4
    g = jnp.asarray(rng.normal(size=(b, l, h)), jnp.float32)
    p = jnp.asarray(rng.normal(size=(b, 1, h)), jnp.float32)
    s = jnp.asarray(rng.normal(size=(b, 1, 1)), jnp.float32)

    dense = Dense(6, init="normal", activation="relu")
    full = jnp.concatenate(
        [jnp.broadcast_to(p, (b, l, h)), g, g - p, g * p,
         jnp.broadcast_to(s, (b, l, 1))], axis=2)
    # Dense's `init` FIELD shadows Module.init — call it unbound
    from dualmessagepassing_tpu import nn
    params = nn.Module.init(dense, jax.random.PRNGKey(0), full)
    y_cat = dense.apply(params, full)
    y_parts = dense.apply(params, parts=[p, g, g - p, g * p, s])
    np.testing.assert_allclose(np.asarray(y_cat), np.asarray(y_parts),
                               atol=1e-5, rtol=1e-5)


def test_dense_collate_cache_matches_and_invalidates(rng):
    """The dataset-level dense collate cache returns exactly the stacked
    batch and is dropped by in-place transforms (add_reversed_edges)."""
    import numpy as np
    import jax
    from dualmessagepassing_tpu.data.dataset import GraphAdjDataset
    from dualmessagepassing_tpu.data.synthetic import generate_dataset

    data = generate_dataset(12, seed=3, pv=3, pe=3, gv=8, ge=16,
                            num_vlabels=2, num_elabels=2,
                            p_v_max=4, p_e_max=4, g_v_max=8, g_e_max=16)
    ds = GraphAdjDataset(data)
    a = ds.batchify(range(8), "nodeedge")       # builds the cache
    ds_fb = GraphAdjDataset(data)
    ds_fb._dense = {"pattern": None, "graph": None}   # force stacking path
    b = ds_fb.batchify(range(8), "nodeedge")
    for x, y in zip(jax.tree.leaves((a[1], a[2], a[3], a[4])),
                    jax.tree.leaves((b[1], b[2], b[3], b[4]))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    e_before = a[2].edge_mask.shape[1]
    ds.add_reversed_edges(2, 2)                 # mutates + invalidates
    c = ds.batchify(range(8), "nodeedge")
    assert c[2].edge_mask.shape[1] == 2 * e_before
