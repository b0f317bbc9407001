import jax
import jax.numpy as jnp
import numpy as np

from dualmessagepassing_tpu.ops.scatter import (
    gather_nodes,
    scatter_sum_edges,
    segment_softmax_edges,
)


def make_case(rng, b=3, v=7, e=11, h=5):
    msgs = rng.normal(size=(b, e, h)).astype(np.float32)
    recv = rng.integers(0, v, size=(b, e)).astype(np.int32)
    mask = rng.random((b, e)) < 0.7
    return msgs, recv, mask


def ref_scatter(msgs, recv, mask, v):
    b, e, h = msgs.shape
    out = np.zeros((b, v, h), np.float32)
    for bi in range(b):
        for ei in range(e):
            if mask[bi, ei]:
                out[bi, recv[bi, ei]] += msgs[bi, ei]
    return out


def test_scatter_backends_match_reference(rng):
    msgs, recv, mask = make_case(rng)
    want = ref_scatter(msgs, recv, mask, 7)
    for method in ("onehot", "segment"):
        got = scatter_sum_edges(jnp.asarray(msgs), jnp.asarray(recv),
                                jnp.asarray(mask), 7, method=method)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_scatter_grads_match(rng):
    msgs, recv, mask = make_case(rng, b=2, v=5, e=8, h=3)

    def loss(m, method):
        out = scatter_sum_edges(m, jnp.asarray(recv), jnp.asarray(mask), 5,
                                method=method)
        return jnp.sum(jnp.sin(out))

    g1 = jax.grad(lambda m: loss(m, "onehot"))(jnp.asarray(msgs))
    g2 = jax.grad(lambda m: loss(m, "segment"))(jnp.asarray(msgs))
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-5, atol=1e-5)


def test_gather_nodes(rng):
    feat = rng.normal(size=(2, 4, 3)).astype(np.float32)
    idx = np.array([[0, 3, 1], [2, 2, 0]], np.int32)
    got = np.asarray(gather_nodes(jnp.asarray(feat), jnp.asarray(idx)))
    for b in range(2):
        for e in range(3):
            np.testing.assert_array_equal(got[b, e], feat[b, idx[b, e]])


def test_segment_softmax(rng):
    scores = rng.normal(size=(1, 6)).astype(np.float32)
    recv = np.array([[0, 0, 1, 1, 1, 2]], np.int32)
    mask = np.array([[1, 1, 1, 1, 0, 1]], bool)
    out = np.asarray(
        segment_softmax_edges(jnp.asarray(scores), jnp.asarray(recv),
                              jnp.asarray(mask), 3)
    )
    # masked edge gets 0, each segment sums to 1
    assert out[0, 4] == 0.0
    np.testing.assert_allclose(out[0, :2].sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(out[0, 2:5].sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(out[0, 5], 1.0, rtol=1e-5)


def test_scatter_sum_flat_sorted_flag(rng):
    """indices_sorted=True must be numerically identical on a sorted stream."""
    from dualmessagepassing_tpu.ops.scatter import scatter_sum_flat

    recv = np.sort(rng.integers(0, 16, 64)).astype(np.int32)
    msg = rng.normal(size=(64, 8)).astype(np.float32)
    mask = rng.integers(0, 2, 64).astype(bool)
    a = scatter_sum_flat(jnp.asarray(msg), jnp.asarray(recv),
                         jnp.asarray(mask), 16)
    b = scatter_sum_flat(jnp.asarray(msg), jnp.asarray(recv),
                         jnp.asarray(mask), 16, indices_sorted=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-6, atol=1e-6)

