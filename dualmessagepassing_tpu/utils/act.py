"""Activation registry (incl. sparsemax / gumbel-softmax / maximum / minimum).

Functional JAX counterpart of the reference activation registry
(/root/reference/SubgraphCountingMatching/utils/act.py:1-489, in particular
the custom `Sparsemax` at 210-356). Activations here are plain functions
``f(x, axis=...)`` — no layer objects — selected by
`map_activation_str_to_fn`, mirroring `map_activation_str_to_layer`.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..constants import LEAKY_RELU_A


def identity(x):
    return x


def leaky_relu(x, negative_slope: float = LEAKY_RELU_A):
    return jax.nn.leaky_relu(x, negative_slope=negative_slope)


def maximum(x, axis=-1):
    """Hard-max one-hot along axis (reference `Maximum`)."""
    return (x == jnp.max(x, axis=axis, keepdims=True)).astype(x.dtype)


def minimum(x, axis=-1):
    return (x == jnp.min(x, axis=axis, keepdims=True)).astype(x.dtype)


def sparsemax(x, axis: int = -1):
    """Sparsemax (Martins & Astudillo 2016) with a static full sort.

    Replaces the reference's custom autograd `Sparsemax` (utils/act.py:210-356)
    with a static-shape formulation: full descending sort (static shape),
    support size k* = max{k : 1 + k*z_(k) > cumsum(z)_k}, threshold
    tau = (cumsum_{k*} - 1) / k*, output = max(z - tau, 0).  The standard JVP
    through this composition equals the sparsemax Jacobian a.e., so no custom
    VJP is required.
    """
    x = jnp.swapaxes(x, axis, -1)
    n = x.shape[-1]
    # numerical-stability shift (does not change output)
    z = x - jax.lax.stop_gradient(jnp.max(x, axis=-1, keepdims=True))
    z_sorted = -jnp.sort(-jax.lax.stop_gradient(z), axis=-1)
    cumsum = jnp.cumsum(z_sorted, axis=-1)
    k = jnp.arange(1, n + 1, dtype=x.dtype)
    support = 1.0 + k * z_sorted > cumsum
    k_star = jnp.sum(support, axis=-1, keepdims=True).astype(x.dtype)
    cumsum_k = jnp.take_along_axis(cumsum, jnp.maximum(k_star.astype(jnp.int32) - 1, 0), axis=-1)
    tau = (cumsum_k - 1.0) / jnp.maximum(k_star, 1.0)
    out = jnp.maximum(z - tau, 0.0)
    return jnp.swapaxes(out, axis, -1)


def gumbel_softmax(x, axis: int = -1, tau: float = 1.0, rng=None):
    """Gumbel-softmax sample (soft). Deterministic softmax if rng is None."""
    if rng is not None:
        g = -jnp.log(-jnp.log(jax.random.uniform(rng, x.shape) + 1e-20) + 1e-20)
        x = x + g
    return jax.nn.softmax(x / tau, axis=axis)


_ACTS = {
    "none": identity,
    "identity": identity,
    "relu": jax.nn.relu,
    "relu6": jax.nn.relu6,
    "elu": jax.nn.elu,
    "selu": jax.nn.selu,
    "celu": jax.nn.celu,
    "gelu": jax.nn.gelu,
    "leaky_relu": leaky_relu,
    "prelu": leaky_relu,  # PReLU init slope == LEAKY_RELU_A in the reference
    "sigmoid": jax.nn.sigmoid,
    "tanh": jnp.tanh,
    "softmax": jax.nn.softmax,
    "sparsemax": sparsemax,
    "gumbel_softmax": gumbel_softmax,
    "maximum": maximum,
    "minimum": minimum,
}


def supported_act_funcs():
    return sorted(_ACTS)


def map_activation_str_to_fn(act: str) -> Callable:
    """Activation-by-name, with `leaky_relu0.1`-style slope suffix support."""
    if act in _ACTS:
        return _ACTS[act]
    if act.startswith("leaky_relu"):
        slope = float(act[len("leaky_relu"):])
        return functools.partial(leaky_relu, negative_slope=slope)
    raise NotImplementedError(f"activation '{act}' is not supported")
