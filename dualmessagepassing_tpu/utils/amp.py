"""Mixed precision (bf16 compute) for the SCM hot path.

The flagship step at hid_dim=64 is bound by memory traffic, not matmul
rate, so the win of bf16 compute is HALVING the device-memory bytes of
every activation tensor the fused step streams.

Mechanism: a TRACE-TIME compute dtype. `set_compute_dtype` flips a module
global consulted by the model's few explicit dtype pins (mask->gate casts,
encoding tables); everything else in the model follows its input dtypes.
The training step (train/scm_driver.py make_train_step(amp=True)) keeps
f32 MASTER params and optimizer state, casts params + float batch leaves
to bf16 at the step boundary, and computes the loss/regularizers in f32.
Because the dtype is read while TRACING, it must be set before jit-compile
(the drivers do this); it is not a runtime switch.

Exact-count subtlety: mask-length sums (pl/gl in the predict nets) are
computed in f32 and only then cast — bf16 cannot represent integers above
256 exactly and the reference semantics divide by these counts.
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp

_COMPUTE_DTYPE = jnp.float32


def compute_dtype():
    """The dtype model internals should cast gates/tables to (trace-time)."""
    return _COMPUTE_DTYPE


def set_compute_dtype(dtype) -> None:
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = jnp.dtype(dtype)


@contextlib.contextmanager
def compute_dtype_scope(dtype):
    prev = _COMPUTE_DTYPE
    set_compute_dtype(dtype)
    try:
        yield
    finally:
        set_compute_dtype(prev)


def cast_floats(tree, dtype):
    """Cast every float leaf of a pytree (params or batch) to dtype."""
    import jax

    def f(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree.map(f, tree)
