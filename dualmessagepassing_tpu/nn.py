"""A small module system with the semantics of the part of `flax.linen`
this package uses, so that the models need nothing beyond JAX.

What it provides: `Module` (dataclass fields, `setup`, `@compact`,
`param`, `variable`, `make_rng`, `init`/`apply` with `mutable=` and
`method=`), `Dense`, `Conv`, `LayerNorm`, `Dropout`, `remat`, `RNN` with
`OptimizedLSTMCell`/`GRUCell`/`SimpleCell`, `Bidirectional`, and
`struct.dataclass`/`struct.field` for pytree containers. `initializers`
is `jax.nn.initializers`; the models call `jax.nn`'s activations directly.

Variable trees keep flax's names (`Dense_0`, explicit `name=`, `setup`
attribute names), and RNG streams are derived as `flax.core.scope` does:
each call of `make_rng(name)` in the module at `path` folds the SHA-1 of
`path + (counter,)` into the root key, with one counter per (path, name).
`init` therefore returns the same parameters as flax for the same key
(tests/test_nn_parity.py).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import types
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

initializers = jax.nn.initializers


# ---- pytree dataclasses ------------------------------------------------------

def _struct_field(pytree_node: bool = True, **kwargs):
    metadata = dict(kwargs.pop("metadata", {}), pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def _struct_dataclass(cls):
    """Frozen dataclass registered as a pytree; fields made with
    `field(pytree_node=False)` are static metadata."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f for f in dataclasses.fields(cls) if f.init]
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls


struct = types.SimpleNamespace(dataclass=_struct_dataclass, field=_struct_field)


# ---- variable frames and RNG streams -----------------------------------------

def _fold_in_static(key, data):
    """flax.core.scope._fold_in_static: fold the SHA-1 of the static path
    and counter into `key`."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    hash_int = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(hash_int))


def _copy_dicts(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


class _Frame:
    """State of one `init` or `apply`: the variable collections, the root
    RNG keys, the mutability filter and the per-(path, stream) counters."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = {c: _copy_dicts(v) for c, v in variables.items()}
        self.rngs = dict(rngs)
        self.mutable = mutable
        self.initializing = initializing
        self.counters: Dict[Tuple, int] = {}

    def is_mutable(self, col: str) -> bool:
        if self.mutable is True:
            return col != "intermediates"
        if isinstance(self.mutable, str):
            return col == self.mutable
        return bool(self.mutable) and col in self.mutable

    def subtree(self, col, path):
        node = self.variables.get(col)
        for p in path:
            if node is None:
                return None
            node = node.get(p)
        return node

    def get(self, col, path, name):
        node = self.subtree(col, path)
        return None if node is None else node.get(name)

    def has(self, col, path, name):
        node = self.subtree(col, path)
        return node is not None and name in node

    def put(self, col, path, name, value):
        node = self.variables.setdefault(col, {})
        for p in path:
            node = node.setdefault(p, {})
        node[name] = value

    def set_subtree(self, col, path, tree):
        if not path:
            self.variables[col] = tree
            return
        node = self.variables.setdefault(col, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = tree

    def mutated(self):
        return {c: v for c, v in self.variables.items() if self.is_mutable(c)}


class Variable:
    """A mutable view of one variable, read and written through `.value`."""

    def __init__(self, frame, col, path, name):
        self._frame, self.collection, self._path, self.name = (
            frame, col, path, name)

    @property
    def value(self):
        return self._frame.get(self.collection, self._path, self.name)

    @value.setter
    def value(self, v):
        if not self._frame.is_mutable(self.collection):
            raise ValueError(
                f"collection '{self.collection}' is not mutable; pass "
                f"mutable=['{self.collection}'] to apply()")
        self._frame.put(self.collection, self._path, self.name, v)


# ---- modules -----------------------------------------------------------------

_STACK: list = []          # bound modules whose methods are running
_UNSPECIFIED = object()


def compact(fun):
    """Mark a method whose body may create submodules inline; children
    without a name are called `<ClassName>_<n>` in order of creation."""
    fun.compact = True
    return fun


def nowrap(fun):
    fun.nowrap = True
    return fun


def _wrap_method(fun):
    is_compact = getattr(fun, "compact", False)

    @functools.wraps(fun)
    def wrapped(self, *args, **kwargs):
        if self.__dict__.get("_frame") is None:
            return fun(self, *args, **kwargs)
        self._try_setup()
        outer = self._in_compact
        if is_compact:
            object.__setattr__(self, "_in_compact", True)
        _STACK.append(self)
        try:
            if self.name is not None:
                with jax.named_scope(self.name):
                    return fun(self, *args, **kwargs)
            return fun(self, *args, **kwargs)
        finally:
            _STACK.pop()
            if is_compact and not outer:
                object.__setattr__(self, "_in_compact", False)
                object.__setattr__(self, "_cursor", {})

    wrapped.compact = is_compact
    wrapped.wrapped = True
    return wrapped


_NOT_WRAPPED = {"setup", "__post_init__", "__init__", "__repr__", "__eq__",
                "__hash__", "__setattr__", "__getattr__", "__init_subclass__"}


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class of every model layer. Subclasses are dataclasses whose
    fields are the layer's configuration; `name` and `parent` are
    keyword-only."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)
    parent: Any = dataclasses.field(default=_UNSPECIFIED, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(eq=False, repr=False)(cls)
        for key, val in list(cls.__dict__.items()):
            if (inspect.isfunction(val) and key not in _NOT_WRAPPED
                    and (key == "__call__" or not key.startswith("__"))
                    and not getattr(val, "nowrap", False)
                    and not getattr(val, "wrapped", False)):
                setattr(cls, key, _wrap_method(val))

    # -- binding ---------------------------------------------------------------
    def __post_init__(self):
        for k, v in (("_frame", None), ("_path", ()), ("_setup_done", False),
                     ("_in_setup", False), ("_in_compact", False),
                     ("_cursor", {})):
            object.__setattr__(self, k, v)
        parent = self.parent
        if parent is _UNSPECIFIED:
            parent = _STACK[-1] if _STACK else None
            object.__setattr__(self, "parent", parent)
        if parent is None:
            return
        if parent._in_setup and self.name is None:
            return                      # named when assigned in setup()
        if self.name is None:
            prefix = type(self).__name__
            n = parent._cursor.get(prefix, 0)
            parent._cursor[prefix] = n + 1
            object.__setattr__(self, "name", f"{prefix}_{n}")
        self._bind(parent._frame, parent._path + (self.name,))

    def _bind(self, frame, path):
        object.__setattr__(self, "_frame", frame)
        object.__setattr__(self, "_path", path)
        for f in dataclasses.fields(self):
            if f.name in ("name", "parent"):
                continue
            val = getattr(self, f.name)
            if isinstance(val, Module) and val.parent is None:
                object.__setattr__(self, f.name, dataclasses.replace(
                    val, parent=self, name=f.name))

    def _adopt(self, attr, val):
        if isinstance(val, Module):
            if val.parent is None:
                val = dataclasses.replace(val, parent=None)
                object.__setattr__(val, "parent", self)
            if val.parent is self and val.name is None:
                object.__setattr__(val, "name", attr)
                val._bind(self._frame, self._path + (attr,))
            return val
        if isinstance(val, (list, tuple)):
            return type(val)(self._adopt(f"{attr}_{i}", v)
                             for i, v in enumerate(val))
        if isinstance(val, dict):
            return {k: self._adopt(f"{attr}_{k}", v) for k, v in val.items()}
        return val

    def __setattr__(self, name, val):
        if self.__dict__.get("_in_setup"):
            val = self._adopt(name, val)
        object.__setattr__(self, name, val)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        self._try_setup()
        if name in self.__dict__:
            return self.__dict__[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def _try_setup(self):
        if (self.__dict__.get("_frame") is None or self._setup_done
                or self._in_setup):
            return
        object.__setattr__(self, "_in_setup", True)
        _STACK.append(self)
        try:
            self.setup()
        finally:
            _STACK.pop()
            object.__setattr__(self, "_in_setup", False)
            object.__setattr__(self, "_setup_done", True)
            object.__setattr__(self, "_cursor", {})

    def setup(self):
        pass

    # -- variables and RNGs ----------------------------------------------------
    def _require_frame(self):
        if self.__dict__.get("_frame") is None:
            raise ValueError(
                f"{type(self).__name__} is not bound: call it through "
                "init() or apply()")
        return self._frame

    def param(self, name: str, init_fn: Callable, *init_args, **init_kwargs):
        frame = self._require_frame()
        if frame.has("params", self._path, name):
            return frame.get("params", self._path, name)
        if not frame.is_mutable("params"):
            raise ValueError(
                f"parameter '{'/'.join(self._path + (name,))}' is missing")
        value = init_fn(self.make_rng("params"), *init_args, **init_kwargs)
        frame.put("params", self._path, name, value)
        return value

    def variable(self, col: str, name: str, init_fn=None, *init_args,
                 **init_kwargs) -> Variable:
        frame = self._require_frame()
        if not frame.has(col, self._path, name):
            if not frame.is_mutable(col) or init_fn is None:
                raise ValueError(
                    f"variable '{col}:{'/'.join(self._path + (name,))}' is "
                    "missing and its collection is not mutable")
            frame.put(col, self._path, name, init_fn(*init_args,
                                                     **init_kwargs))
        return Variable(frame, col, self._path, name)

    def make_rng(self, name: str = "params"):
        frame = self._require_frame()
        if name not in frame.rngs:
            if "params" not in frame.rngs:
                raise ValueError(
                    f"{'/'.join(self._path) or type(self).__name__} needs "
                    f"an RNG for '{name}'")
            name = "params"
        key = (self._path, name)
        frame.counters[key] = count = frame.counters.get(key, 0) + 1
        return _fold_in_static(frame.rngs[name], self._path + (count,))

    def is_initializing(self) -> bool:
        return self._require_frame().initializing

    # -- entry points ----------------------------------------------------------
    def _run(self, frame, method, args, kwargs):
        top = dataclasses.replace(self, parent=None)
        top._bind(frame, ())
        if method is None:
            method = type(top).__call__
        elif isinstance(method, str):
            method = getattr(type(top), method)
        return method(top, *args, **kwargs)

    def init(self, rngs, *args, method=None, mutable=True, **kwargs):
        """Create every variable the call touches; returns the collections
        as nested dicts."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        frame = _Frame({}, rngs, mutable, initializing=True)
        self._run(frame, method, args, kwargs)
        return frame.mutated()

    def apply(self, variables, *args, rngs=None, method=None, mutable=False,
              **kwargs):
        """Run `method` (default `__call__`) with `variables`; with
        `mutable`, also return the updated mutable collections."""
        frame = _Frame(variables, rngs or {}, mutable, initializing=False)
        y = self._run(frame, method, args, kwargs)
        if not mutable:
            return y
        return y, frame.mutated()


def remat(module_cls, static_argnums: Sequence[int] = ()):
    """`module_cls` whose call is rematerialized under autodiff
    (jax.checkpoint). `static_argnums` count the module itself as 0."""
    inner_call = module_cls.__call__

    def __call__(self, *args):
        frame = self._frame
        if frame is None or frame.is_mutable("params"):
            return inner_call(self, *args)
        path = self._path
        static = {i - 1 for i in static_argnums}
        dyn_pos = [i for i in range(len(args)) if i not in static]
        cols = {c: frame.subtree(c, path) for c in frame.variables}
        cols = {c: v for c, v in cols.items() if v is not None}

        def pure(cols_in, rngs, dyn):
            saved_cols = {c: frame.subtree(c, path) for c in cols_in}
            saved_rngs = frame.rngs
            for c, tree in cols_in.items():
                frame.set_subtree(c, path, _copy_dicts(tree))
            frame.rngs = rngs
            full = list(args)
            for i, a in zip(dyn_pos, dyn):
                full[i] = a
            try:
                y = inner_call(self, *full)
                out = {c: frame.subtree(c, path) for c in cols_in
                       if frame.is_mutable(c)}
            finally:
                for c, tree in saved_cols.items():
                    frame.set_subtree(c, path, tree)
                frame.rngs = saved_rngs
            return y, out

        y, out = jax.checkpoint(pure)(cols, frame.rngs,
                                      [args[i] for i in dyn_pos])
        for c, tree in out.items():
            frame.set_subtree(c, path, tree)
        return y

    __call__.nowrap = True
    return type(f"Checkpoint{module_cls.__name__}", (module_cls,),
                {"__call__": __call__, "__module__": module_cls.__module__})


# ---- layers ------------------------------------------------------------------

def _promote(*args, dtype=None):
    if dtype is None:
        dtype = jnp.result_type(*[a for a in args if a is not None])
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


_lecun_normal = initializers.lecun_normal()
_zeros = initializers.zeros


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = _lecun_normal
    bias_init: Callable = _zeros

    @compact
    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(inputs)[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias,
                                        dtype=self.dtype)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())),
                            precision=self.precision)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class _DenseParams(Module):
    """The kernel and bias of a Dense, created but not applied."""

    features: int
    use_bias: bool = True
    param_dtype: Any = jnp.float32
    kernel_init: Callable = _lecun_normal
    bias_init: Callable = _zeros

    @compact
    def __call__(self, inputs):
        k = self.param("kernel", self.kernel_init,
                       (inputs.shape[-1], self.features), self.param_dtype)
        b = (self.param("bias", self.bias_init, (self.features,),
                        self.param_dtype) if self.use_bias else None)
        return k, b


class Conv(Module):
    """Channels-last convolution with one batch dimension."""

    features: int
    kernel_size: Sequence[int]
    strides: Any = 1
    padding: Any = "SAME"
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = _lecun_normal
    bias_init: Callable = _zeros

    @compact
    def __call__(self, inputs):
        kernel_size = ((self.kernel_size,) if isinstance(self.kernel_size, int)
                       else tuple(self.kernel_size))
        n = len(kernel_size)
        strides = ((self.strides,) * n if isinstance(self.strides, int)
                   else tuple(self.strides))
        padding = (self.padding if isinstance(self.padding, str)
                   else tuple(tuple(p) for p in self.padding))
        if inputs.ndim != n + 2:
            raise ValueError("Conv expects [batch, *spatial, features]")
        nd = inputs.ndim
        lhs = (0, nd - 1) + tuple(range(1, nd - 1))
        dims = lax.ConvDimensionNumbers(
            lhs, (nd - 1, nd - 2) + tuple(range(0, nd - 2)), lhs)
        kernel = self.param("kernel", self.kernel_init,
                            kernel_size + (inputs.shape[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias,
                                        dtype=self.dtype)
        y = lax.conv_general_dilated(
            inputs, kernel, strides, padding, lhs_dilation=(1,) * n,
            rhs_dilation=(1,) * n, dimension_numbers=dims,
            feature_group_count=1, precision=self.precision)
        if bias is not None:
            y += bias.reshape((1,) * (y.ndim - 1) + bias.shape)
        return y


class LayerNorm(Module):
    """Normalization over the last axis (flax's fast-variance form:
    statistics in at least float32, var = E[x^2] - E[x]^2 clipped at 0)."""

    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = _zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x):
        stat_dtype = jnp.promote_types(
            self.dtype if self.dtype is not None else jnp.result_type(x),
            jnp.float32)
        xf = x.astype(stat_dtype)
        mu = xf.mean(-1)
        mu2 = lax.square(xf).mean(-1)
        var = jnp.maximum(0.0, mu2 - lax.square(mu))
        feat = (x.shape[-1],)
        shape = (1,) * (x.ndim - 1) + feat
        y = x - jnp.expand_dims(mu, -1)
        mul = lax.rsqrt(jnp.expand_dims(var, -1) + self.epsilon)
        args = [x]
        if self.use_scale:
            scale = self.param("scale", self.scale_init, feat,
                               self.param_dtype).reshape(shape)
            mul *= scale
            args.append(scale)
        y *= mul
        if self.use_bias:
            bias = self.param("bias", self.bias_init, feat,
                              self.param_dtype).reshape(shape)
            y += bias
            args.append(bias)
        out_dtype = (self.dtype if self.dtype is not None
                     else jnp.result_type(*args))
        return jnp.asarray(y, out_dtype)


class Dropout(Module):
    rate: float
    broadcast_dims: Sequence[int] = ()
    deterministic: Optional[bool] = None
    rng_collection: str = "dropout"

    @compact
    def __call__(self, inputs, deterministic: Optional[bool] = None,
                 rng=None):
        if deterministic is None:
            deterministic = self.deterministic
        if deterministic is None:
            raise ValueError("Dropout needs `deterministic`")
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep_prob = 1.0 - self.rate
        if rng is None:
            rng = self.make_rng(self.rng_collection)
        shape = list(inputs.shape)
        for d in self.broadcast_dims:
            shape[d] = 1
        mask = jax.random.bernoulli(rng, p=keep_prob, shape=shape)
        mask = jnp.broadcast_to(mask, inputs.shape)
        return lax.select(mask, inputs / keep_prob, jnp.zeros_like(inputs))


# ---- recurrent layers --------------------------------------------------------

class OptimizedLSTMCell(Module):
    """LSTM cell; one matmul per stream over the concatenated gate
    kernels, parameters named like flax's (`ii`..`io`, `hi`..`ho`)."""

    features: int
    gate_fn: Callable = jax.nn.sigmoid
    activation_fn: Callable = jnp.tanh
    kernel_init: Callable = _lecun_normal
    recurrent_kernel_init: Callable = initializers.orthogonal()
    bias_init: Callable = _zeros
    param_dtype: Any = jnp.float32
    carry_init: Callable = _zeros

    @compact
    def __call__(self, carry, inputs):
        c, h = carry
        hidden = h.shape[-1]
        p_i, p_h = {}, {}
        for comp in "ifgo":
            p_i[comp] = _DenseParams(hidden, use_bias=False,
                                     param_dtype=self.param_dtype,
                                     kernel_init=self.kernel_init,
                                     bias_init=self.bias_init,
                                     name=f"i{comp}")(inputs)
            p_h[comp] = _DenseParams(hidden, use_bias=True,
                                     param_dtype=self.param_dtype,
                                     kernel_init=self.recurrent_kernel_init,
                                     bias_init=self.bias_init,
                                     name=f"h{comp}")(h)

        def concat_dense(x, params, use_bias):
            kernels = [k for k, _ in params.values()]
            kernel = jnp.concatenate(kernels, axis=-1)
            bias = (jnp.concatenate([b for _, b in params.values()], -1)
                    if use_bias else None)
            x, kernel, bias = _promote(x, kernel, bias)
            y = jnp.dot(x, kernel)
            if use_bias:
                y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
            split = np.cumsum([k.shape[-1] for k in kernels[:-1]])
            return dict(zip(params.keys(), jnp.split(y, split, axis=-1)))

        dh = concat_dense(h, p_h, True)
        di = concat_dense(inputs, p_i, False)
        i = self.gate_fn(dh["i"] + di["i"])
        f = self.gate_fn(dh["f"] + di["f"])
        g = self.activation_fn(dh["g"] + di["g"])
        o = self.gate_fn(dh["o"] + di["o"])
        new_c = f * c + i * g
        new_h = o * self.activation_fn(new_c)
        return (new_c, new_h), new_h

    @nowrap
    def initialize_carry(self, rng, input_shape):
        k1, k2 = jax.random.split(rng)
        shape = tuple(input_shape[:-1]) + (self.features,)
        return (self.carry_init(k1, shape, self.param_dtype),
                self.carry_init(k2, shape, self.param_dtype))


class GRUCell(Module):
    features: int
    gate_fn: Callable = jax.nn.sigmoid
    activation_fn: Callable = jnp.tanh
    kernel_init: Callable = _lecun_normal
    recurrent_kernel_init: Callable = initializers.orthogonal()
    bias_init: Callable = _zeros
    param_dtype: Any = jnp.float32
    carry_init: Callable = _zeros

    @compact
    def __call__(self, carry, inputs):
        h = carry
        hidden = h.shape[-1]
        dense_h = functools.partial(
            Dense, features=hidden, use_bias=False,
            param_dtype=self.param_dtype,
            kernel_init=self.recurrent_kernel_init, bias_init=self.bias_init)
        dense_i = functools.partial(
            Dense, features=hidden, use_bias=True,
            param_dtype=self.param_dtype, kernel_init=self.kernel_init,
            bias_init=self.bias_init)
        r = self.gate_fn(dense_i(name="ir")(inputs) + dense_h(name="hr")(h))
        z = self.gate_fn(dense_i(name="iz")(inputs) + dense_h(name="hz")(h))
        n = self.activation_fn(
            dense_i(name="in")(inputs)
            + r * dense_h(name="hn", use_bias=True)(h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h

    @nowrap
    def initialize_carry(self, rng, input_shape):
        shape = tuple(input_shape[:-1]) + (self.features,)
        return self.carry_init(rng, shape, self.param_dtype)


class SimpleCell(Module):
    features: int
    activation_fn: Callable = jnp.tanh
    kernel_init: Callable = _lecun_normal
    recurrent_kernel_init: Callable = initializers.orthogonal()
    bias_init: Callable = _zeros
    param_dtype: Any = jnp.float32
    carry_init: Callable = _zeros

    @compact
    def __call__(self, carry, inputs):
        hidden = carry.shape[-1]
        new = (Dense(hidden, use_bias=True, param_dtype=self.param_dtype,
                     kernel_init=self.kernel_init, bias_init=self.bias_init,
                     name="i")(inputs)
               + Dense(hidden, use_bias=False, param_dtype=self.param_dtype,
                       kernel_init=self.recurrent_kernel_init,
                       name="h")(carry))
        new = self.activation_fn(new)
        return new, new

    @nowrap
    def initialize_carry(self, rng, input_shape):
        shape = tuple(input_shape[:-1]) + (self.features,)
        return self.carry_init(rng, shape, self.param_dtype)


def _flip_sequences(inputs, seq_lengths, time_axis):
    max_steps = inputs.shape[time_axis]
    if seq_lengths is None:
        return jnp.flip(inputs, axis=time_axis)
    idxs = jnp.arange(max_steps - 1, -1, -1).reshape(
        (1,) * time_axis + (max_steps,))
    idxs = (idxs + jnp.expand_dims(seq_lengths, time_axis)) % max_steps
    idxs = idxs.reshape(idxs.shape + (1,) * (inputs.ndim - idxs.ndim))
    return jnp.take_along_axis(inputs, idxs, axis=time_axis)


class RNN(Module):
    """Runs `cell` over the time axis (axis -2, batch-major) with
    lax.scan; the cell's parameters are shared by every step."""

    cell: Module
    return_carry: bool = False
    reverse: bool = False
    keep_order: bool = False

    def __call__(self, inputs, *, initial_carry=None, init_key=None,
                 seq_lengths=None, return_carry=None, reverse=None,
                 keep_order=None):
        return_carry = (self.return_carry if return_carry is None
                        else return_carry)
        reverse = self.reverse if reverse is None else reverse
        keep_order = self.keep_order if keep_order is None else keep_order
        t_axis = inputs.ndim - 2
        if reverse:
            inputs = _flip_sequences(inputs, seq_lengths, t_axis)
        if initial_carry is None:
            key = init_key if init_key is not None else jax.random.PRNGKey(0)
            carry = self.cell.initialize_carry(
                key, inputs.shape[:t_axis] + inputs.shape[t_axis + 1:])
        else:
            carry = initial_carry
        xs = jnp.moveaxis(inputs, t_axis, 0)
        if self.cell._frame.is_mutable("params"):
            self.cell(carry, xs[0])     # create the shared parameters
        slice_carry = seq_lengths is not None and return_carry

        def step(c, x):
            c, y = self.cell(c, x)
            return c, ((c, y) if slice_carry else y)

        carry, ys = lax.scan(step, carry, xs)
        if slice_carry:
            carries, ys = ys
            last = seq_lengths - 1
            carry = jax.tree_util.tree_map(
                lambda a: a[last, jnp.arange(a.shape[1])], carries)
        outputs = jnp.moveaxis(ys, 0, t_axis)
        if reverse and keep_order:
            outputs = _flip_sequences(outputs, seq_lengths, t_axis)
        return (carry, outputs) if return_carry else outputs


class Bidirectional(Module):
    forward_rnn: Module
    backward_rnn: Module
    return_carry: bool = False

    def __call__(self, inputs, *, initial_carry=None, init_key=None,
                 seq_lengths=None, return_carry=None):
        return_carry = (self.return_carry if return_carry is None
                        else return_carry)
        if init_key is not None:
            k_f, k_b = jax.random.split(init_key)
        else:
            k_f = k_b = None
        c_f0, c_b0 = (initial_carry if initial_carry is not None
                      else (None, None))
        c_f, out_f = self.forward_rnn(
            inputs, initial_carry=c_f0, init_key=k_f,
            seq_lengths=seq_lengths, return_carry=True, reverse=False)
        c_b, out_b = self.backward_rnn(
            inputs, initial_carry=c_b0, init_key=k_b,
            seq_lengths=seq_lengths, return_carry=True, reverse=True,
            keep_order=True)
        out = jnp.concatenate([out_f, out_b], axis=-1)
        return ((c_f, c_b), out) if return_carry else out
