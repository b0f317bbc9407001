"""ctypes loader for the native host kernels (csrc/hostkernels.cpp).

Compiles the shared object on first use (g++ -O3) into the package build
directory and exposes typed wrappers. Every entry point has a numpy
fallback in its call site (data/subiso.py, unc/data.py), so a missing
compiler degrades gracefully to pure Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "hostkernels.cpp")
_SO = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "_hostkernels.so")

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SRC):
        return None
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        # build under a private name and rename into place, so concurrent
        # processes never load a half-written library
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
    lib = ctypes.CDLL(_SO)
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    lib.enumerate_subiso.restype = i64
    lib.enumerate_subiso.argtypes = [
        i64, i64, i64, _i64p, _i64p, _i64p,
        i64, _i64p, _i64p, _i64p, _i64p, _i64p,
        i64, ctypes.c_void_p]
    lib.edge_subiso_weights.restype = None
    lib.edge_subiso_weights.argtypes = [
        i64, _i64p, _i64p, _i64p,
        i64, _i64p, _i64p, _i64p, i64,
        i64, i64, _i64p, _i64p]
    lib.sample_in_edges.restype = i64
    lib.sample_in_edges.argtypes = [
        _i64p, _i64p, i64, _i64p, i64, u64, _i64p]
    lib.random_walks.restype = None
    lib.random_walks.argtypes = [
        _i64p, _i64p, i64, _i64p, i64, i64, u64, _i64p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        with _LOCK:
            if _LIB is None and not _TRIED:
                _LIB = _build()
                _TRIED = True
    return _LIB


def available() -> bool:
    return get_lib() is not None


# =============================================================================
# typed wrappers
# =============================================================================

def enumerate_subiso_native(p_src, p_dst, p_el, p_vl,
                            g_src, g_dst, g_el, g_vl,
                            max_count: int = 1_000_000):
    lib = get_lib()
    if lib is None:
        return None
    n_p, n_g = len(p_vl), len(g_vl)
    args = [np.ascontiguousarray(x, np.int64)
            for x in (p_src, p_dst, p_el, g_src, g_dst, g_el, p_vl, g_vl)]
    p_src, p_dst, p_el, g_src, g_dst, g_el, p_vl, g_vl = args
    # first pass: count
    n = lib.enumerate_subiso(n_p, n_g, len(p_src), p_src, p_dst, p_el,
                             len(g_src), g_src, g_dst, g_el, p_vl, g_vl,
                             max_count, None)
    out = np.zeros((n, n_p), np.int64)
    if n:
        lib.enumerate_subiso(n_p, n_g, len(p_src), p_src, p_dst, p_el,
                             len(g_src), g_src, g_dst, g_el, p_vl, g_vl,
                             n, out.ctypes.data_as(ctypes.c_void_p))
    return out


def edge_subiso_weights_native(p_src, p_dst, p_el, g_src, g_dst, g_el,
                               num_g_nodes: int, mappings):
    lib = get_lib()
    if lib is None:
        return None
    args = [np.ascontiguousarray(x, np.int64)
            for x in (p_src, p_dst, p_el, g_src, g_dst, g_el)]
    p_src, p_dst, p_el, g_src, g_dst, g_el = args
    mappings = np.ascontiguousarray(mappings, np.int64)
    out = np.zeros(len(g_src), np.int64)
    if mappings.size and len(p_src):
        lib.edge_subiso_weights(
            len(p_src), p_src, p_dst, p_el,
            len(g_src), g_src, g_dst, g_el, num_g_nodes,
            mappings.shape[0], mappings.shape[1], mappings, out)
    return out


def sample_in_edges_native(in_ptr, in_order, nodes, width: int, seed: int):
    lib = get_lib()
    if lib is None:
        return None
    in_ptr = np.ascontiguousarray(in_ptr, np.int64)
    in_order = np.ascontiguousarray(in_order, np.int64)
    nodes = np.ascontiguousarray(nodes, np.int64)
    out = np.zeros(len(nodes) * width, np.int64)
    n = lib.sample_in_edges(in_ptr, in_order, len(nodes), nodes, width,
                            seed, out)
    return out[:n]


def random_walks_native(out_ptr, out_order_dst, seeds, depth: int,
                        reps: int, seed: int):
    lib = get_lib()
    if lib is None:
        return None
    out_ptr = np.ascontiguousarray(out_ptr, np.int64)
    out_order_dst = np.ascontiguousarray(out_order_dst, np.int64)
    seeds = np.ascontiguousarray(seeds, np.int64)
    out = np.full((reps, len(seeds), depth + 1), -1, np.int64)
    lib.random_walks(out_ptr, out_order_dst, len(seeds), seeds, depth,
                     reps, seed, out.reshape(-1))
    return out
