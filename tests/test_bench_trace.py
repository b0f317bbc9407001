"""bench.py's device tables and trace reduction.

tests/data/gpu_trace.xplane.pb is a trace of three steps of a small
program (row gather, matmul, sorted scatter-add, tanh) recorded on an
NVIDIA H100 by scripts/record_gpu_trace.py.
"""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "data", "gpu_trace.xplane.pb")
KERNELS = {"gemm_fusion_dot_general_1", "input_scatter_fusion",
           "loop_broadcast_fusion", "wrapped_gather", "wrapped_tanh"}


def test_peak_table_has_the_h100():
    kind = "NVIDIA H100 80GB HBM3"
    assert bench.device_peaks(kind)["hbm"] == 3.35e12
    assert bench.step_peak_flops(kind, amp=True) == 989e12
    assert bench.step_peak_flops(kind, amp=False) == 495e12


@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no peak rates"):
        bench.device_peaks(kind)


def test_fixture_kernels_and_step_time():
    events = bench.device_kernel_events(FIXTURE)
    assert {name for name, _, _ in events} == KERNELS
    assert len(events) == 3 * len(KERNELS)
    breakdown = bench.kernel_breakdown(FIXTURE)
    assert {k: c for k, (_, c) in breakdown.items()} == {k: 3 for k in KERNELS}
    total = sum(dur for _, _, dur in events)
    step = bench.device_step_ms(FIXTURE, 3)
    assert 0 < step * 3 * 1e6 <= total
    assert step == pytest.approx(bench.busy_ns(events) / 3e6)


def test_fixture_kernel_classes():
    classes = {bench.kernel_class(k) for k in KERNELS}
    assert classes == {"matmul", "scatter", "gather", "other"}
    assert bench.kernel_class("wrapped_gather") == "gather"
    assert bench.kernel_class("input_scatter_fusion") == "scatter"


@pytest.mark.parametrize("events,busy", [
    ([("a", 0, 10), ("b", 5, 10)], 15),          # overlap
    ([("a", 0, 10), ("b", 20, 5)], 15),          # gap
    ([("a", 0, 30), ("b", 5, 10)], 30),          # nested
    ([], 0),
])
def test_busy_ns_is_the_union(events, busy):
    assert bench.busy_ns(events) == busy


def test_cpu_trace_has_no_gpu_kernels(tmp_path):
    f = jax.jit(lambda x: jnp.tanh(x @ x))
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    with pytest.raises(RuntimeError, match="no GPU kernel"):
        bench.device_step_ms(str(tmp_path), 1)


def test_hlo_instruction_bytes_counts_shapes():
    f = jax.jit(lambda t, i, u: jnp.zeros((64, 8)).at[i].add(u) + t)
    hlo = f.lower(jnp.ones((64, 8)), jnp.zeros((128,), jnp.int32),
                  jnp.ones((128, 8))).compile().as_text()
    sizes = bench.hlo_instruction_bytes(hlo)
    assert sizes and all(v >= 0 for v in sizes.values())
    # some instruction reads the 128x8 f32 updates and the 128 indices
    assert max(sizes.values()) >= 128 * 8 * 4 + 128 * 4
