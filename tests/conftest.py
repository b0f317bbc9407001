"""Test configuration: force an 8-device virtual CPU mesh.

XLA_FLAGS must be set before jax is imported, and the platform is pinned
with jax.config.update afterwards (before any backend initialization), so
the tests run on the CPU whatever accelerator the machine has. Tests that
need a GPU are run by chip_smoke.py on the card, not by pytest.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# f32 matmuls at full precision on every backend: golden tests compare at 1e-4.
jax.config.update("jax_default_matmul_precision", "highest")
# Entry points called in-process point the persistent compilation cache at
# the checkout; test workers compile concurrently and must leave no entries.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "regression: pinned-metric regression tests (test_regression.py)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
