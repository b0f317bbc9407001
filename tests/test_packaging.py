"""Packaging metadata (pyproject.toml).

`pip install -e . --no-build-isolation` + `scm-train --help` was
verified manually (zero-egress rigs need --no-build-isolation since
build deps can't be fetched); these tests keep the metadata honest
without invoking pip: every declared console script must resolve to an
importable callable, every declared package must exist on disk (and
vice versa), and the native .so package-data file must be present.
"""

import importlib
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _meta():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def test_console_scripts_resolve():
    meta = _meta()
    scripts = meta["project"]["scripts"]
    assert set(scripts) == {"scm-train", "scm-evaluate", "unc-train",
                            "unc-transform", "unc-evaluate"}
    for target in scripts.values():
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn))


def test_declared_packages_match_disk():
    meta = _meta()
    declared = set(meta["tool"]["setuptools"]["packages"])
    on_disk = {"dualmessagepassing_tpu"} | {
        f"dualmessagepassing_tpu.{p.name}"
        for p in (ROOT / "dualmessagepassing_tpu").iterdir()
        if p.is_dir() and (p / "__init__.py").exists()}
    assert declared == on_disk, (declared ^ on_disk)


def test_native_so_is_package_data():
    meta = _meta()
    pd = meta["tool"]["setuptools"]["package-data"]["dualmessagepassing_tpu"]
    assert "_hostkernels.so" in pd
    assert (ROOT / "dualmessagepassing_tpu" / "_hostkernels.so").exists()


def test_dependencies_are_jax_optax_numpy():
    """The module layer and the checkpoints are in-repo: no flax or orbax
    on the install path; sklearn stays in the offline-eval extra."""
    meta = _meta()
    names = {d.split(">")[0].split("=")[0].split("[")[0].strip()
             for d in meta["project"]["dependencies"]}
    assert names == {"jax", "optax", "numpy"}
    assert any(d.startswith("scikit-learn")
               for d in meta["project"]["optional-dependencies"]["eval"])
