"""chip_smoke.py on the CPU: its phases at tiny sizes, and its refusal to
run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_single_device_phases_tiny():
    dev = jax.devices()
    chip_smoke.run_single(chip_smoke.TINY, dev[0], dev[1])


def test_four_device_phases_tiny():
    chip_smoke.run_multi(chip_smoke.TINY, jax.devices()[:4])


@pytest.mark.parametrize("got,want,ok", [
    ([1.0, 2.0], [1.0, 2.0], True),
    ([1.0, 2.05], [1.0, 2.0], True),
    ([1.0, 2.5], [1.0, 2.0], False),
])
def test_check_tol(got, want, ok):
    import numpy as np

    if ok:
        chip_smoke.check_tol("x", np.asarray(got), np.asarray(want), 0.1, "t")
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_tol("x", np.asarray(got), np.asarray(want), 0.1,
                                 "t")


def test_last_line_is_the_device_json(monkeypatch, capsys):
    """main() ends with the one-line JSON naming the device; the phases
    themselves are stubbed here (they run above at tiny sizes)."""
    class FakeDev:
        platform, device_kind, id = "gpu", "NVIDIA H100 80GB HBM3", 0

        def memory_stats(self):
            return {}

    monkeypatch.setattr(jax, "devices",
                        lambda *a: [FakeDev()] if not a else [FakeDev()])
    monkeypatch.setattr(chip_smoke, "run_single", lambda *a: None)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
