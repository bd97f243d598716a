import os
import sys
from pathlib import Path

import pytest

# src layout import without install
SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# NOTE: no xla_force_host_platform_device_count here — unit/smoke tests run
# on the single real device; multi-device tests spawn subprocesses that set
# the flag before importing jax (see tests/test_dist_small.py).

_ACCELERATORS = ("tpu", "gpu", "cuda", "rocm")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running stress/property test; excluded from the fast tier "
        "(scripts/run_tier1.sh runs -m 'not slow' by default, --full opts in)",
    )
    config.addinivalue_line(
        "markers",
        "device: requires a real accelerator backend (TPU/GPU); "
        "auto-skipped when JAX only sees the CPU",
    )
    config.addinivalue_line(
        "markers",
        "cuda: runs a hand-written CUDA kernel of repro_torch on the card; "
        "skipped where torch sees no CUDA device",
    )


def pytest_collection_modifyitems(config, items):
    if not any(item.get_closest_marker("device") for item in items):
        return
    import jax  # deferred: only pay the import when device tests are collected

    if jax.default_backend() in _ACCELERATORS:
        return
    skip = pytest.mark.skip(
        reason=f"device marker: JAX backend is '{jax.default_backend()}', "
        "no accelerator available"
    )
    for item in items:
        if item.get_closest_marker("device"):
            item.add_marker(skip)
