"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Mirrors the reference's CI strategy (cargo test on CPU; see SURVEY.md §4):
every kernel has a CPU-exact path, and multi-device sharding is validated
on virtual devices. Tests that need an NVIDIA GPU carry the `gpu` marker
and take the `gpu_card` fixture, which skips them where there is none;
`python chip_smoke.py` runs the same checks on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

# Persistent compilation cache: OFF for tests. A long-lived XLA:CPU test
# process segfaulted in the cache's native write path, and a per-run
# throwaway directory caches nothing across runs anyway.
# HELM_TPU_COMPILE_CACHE="" is the off switch (helm_tpu/compile_cache.py).
if "HELM_TPU_COMPILE_CACHE" not in os.environ:
    os.environ["HELM_TPU_COMPILE_CACHE"] = ""
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import faulthandler  # noqa: E402

# dump native tracebacks on SIGSEGV/SIGABRT so a crash inside XLA pins
# the crashing frame instead of dying silently
faulthandler.enable(all_threads=True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_card():
    """nvidia-smi's card line, or a skip where no NVIDIA GPU is present."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    if res.returncode != 0 or not res.stdout.strip():
        pytest.skip("no NVIDIA GPU: nvidia-smi lists no card")
    return res.stdout.strip()


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running (real parameter sets)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m", default=None):
        return
    skip = pytest.mark.skip(reason="slow: run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
