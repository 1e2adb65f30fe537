"""Multi-chip gate sharding on the virtual 8-device CPU mesh.

Each mesh-compiling case runs in a FRESH subprocess
(tests/_sharding_worker.py): three full-suite runs segfaulted inside
XLA:CPU's native `backend_compile_and_load` on exactly these compiles
when they executed ~30-45 min into a long-lived pytest process
(faulthandler-pinned, round 4; a private compilation-cache dir did not
prevent it), while every case passes clean in a fresh process every
time. Subprocess isolation keeps the coverage and removes the
suite-killing crash.
"""

import os
import subprocess
import sys

import jax
import pytest

_WORKER = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "_sharding_worker.py"
)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_case(case: str, timeout: float = 1200) -> None:
    res = subprocess.run(
        [sys.executable, _WORKER, case],
        capture_output=True,
        text=True,
        timeout=timeout,
        cwd=_REPO,
    )
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert f"SHARDING_CASE_OK {case}" in res.stdout


def test_virtual_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_adder_matches_oracle():
    """8-device GSPMD gate sharding vs the oracle on every wire."""
    _run_case("sharded_adder_matches_oracle")


def test_sharded_matches_unsharded():
    _run_case("sharded_matches_unsharded")


@pytest.mark.parametrize(
    "case",
    ["sharded_multibit_matches_unsharded", "sharded_lut_matches_unsharded"],
    ids=["multi-bit", "lut"],
)
def test_sharded_geometry_matches_unsharded(case):
    """Gate sharding over 4 devices: the multi-bit blind rotation and
    the LUT mode's per-slot test polynomials."""
    _run_case(case)


def test_sharded_fused_levels():
    """Sharded PBS + whole-circuit lax.scan fusion in one program."""
    _run_case("sharded_fused_levels")


def test_chip_smoke_mesh_phase():
    """chip_smoke.py's --four-cards phase at test parameters on 4 virtual
    devices: mesh and single-device CLI runs against the oracle and
    against each other."""
    _run_case("chip_smoke_mesh_phase")


def test_sharded_arith_matches_oracle():
    """Dataflow radix scheduler with every PBS batch sharded on the
    gate axis, vs the arith oracle."""
    _run_case("sharded_arith_matches_oracle")


def test_multihost_flag_parsing():
    from helm_tpu.parallel.distributed import parse_multihost_flag

    assert parse_multihost_flag("10.0.0.1:8476,4,2") == ("10.0.0.1:8476", 4, 2)
    with pytest.raises(ValueError):
        parse_multihost_flag("bad")
