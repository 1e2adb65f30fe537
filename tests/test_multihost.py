"""True multi-process (multi-host-shaped) evaluation.

The reference is single-host shared-memory only (rayon; SURVEY.md §2);
this build scales across hosts with one JAX process per host over
jax.distributed (parallel/distributed.py). A real cluster needs real
hosts, but the multi-controller runtime itself is fully exercisable on
CPU: two OS processes, 4 virtual devices each, gloo collectives — the
same program that runs across GPU hosts. This is the runtime counterpart of the
single-process virtual-mesh tests in test_sharding.py.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two_process(mode: str) -> dict:
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coordinator, "2", str(pid), mode],
            cwd=_REPO,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        # generous hang guard: the workers take ~30 s idle but a
        # concurrent keygen/compile on the 4 vCPUs stretched one
        # full-suite run past 540 s (round 5) — the limit exists to
        # catch collective deadlocks, not load
        out, _ = p.communicate(timeout=1500)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    results = {}
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("MULTIHOST_RESULT ")]
        assert lines, f"no result line in:\n{out[-3000:]}"
        r = json.loads(lines[-1].split(" ", 1)[1])
        results[r["pid"]] = r

    assert set(results) == {0, 1}
    for r in results.values():
        assert r["devices"] == 8  # global mesh spans both processes
        assert r["oracle_ok"]
    # both controllers computed identical decrypted results
    assert results[0]["outputs"] == results[1]["outputs"]
    return results[0]["outputs"]


def test_two_process_gate_sharded_adder():
    outputs = _run_two_process("gates")
    # 1 + 3 + 1 = 5: sum[0]=1, sum[1]=0, cout=1
    assert outputs == {"cout": True, "sum[0]": True, "sum[1]": False}


def test_two_process_arith_dataflow_chi_squared():
    """The arith dataflow scheduler's merged radix launches, sharded over a
    2-process global mesh (chi-squared u8, n0=3 n1=5 n2=7)."""
    outputs = _run_two_process("arith")
    n0, n1, n2 = 3, 5, 7
    assert outputs["alpha"] == ((4 * n0 * n2 - n1 * n1) ** 2) % 256
    assert outputs["beta1"] == (2 * (2 * n0 + n1) ** 2) % 256
