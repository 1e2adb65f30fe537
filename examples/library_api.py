#!/usr/bin/env python3
"""Library-API walkthrough: everything the CLI does, as Python calls.

Run: JAX_PLATFORMS=cpu python examples/library_api.py   (CPU, tiny test
parameters; without JAX_PLATFORMS it runs on JAX's default device, the GPU)

Covers the client/server split explicitly:
  client: keygen, encrypt inputs, decrypt outputs
  server: compile netlist, evaluate encrypted wires (never sees the
          client key — only the ServerKey / its device form)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from helm_tpu import params as P  # noqa: E402
from helm_tpu.circuit.graph import Circuit  # noqa: E402
from helm_tpu.circuit.verilog import read_verilog_file  # noqa: E402
from helm_tpu.engines.arith import ArithEngine  # noqa: E402
from helm_tpu.engines.boolean import BooleanEngine  # noqa: E402


def gates_mode():
    """Boolean circuit: one gate bootstrap per gate, one launch per level."""
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    # production: params=None -> GATES_128_K3 (≥100-bit core-SVP). Weak
    # reference-mirroring sets (P.GATES_PARAMS etc.) print a security
    # warning when selected.
    engine = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=7)
    engine.compile(nl)

    inputs = {"a[0]": True, "a[1]": False, "b[0]": True, "b[1]": True, "cin": False}
    wires = engine.encrypt_inputs(inputs)          # client
    wires = engine.evaluate(wires)                 # server
    outputs = engine.decrypt_outputs(wires)        # client
    # cross-check against the plaintext oracle
    c = Circuit.from_netlist(nl)
    expected = c.evaluate(c.initialize_wire_map(nl.wire_set, inputs))
    assert all(bool(expected[w]) == bool(v) for w, v in outputs.items())
    print("gates:", dict(sorted(outputs.items())))


def lut_mode_sequential():
    """LUT cells + a DFF state loop evaluated for several cycles."""
    nl = read_verilog_file("benchmarks/netlists/s27.v")
    engine = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=8)
    engine.compile(nl)
    inputs = {"G0": True, "G1": False, "G2": True, "G3": False}
    wires = engine.encrypt_inputs(inputs)
    for _cycle in range(3):
        wires = engine.evaluate(wires)
    print("s27 after 3 cycles:", engine.decrypt_outputs(wires))


def arith_mode():
    """Radix integers; ops merge into batched PBS rounds (dataflow)."""
    nl = read_verilog_file("benchmarks/netlists/chi_squared_arith.v", True)
    engine = ArithEngine("u16", params=P.TEST_PARAMS_ARITH, seed=9)
    engine.compile(nl)
    inputs = {"n0": 10, "n1": 20, "n2": 30}
    outputs = engine.decrypt_outputs(engine.evaluate(engine.encrypt_inputs(inputs)))
    assert outputs["alpha"] == ((4 * 10 * 30 - 20 * 20) ** 2) % 2**16
    print("chi-squared u16:", outputs)


def batched_serving():
    """The production shape: V independent input vectors in ONE pass."""
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    engine = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=10)
    engine.compile(nl)
    rng = np.random.default_rng(0)
    vecs = [
        {w: bool(rng.integers(0, 2)) for w in nl.inputs} for _ in range(4)
    ]
    outs = engine.decrypt_outputs(engine.evaluate(engine.encrypt_inputs(vecs)))
    print("batched serving:", len(outs), "vectors in one pass")


def radix_ops_direct():
    """RadixOps as a library (no netlist): encrypted integer arithmetic."""
    import jax.numpy as jnp

    e = ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=11)
    x = jnp.asarray(np.stack([e._encrypt_value(v) for v in (17, 200)]))
    y = jnp.asarray(np.stack([e._encrypt_value(v) for v in (5, 99)]))
    s = e.ops.add(x, y)
    q = e.ops.div_plain(x, 3)
    print(
        "radix direct:",
        [e._decrypt_value(np.asarray(s[i])) for i in range(2)],
        [e._decrypt_value(np.asarray(q[i])) for i in range(2)],
    )


if __name__ == "__main__":
    gates_mode()
    lut_mode_sequential()
    arith_mode()
    batched_serving()
    radix_ops_direct()
    print("all examples OK")
