"""Subprocess bodies for tests/test_sharding.py.

Every case compiles a pjit program over a virtual multi-device CPU mesh.
Three different full-suite runs segfaulted inside XLA:CPU's native
`backend_compile_and_load` on exactly these compiles when they executed
~30-45 min into a long-lived pytest process (faulthandler-pinned twice,
round 4; private compilation-cache dirs did NOT prevent it) — while
every case passes clean in a fresh process, every time. The mesh
compiles therefore run here, one fresh process per case.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from helm_tpu import params as P  # noqa: E402
from helm_tpu.circuit.graph import Circuit  # noqa: E402
from helm_tpu.circuit.verilog import read_verilog_file  # noqa: E402
from helm_tpu.engines.boolean import BooleanEngine  # noqa: E402
from helm_tpu.parallel.mesh import shard_engine  # noqa: E402


def case_sharded_adder_matches_oracle():
    nl = read_verilog_file("benchmarks/netlists/8-bit-adder.v")
    e = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=77)
    mesh = shard_engine(e, 8)
    assert mesh.size == 8
    e.compile(nl)
    a, b, cin = 173, 201, 1
    inputs = {f"a[{i}]": bool(a >> i & 1) for i in range(8)}
    inputs |= {f"b[{i}]": bool(b >> i & 1) for i in range(8)}
    inputs["cin"] = bool(cin)
    wires = e.evaluate(e.encrypt_inputs(inputs))
    out = e.decrypt_outputs(wires)
    got = sum(int(out[f"sum[{i}]"]) << i for i in range(8)) + (
        int(out["cout"]) << 8
    )
    assert got == a + b + cin
    c = Circuit.from_netlist(
        read_verilog_file("benchmarks/netlists/8-bit-adder.v")
    )
    exp = c.evaluate(c.initialize_wire_map(nl.wire_set, inputs))
    dec = e.decrypt_all_wires(wires)
    for w, v in exp.items():
        assert dec[w] == v, w


def case_sharded_matches_unsharded():
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    inputs = {
        "a[0]": True, "a[1]": False, "b[0]": True, "b[1]": True,
        "cin": False,
    }
    e1 = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=13)
    e1.compile(nl)
    out1 = e1.decrypt_outputs(e1.evaluate(e1.encrypt_inputs(inputs)))
    e2 = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=13)
    shard_engine(e2, 4)
    e2.compile(nl)
    out2 = e2.decrypt_outputs(e2.evaluate(e2.encrypt_inputs(inputs)))
    assert out1 == out2


def _sharded_vs_single(mode, pset, netlist, n_dev, fuse_levels=None):
    nl = read_verilog_file(netlist)
    rng = np.random.default_rng(13)
    inputs = {w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)}
    e1 = BooleanEngine(mode=mode, params=pset, seed=13)
    e1.compile(nl)
    out1 = e1.decrypt_outputs(e1.evaluate(e1.encrypt_inputs(inputs)))
    e2 = BooleanEngine(
        mode=mode, params=pset, seed=13, fuse_levels=fuse_levels
    )
    shard_engine(e2, n_dev)
    e2.compile(nl)
    out2 = e2.decrypt_outputs(e2.evaluate(e2.encrypt_inputs(inputs)))
    assert out1 == out2
    c = Circuit.from_netlist(read_verilog_file(netlist))
    exp = c.evaluate(c.initialize_wire_map(nl.wire_set, inputs))
    for w, v in out2.items():
        assert v == (bool(exp[w]) if mode == "gates" else int(exp[w])), w


def case_sharded_multibit_matches_unsharded():
    _sharded_vs_single(
        "gates", P.TEST_PARAMS_MB, "benchmarks/netlists/2-bit-adder.v", 4
    )


def case_sharded_lut_matches_unsharded():
    _sharded_vs_single(
        "lut", P.TEST_PARAMS_LUT_MB,
        "benchmarks/netlists/8-bit-adder-lut-3-1.v", 4,
    )


def case_sharded_fused_levels():
    _sharded_vs_single(
        "gates", P.TEST_PARAMS_MB, "benchmarks/netlists/2-bit-adder.v", 8,
        fuse_levels=True,
    )


def case_chip_smoke_mesh_phase():
    import tempfile

    import chip_smoke

    with tempfile.TemporaryDirectory() as d:
        keys_dir = os.path.join(d, "keys")
        keys = chip_smoke.make_keys(keys_dir, [P.TEST_PARAMS], 5)
        res = chip_smoke.phase_mesh(
            keys[P.TEST_PARAMS.name], keys_dir, d, seed=5, n_dev=4,
            batch=4, extra=["--test-params"],
        )
    assert res["mesh_s"] > 0 and res["single_s"] > 0


def case_sharded_arith_matches_oracle():
    from helm_tpu.engines.arith import ArithEngine
    from helm_tpu.parallel.mesh import (
        batch_sharding,
        make_gate_mesh,
        replicated,
    )

    nl = read_verilog_file("benchmarks/netlists/chi_squared_arith.v", True)
    e = ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=44)
    mesh = make_gate_mesh(4)
    e.set_sharding(batch_sharding(mesh), replicated(mesh))
    try:
        e.compile(nl)
        inputs = {"n0": 3, "n1": 5, "n2": 7}
        out = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(inputs)))
        c = Circuit.from_netlist(
            read_verilog_file("benchmarks/netlists/chi_squared_arith.v", True)
        )
        exp = c.evaluate_arith(
            c.initialize_wire_map(nl.wire_set, inputs, default=0), 8
        )
        for w in ("alpha", "beta1", "beta2", "beta3"):
            assert out[w] == exp[w], (w, out[w], exp[w])
    finally:
        from helm_tpu.engines import radix

        radix.BATCH_SHARD[0] = None


def main() -> int:
    case = sys.argv[1]
    globals()[f"case_{case}"]()
    print(f"SHARDING_CASE_OK {case}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
