"""Analytic reference-bound model (helm_tpu/refbound.py).

The bounds restate the reference's own execution model: one bootstrap per
boolean gate, rayon-parallel within a level, sequential across levels
(reference src/circuit.rs:524-548, src/gates.rs:255-271)."""

from helm_tpu.circuit.graph import Circuit
from helm_tpu.circuit.verilog import read_verilog_file
from helm_tpu.refbound import (
    bounds_for_netlist,
    level_bootstrap_profile,
    reference_bounds,
)


def test_profile_counts_only_bootstrap_gates():
    # 2-bit adder: 10 gates, all 2-input boolean (the reference's sort
    # test counts the same 10 ordered gates, tests/circuit_test.rs:18-45)
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    c = Circuit.from_netlist(nl)
    prof = level_bootstrap_profile(c)
    assert sum(prof) == 10
    assert all(b >= 0 for b in prof)


def test_bounds_arithmetic():
    prof = [3, 130, 0, 1]  # 0-bootstrap level is free (linear-only)
    rb = reference_bounds(prof, cores=64, t_bootstrap_s=0.010)
    assert rb["pbs_levels"] == 3
    assert rb["bootstraps"] == 134
    assert rb["infinite_core_floor_s"] == 0.03  # 3 PBS levels x 10 ms
    # width-capped: ceil(3/64)+ceil(130/64)+ceil(1/64) = 1+3+1 = 5 steps
    assert rb["core_bound_s"] == 0.05
    # cycles scale both bounds linearly
    rb2 = reference_bounds(prof, cores=64, cycles=3)
    assert rb2["infinite_core_floor_s"] == 0.09
    assert rb2["bootstraps"] == 402


def test_radix_op_costs_floor_model():
    from helm_tpu.circuit.gates import GateType
    from helm_tpu.refbound import radix_op_costs

    # u32 = 16 two-bit blocks (reference bin/helm.rs:81-88)
    assert radix_op_costs(GateType.ADD, 32, plain=False) == (16, 1)
    assert radix_op_costs(GateType.ADD, 32, plain=True) == (16, 1)
    assert radix_op_costs(GateType.MULT, 32, plain=False) == (256, 2)
    assert radix_op_costs(GateType.MULT, 32, plain=True) == (16, 1)
    # encrypted division: width sequential shift-subtract iterations
    assert radix_op_costs(GateType.DIV, 32, plain=False) == (32 * 16, 32)
    assert radix_op_costs(GateType.DIV, 32, plain=True) == (16, 1)
    # encrypted-amount shift: log2(width) barrel stages
    assert radix_op_costs(GateType.SHL, 32, plain=False) == (16 * 5, 5)
    assert radix_op_costs(GateType.SHR, 32, plain=True) == (0, 0)
    assert radix_op_costs(GateType.COPY, 32, plain=False) == (0, 0)


def test_arith_reference_bounds_chi_squared():
    from helm_tpu.refbound import arith_level_profile, arith_reference_bounds

    nl = read_verilog_file("benchmarks/netlists/chi_squared_arith.v", True)
    c = Circuit.from_netlist(nl)
    rb = arith_reference_bounds(c, 32, cores=64)
    prof = arith_level_profile(c, 32)
    # structure restated: floor sums the per-level max rounds; the core
    # bound can never go below it
    assert rb["infinite_core_floor_s"] <= rb["core_bound_s"]
    assert rb["bootstraps"] == sum(w for w, _ in prof)
    assert rb["bootstraps"] > 0
    # chi-squared has ct*ct multiplies: work must reflect nb^2 terms
    assert any(w >= 256 for w, _ in prof)
    assert "tfhe-rs radix floor" in rb["model"]


def test_floor_never_exceeds_core_bound():
    for name in ("c880-like", "aes128-gates", "s27", "8-bit-adder-lut-3-1"):
        rb = bounds_for_netlist(f"benchmarks/netlists/{name}.v")
        assert rb["infinite_core_floor_s"] <= rb["core_bound_s"] + 1e-9, name


def test_aes_profile_matches_recorded_shape():
    # aes128-gates: 358 levels, ~40.6k bootstraps
    rb = bounds_for_netlist("benchmarks/netlists/aes128-gates.v")
    assert rb["pbs_levels"] == 358
    assert 40_000 <= rb["bootstraps"] <= 41_000
    assert rb["infinite_core_floor_s"] == 3.58
