#!/usr/bin/env python3
"""Replay ALL FIVE BASELINE configs end-to-end against recorded vectors.

One command proves every driver-pinned config bit-exact at production
(128-bit-class) parameters (BASELINE.md; reference pattern:
tests/circuit_test.rs:315-474 recorded chi-squared CSV sets):

  1. 2-bit-adder        gates mode, recorded input + golden output CSV
  2. s27 x3 cycles      sequential gates, golden output CSV
  3. 8-bit-adder-lut-3-1 LUT mode, golden output CSV
  4. chi_squared u32    arith mode, 4 recorded input/output CSV sets
  5. c880-like          gates mode, recorded input + golden output CSV

Golden CSVs live in benchmarks/test-cases/ and are oracle-derived
(helm_tpu.circuit.graph.Circuit.evaluate — itself pinned against gate
truth tables and the reference's semantics); the real hdl-benchmarks
vectors are not vendored upstream either (git submodule, not checked out).

Usage:
  python tools/verify_baseline.py              # default device, 128-bit params
  python tools/verify_baseline.py --fast       # CPU, noise-free test params
  python tools/verify_baseline.py --only c880  # one config

Exit code 0 iff every decrypted output matches its golden CSV bit-exactly.
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from helm_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np


def check(name, got: dict, golden_csv: str, typ: str) -> bool:
    from helm_tpu.io import csv_io

    exp = csv_io.read_input_wires(golden_csv, typ)
    bad = {
        w: (got.get(w), v)
        for w, v in exp.items()
        if (bool(got.get(w)) if typ == "bool" else int(got.get(w, -1)))
        != (bool(v) if typ == "bool" else int(v))
    }
    if bad:
        print(f"[!] {name}: MISMATCH {bad}")
        return False
    print(f"[✓] {name}: {len(exp)} output wires bit-exact")
    return True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="CPU + test params")
    ap.add_argument("--only", default="", help="substring filter")
    args = ap.parse_args()
    if args.fast:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from helm_tpu import params as P
    from helm_tpu.circuit.verilog import read_verilog_file
    from helm_tpu.engines.arith import ArithEngine
    from helm_tpu.engines.boolean import BooleanEngine
    from helm_tpu.io import csv_io

    gates_p = P.TEST_PARAMS if args.fast else P.GATES_128_K3
    lut_p = P.TEST_PARAMS_LUT if args.fast else P.LUT_128_MB2
    arith_p = P.TEST_PARAMS_ARITH if args.fast else P.ARITH_128_MB2
    ok = True
    tc = "benchmarks/test-cases"
    nlp = "benchmarks/netlists"

    def gates_cfg(name, netlist, inputs_csv, golden_csv, mode, params, cycles=1):
        nonlocal ok
        if args.only and args.only not in name:
            return
        t0 = time.time()
        nl = read_verilog_file(netlist)
        eng = BooleanEngine(mode=mode, params=params, seed=5)
        eng.compile(nl)
        ins = csv_io.read_input_wires(inputs_csv, "bool")
        wires = eng.encrypt_inputs(ins)
        for _ in range(cycles):
            wires = eng.evaluate(wires)
        out = eng.decrypt_outputs(wires)
        ok &= check(name, out, golden_csv, "bool")
        print(f"    ({params.name}, {time.time()-t0:.1f}s)")

    gates_cfg(
        "2-bit-adder (gates)", f"{nlp}/2-bit-adder.v",
        f"{tc}/2-bit-adder.inputs.csv", f"{tc}/2-bit-adder.outputs.csv",
        "gates", gates_p,
    )
    gates_cfg(
        "s27 x3 (sequential gates)", f"{nlp}/s27.v",
        f"{tc}/s27.inputs.csv", f"{tc}/s27_3cycles.outputs.csv",
        "gates", gates_p, cycles=3,
    )
    gates_cfg(
        "8-bit-adder-lut-3-1 (LUTs)", f"{nlp}/8-bit-adder-lut-3-1.v",
        f"{tc}/8-bit-adder.inputs.csv", f"{tc}/8-bit-adder-lut-3-1.outputs.csv",
        "lut", lut_p,
    )
    gates_cfg(
        "c880-like (gates)", f"{nlp}/c880-like.v",
        f"{tc}/c880-like.inputs.csv", f"{tc}/c880-like.outputs.csv",
        "gates", gates_p,
    )

    if not args.only or args.only in "chi_squared (arith u32)":
        t0 = time.time()
        nl = read_verilog_file(f"{nlp}/chi_squared_arith.v", True)
        eng = ArithEngine("u32", params=arith_p, seed=5)
        eng.compile(nl)
        for i in (1, 2, 3, 4):
            ins = csv_io.read_input_wires(f"{tc}/chi_squared_arith_{i}.inputs.csv", "u32")
            wires = eng.encrypt_inputs(ins)
            wires = eng.evaluate(wires)
            out = eng.decrypt_outputs(wires)
            ok &= check(
                f"chi_squared u32 set {i}", out,
                f"{tc}/chi_squared_arith_{i}.outputs.csv", "u32",
            )
        print(f"    ({arith_p.name}, {time.time()-t0:.1f}s)")

    print("ALL BIT-EXACT" if ok else "FAILURES — see above")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
