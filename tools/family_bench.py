"""One-stop gates/LUT family benchmark (RUNNING.md matrix).

Times gates and LUT mode, single vectors, batches and multi-cycle
sequential circuits, and prints a machine-parseable RESULT json line per
job. Matches the reference's published family surface (reference
RUNNING.md:3-259).

Env:
  NETLIST  path (default benchmarks/netlists/c880-like.v)
  NETLISTS space-separated `path[:batch[:cycles]]` entries — runs them
           all in ONE process (keygen/key-transfer/jit caches shared;
           cuts the per-family process overhead ~5x for the RUNNING.md
           sweep). Overrides NETLIST/BATCH/CYCLES.
  MODE     gates|lut (default gates)
  PSET     params name (default GATES_128_K3 / LUT_128_K2 by mode)
  FUSE     1/0 level fusion (unset = auto)
  BATCH    vectors per serving pass (0 = single vector, latency shape)
  CYCLES   sequential cycles (default 1)
  CYCFUSE  1 = all cycles in one dispatch (engine.evaluate_cycles)
  SEED     input RNG seed (default 7)
"""
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from helm_tpu.compile_cache import enable_compile_cache

enable_compile_cache()
import numpy as np

from helm_tpu import params as P
from helm_tpu.circuit.graph import Circuit
from helm_tpu.circuit.verilog import read_verilog_file
from helm_tpu.device import describe
from helm_tpu.engines.boolean import BooleanEngine

mode = os.environ.get("MODE", "gates")
pset = getattr(
    P,
    os.environ.get("PSET", "GATES_128_K3" if mode == "gates" else "LUT_128_K2"),
)
fuse_env = os.environ.get("FUSE", "")

if os.environ.get("NETLISTS", ""):
    jobs = []
    for ent in os.environ["NETLISTS"].split():
        parts = ent.split(":")
        jobs.append(
            (
                parts[0],
                int(parts[1]) if len(parts) > 1 else 0,
                int(parts[2]) if len(parts) > 2 else 1,
            )
        )
else:
    jobs = [
        (
            os.environ.get("NETLIST", "benchmarks/netlists/c880-like.v"),
            int(os.environ.get("BATCH", "0")),
            int(os.environ.get("CYCLES", "1")),
        )
    ]

t0 = time.time()
e = BooleanEngine(
    mode=mode,
    params=pset,
    seed=3,
    fuse_levels=bool(int(fuse_env)) if fuse_env else None,
)
print(f"KeyGen {time.time()-t0:.1f}s", flush=True)

rng = np.random.default_rng(int(os.environ.get("SEED", "7")))

for path, B, cycles in jobs:
    nl = read_verilog_file(path)
    e.compile(nl)

    def vec():
        return {w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)}

    inputs = [vec() for _ in range(B)] if B else vec()

    # CYCFUSE=1: all cycles in ONE dispatch (engine.evaluate_cycles) —
    # per-cycle times then report the amortized dt/cycles.
    cycfuse = bool(int(os.environ.get("CYCFUSE", "0"))) and cycles > 1

    # first pass: compile + warmup (all cycles share the level executables)
    wires = e.encrypt_inputs(inputs)
    t0 = time.time()
    if cycfuse:
        wires = e.evaluate_cycles(wires, cycles)
    else:
        for _ in range(cycles):
            wires = e.evaluate(wires)
    _ = np.asarray(wires)
    first = time.time() - t0
    print(f"first eval (incl. compile): {first:.1f}s", flush=True)

    wires = e.encrypt_inputs(inputs)
    cyc_t = []
    t_all = time.time()
    if cycfuse:
        wires = e.evaluate_cycles(wires, cycles)
        _ = np.asarray(wires)
        dt = time.time() - t_all
        cyc_t = [dt / cycles] * cycles
    else:
        for _c in range(cycles):
            t0 = time.time()
            wires = e.evaluate(wires)
            _ = np.asarray(wires)
            cyc_t.append(time.time() - t0)
        dt = time.time() - t_all

    # oracle check over all cycles (stateful for sequential circuits)
    c = Circuit.from_netlist(read_verilog_file(path))
    got = e.decrypt_all_wires(wires)
    ok = True
    if B:
        states = [c.initialize_wire_map(nl.wire_set, iv) for iv in inputs]
        for _c in range(cycles):
            states = [c.evaluate(s) for s in states]
        for bi, st in enumerate(states):
            for w, v in st.items():
                if got[bi][w] != v:
                    ok = False
    else:
        state = c.initialize_wire_map(nl.wire_set, inputs)
        for _c in range(cycles):
            state = c.evaluate(state)
        for w, v in state.items():
            if got[w] != v:
                ok = False

    # analytic reference bounds from the level profile (helm_tpu/refbound.py):
    # the reference cannot evaluate one vector faster than its critical-path
    # floor at ANY core count, nor faster than the width-capped C-core bound
    # at perfect scaling (reference src/circuit.rs:524-548 level loop)
    from helm_tpu.refbound import level_bootstrap_profile, reference_bounds

    rb = reference_bounds(
        level_bootstrap_profile(c),
        cores=int(os.environ.get("REF_CORES", "64")),
        cycles=cycles,
    )
    pv = dt / (B or 1)

    name = pathlib.Path(path).stem
    print(
        f"{name} steady-state: {dt:.3f}s"
        + (f" ({dt/B:.3f}s/vector, batch {B})" if B else "")
        + (f" cycles={cycles} per-cycle={[round(t,3) for t in cyc_t]}" if cycles > 1 else "")
        + f" [{pset.name}, {mode}] correct={ok}",
        flush=True,
    )
    print(
        "RESULT "
        + json.dumps(
            {
                "device": describe(),
                "family": name,
                "mode": mode,
                "params": pset.name,
                "batch": B,
                "cycles": cycles,
                "cycfuse": cycfuse,
                "steady_s": round(dt, 3),
                "per_vector_s": round(dt / (B or 1), 3),
                "per_cycle_s": [round(t, 3) for t in cyc_t],
                "first_s": round(first, 1),
                "correct": ok,
                # reference bounds: per-vector measured vs (a) the
                # infinite-core critical-path floor and (b) the C-core
                # perfect-scaling bound; ratios >1 mean this device beats
                # that reference machine on per-vector wall-clock
                "ref_infinite_core_floor_s": rb["infinite_core_floor_s"],
                "ref_core_bound_s": rb["core_bound_s"],
                "ref_cores": rb["cores"],
                "ref_bootstraps": rb["bootstraps"],
                "vs_ref_floor": round(rb["infinite_core_floor_s"] / pv, 3),
                "vs_ref_cores": round(rb["core_bound_s"] / pv, 3),
            }
        ),
        flush=True,
    )
