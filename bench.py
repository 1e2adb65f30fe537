#!/usr/bin/env python3
"""Benchmark: gate bootstraps/sec on one GPU at production gates parameters.

Prints JSON lines; the primary metric {"metric", "value", "unit",
"vs_baseline", ...} is the LAST line. Every line names the device it ran
on (JAX's platform, device kind and count, and nvidia-smi's card name and
power limit). Without a GPU it exits nonzero: there is no CPU fallback.

Default parameter set: GATES_128_K3 — the ≥100-bit-core-SVP (≈128-bit
lattice-estimator-equivalent) gates family, i.e. the same security class
as the reference's flagship CPU gates mode (tfhe-rs boolean defaults,
reference src/bin/helm.rs:241). BENCH_PARAMS=GATES_TPU_MB2 benches the
reference-GPU-mirroring weak set (src/bin/helm.rs:141-146) instead.

Baseline anchor: the reference evaluates gates with tfhe-rs CPU gate
bootstraps (~10 ms each single-threaded on a server core; rayon-parallel
across cores — reference circuit.rs:531). The repo publishes no numbers
and Rust/network are unavailable in this image to measure it, so the
anchor is a documented estimate generous to the baseline: 64 cores x
~100 bootstraps/s = 6400 bootstraps/s at PERFECT scaling on a large host.
tools/baseline_cpu/ pins the full reproduction recipe (tfhe-rs 0.4.1,
the reference's exact hot loop) that replaces this with a measurement on
any host with Rust + network — see BASELINE.md "Anchor status".
"""

import json
import os
import sys
import time

HELM_CPU_BASELINE_BS_PER_SEC = 6400.0
REPO = os.path.dirname(os.path.abspath(__file__))


def _emit(rec: dict, device: dict) -> None:
    print(json.dumps({**rec, "device": device}), flush=True)


def _bench_circuit_latency(p, ck, sk, device):
    """c880-like single-vector wall-clock vs the analytic reference bounds.

    Reuses the bench keys (same parameter set); evaluates the fused-level
    program once for compile + median-of-5 timed runs, oracle-checked."""
    import pathlib

    import numpy as np

    from helm_tpu.circuit.graph import Circuit
    from helm_tpu.circuit.verilog import read_verilog_file
    from helm_tpu.engines.boolean import BooleanEngine
    from helm_tpu.refbound import level_bootstrap_profile, reference_bounds

    path = os.environ.get("BENCH_NETLIST", "benchmarks/netlists/c880-like.v")
    nl = read_verilog_file(path)
    eng = BooleanEngine(mode="gates", params=p, keys=(ck, sk))
    eng.compile(nl)
    rng = np.random.default_rng(11)
    inputs = {w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)}
    t0 = time.perf_counter()
    eng.evaluate(eng.encrypt_inputs(inputs)).block_until_ready()
    setup = time.perf_counter() - t0
    times = []
    for _ in range(5):
        w0 = eng.encrypt_inputs(inputs)
        t0 = time.perf_counter()
        wires = eng.evaluate(w0).block_until_ready()
        times.append(time.perf_counter() - t0)
    c = Circuit.from_netlist(read_verilog_file(path))
    exp = c.evaluate(c.initialize_wire_map(nl.wire_set, inputs))
    got = eng.decrypt_outputs(wires)
    if any(got[w] != bool(exp[w]) for w in got):
        raise SystemExit("bench: circuit outputs differ from the oracle")
    rb = reference_bounds(level_bootstrap_profile(c))
    value = float(np.median(times))
    _emit({
        "metric": f"{pathlib.Path(path).stem}_wall_clock_per_vector",
        "value": value,
        "unit": "s",
        # >1 = faster than an infinite-core reference host on one vector
        "vs_baseline": rb["infinite_core_floor_s"] / value,
        "ref_infinite_core_floor_s": rb["infinite_core_floor_s"],
        "ref_core_bound_s": rb["core_bound_s"],
        "ref_cores": rb["cores"],
        "ref_bootstraps": rb["bootstraps"],
        "bounds_model": "10ms/bootstrap; levels sequential (circuit.rs:524)",
        "windows": times,
        "setup_compile_and_first_run_s": setup,
    }, device)


def main():
    os.chdir(REPO)
    from helm_tpu.device import card_info, require_gpu

    device = {**require_gpu("bench.py"), "card": card_info()}

    import numpy as np

    import jax
    import jax.numpy as jnp

    from helm_tpu import params as P
    from helm_tpu.compile_cache import enable_compile_cache
    from helm_tpu.fhe import lwe, pbs_jnp
    from helm_tpu.fhe.keys import load_or_generate

    enable_compile_cache()
    G = int(os.environ.get("BENCH_BATCH", "1024"))
    iters = int(os.environ.get("BENCH_ITERS", "8"))
    p = getattr(P, os.environ.get("BENCH_PARAMS", "GATES_128_K3"))

    t = time.perf_counter()
    ck, sk = load_or_generate(os.path.join(REPO, ".keys"), p, seed=2024)
    print(f"[bench] keys {time.perf_counter() - t:.1f}s", file=sys.stderr)
    dsk = pbs_jnp.DeviceServerKey.from_host(sk)

    rng = np.random.default_rng(0)
    bits1 = rng.integers(0, 2, G).astype(bool)
    bits2 = rng.integers(0, 2, G).astype(bool)
    lin = (lwe.encrypt(ck, lwe.encode_bool(bits1)) + lwe.encrypt(ck, lwe.encode_bool(bits2))).astype(np.uint32)
    lin[:, p.n] += np.uint32((-(1 << 29)) % (1 << 32))
    testv = jnp.asarray(pbs_jnp.gates_test_poly(p))
    x = jnp.asarray(lin)

    t = time.perf_counter()
    bs = jax.jit(pbs_jnp.bootstrap).lower(dsk, x, testv).compile()
    compile_s = time.perf_counter() - t
    out = bs(dsk, x, testv)

    # correctness spot check before timing
    got = lwe.decode_bool(lwe.decrypt_phase(ck, np.asarray(out)))
    if not (got == (bits1 & bits2)).all():
        raise SystemExit("bench: bootstrap outputs wrong — not benchmarking")

    # median of N timing windows (not best-run)
    nwin = max(1, int(os.environ.get("BENCH_MEDIAN_N", "5")))
    rates = []
    for w in range(nwin):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = bs(dsk, x, testv)
        out.block_until_ready()
        rates.append(G * iters / (time.perf_counter() - t0))
        print(f"[bench] window {w+1}/{nwin}: {rates[-1]:.1f} bs/s", file=sys.stderr)

    # Second metric (printed BEFORE the primary so the primary stays the
    # last line): per-circuit wall-clock vs the analytic reference bounds
    # from the level profile (helm_tpu/refbound.py).
    if os.environ.get("BENCH_CIRCUIT", "1") != "0":
        _bench_circuit_latency(p, ck, sk, device)

    value = float(np.median(rates))
    _emit({
        "metric": "gate_bootstraps_per_sec_per_chip",
        "value": value,
        "unit": "bootstraps/s",
        "vs_baseline": value / HELM_CPU_BASELINE_BS_PER_SEC,
        "params": p.name,
        "batch": G,
        "median_of": nwin,
        "windows": rates,
        "setup_compile_s": compile_s,
        "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"
        ),
    }, device)


if __name__ == "__main__":
    sys.exit(main())
