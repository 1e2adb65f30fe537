#!/usr/bin/env python3
"""Smoke run of encrypted circuit evaluation on an NVIDIA GPU.

    python chip_smoke.py [--seed N]     # phases 1-5 on one GPU
    python chip_smoke.py --four-cards   # phase 6 only: gate sharding, 4 GPUs

Everything runs in this one process, through the entry points a user
calls (`helm_tpu.cli.main`, `helm_tpu.serve.main`), at the default
128-bit parameter sets:

1. device: what JAX and nvidia-smi report; no GPU is an error.
2. PBS: `jax.jit(pbs_jnp.bootstrap)` at the three PBS geometries of the
   main path, its compile times, its rate at GATES_128_K3 with G = 1024,
   its decrypted outputs, and its ciphertexts against the same function
   on the CPU, bit for bit.
3. CLI: the five golden configurations against benchmarks/test-cases/.
4. CLI: AES-128 in gates mode against FIPS-197 C.1.
5. serving: the daemon on c880-like, two batches of 16 against the oracle.
6. (--four-cards) c880-like at batch 16 with --mesh 4 and without, both
   against the oracle and against each other, bit for bit.

All arithmetic is exact integer arithmetic, so every comparison has
tolerance zero. Keys are generated once per parameter set into .keys/
and reused through --keys. The last line of stdout is one JSON object;
any failed check exits nonzero before it is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KEYS_DIR = os.path.join(REPO, ".keys")
WORK_DIR = os.path.join(REPO, ".smoke")
NL = "benchmarks/netlists"
TC = "benchmarks/test-cases"
AES_CT = "69c4e0d86a7b0430d8cdb78070b4c55a"  # FIPS-197 appendix C.1

#: name, CLI arguments, golden output CSVs, plaintext type
GOLDEN = (
    ("2-bit-adder",
     ["-v", f"{NL}/2-bit-adder.v", "-i", f"{TC}/2-bit-adder.inputs.csv"],
     [f"{TC}/2-bit-adder.outputs.csv"], "bool"),
    ("s27, 3 cycles",
     ["-v", f"{NL}/s27.v", "-i", f"{TC}/s27.inputs.csv", "-c", "3"],
     [f"{TC}/s27_3cycles.outputs.csv"], "bool"),
    ("8-bit-adder-lut-3-1",
     ["-v", f"{NL}/8-bit-adder-lut-3-1.v",
      "-i", f"{TC}/8-bit-adder.inputs.csv"],
     [f"{TC}/8-bit-adder-lut-3-1.outputs.csv"], "bool"),
    ("chi_squared u32",
     ["-v", f"{NL}/chi_squared_arith.v", "-a", "u32", "-I",
      *[f"{TC}/chi_squared_arith_{i}.inputs.csv" for i in (1, 2, 3, 4)]],
     [f"{TC}/chi_squared_arith_{i}.outputs.csv" for i in (1, 2, 3, 4)],
     "u32"),
    ("c880-like",
     ["-v", f"{NL}/c880-like.v", "-i", f"{TC}/c880-like.inputs.csv"],
     [f"{TC}/c880-like.outputs.csv"], "bool"),
)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def peak_memory(dev=None):
    """peak_bytes_in_use of `dev` (default: device 0) over the process."""
    import jax

    stats = (dev or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


# ----------------------------------------------------------------------
# keys
# ----------------------------------------------------------------------


def make_keys(keys_dir: str, params_list, seed: int) -> dict:
    """Load or generate (client, server) keys once per parameter set."""
    from helm_tpu.fhe.keys import load_or_generate

    keys = {}
    for p in params_list:
        t0 = time.perf_counter()
        keys[p.name] = load_or_generate(keys_dir, p, seed)
        say(f"keys {p.name}: {time.perf_counter() - t0:.1f} s"
            f" (load or generate+save, {keys_dir})")
    return keys


# ----------------------------------------------------------------------
# phase 2: the jitted PBS against the same function on the CPU
# ----------------------------------------------------------------------


def pbs_inputs(p, ck, G: int, rng, lut: bool):
    """G gate inputs with their test polynomials and expected messages."""
    import numpy as np

    from helm_tpu.fhe import lwe, pbs_jnp

    if not lut:  # AND of two encrypted bits: c1 + c2 - q/8
        b1 = rng.integers(0, 2, G).astype(bool)
        b2 = rng.integers(0, 2, G).astype(bool)
        x = lwe.encrypt(ck, lwe.encode_bool(b1)) + lwe.encrypt(
            ck, lwe.encode_bool(b2)
        )
        x[:, p.n] += np.uint32((-(1 << 29)) % (1 << 32))
        return x.astype(np.uint32), pbs_jnp.gates_test_poly(p), b1 & b2
    # one random table per gate (the LUT mode's per-slot test polys)
    half = p.msg_space // 2
    m = rng.integers(0, half, G)
    tables = rng.integers(0, p.msg_space, (G, half)).astype(np.uint64)
    x = lwe.encrypt(ck, lwe.encode_msg(p, m))
    return x, pbs_jnp.lut_test_poly(p, tables), tables[np.arange(G), m]


def _decode(p, ck, out, lut: bool):
    from helm_tpu.fhe import lwe

    ph = lwe.decrypt_phase(ck, out)
    return lwe.decode_msg(p, ph) if lut else lwe.decode_bool(ph)


def phase_pbs(p, keys, G: int, cpu_rows: int, seed: int, lut: bool = False,
              windows: int = 0, window_s: float = 2.0) -> dict:
    """Compile, time and check the jitted bootstrap at `p` on the default
    device; compare its first `cpu_rows` outputs with the CPU's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from helm_tpu.fhe import pbs_jnp

    ck, sk = keys
    rng = np.random.default_rng(seed)
    x_host, tv_host, expect = pbs_inputs(p, ck, G, rng, lut)
    dsk = pbs_jnp.DeviceServerKey.from_host(sk)
    x, tv = jnp.asarray(x_host), jnp.asarray(tv_host)
    res = {"params": p.name, "G": G}

    t0 = time.perf_counter()
    bs = jax.jit(pbs_jnp.bootstrap).lower(dsk, x, tv).compile()
    res["compile_s"] = time.perf_counter() - t0
    jax.clear_caches()
    t0 = time.perf_counter()
    jax.jit(pbs_jnp.bootstrap).lower(dsk, x, tv).compile()
    res["compile_again_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = bs(dsk, x, tv).block_until_ready()
    res["first_call_s"] = time.perf_counter() - t0
    if windows:
        iters = max(1, round(window_s / max(res["first_call_s"], 1e-6)))
        rates = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(iters):
                o = bs(dsk, x, tv)
            o.block_until_ready()
            rates.append(G * iters / (time.perf_counter() - t0))
        res["bootstraps_per_s"] = float(np.median(rates))
        res["windows"] = rates
        res["iters_per_window"] = iters
    res["peak_bytes_in_use"] = peak_memory()

    out = np.asarray(out)
    got = _decode(p, ck, out, lut)
    bad = int((got != expect).sum())
    check(bad == 0, f"{p.name}: {bad} of {G} bootstraps decrypt wrong")

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        dsk_c = pbs_jnp.DeviceServerKey.from_host(sk)
        tv_c = tv_host if tv_host.shape[0] == 1 else tv_host[:cpu_rows]
        t0 = time.perf_counter()
        ref = np.asarray(
            jax.jit(pbs_jnp.bootstrap)(
                dsk_c, jnp.asarray(x_host[:cpu_rows]), jnp.asarray(tv_c)
            )
        )
        res["cpu_s"] = time.perf_counter() - t0
    diff = int((ref != out[:cpu_rows]).any(axis=-1).sum())
    check(diff == 0, f"{p.name}: {diff} of {cpu_rows} ciphertexts differ "
          "from the CPU's")
    say(f"pbs {p.name} G={G}: compile {res['compile_s']:.2f} s, compile "
        f"after clear_caches {res['compile_again_s']:.2f} s, first call "
        f"{res['first_call_s']:.3f} s; all {G} outputs decrypt right; "
        f"first {cpu_rows} ciphertexts equal the CPU's bit for bit "
        f"(CPU compile+run {res['cpu_s']:.1f} s)")
    if windows:
        say(f"pbs {p.name} G={G}: {res['bootstraps_per_s']} bootstraps/s, "
            f"median of {windows} windows of {res['iters_per_window']} "
            f"calls: {res['windows']}")
    say(f"pbs {p.name}: peak device memory {res['peak_bytes_in_use']} bytes")
    return res


# ----------------------------------------------------------------------
# phases 3-4: the CLI
# ----------------------------------------------------------------------


def _same_wires(out_csv: str, golden_csv: str, typ: str) -> str | None:
    """None when out_csv holds exactly golden_csv's wires and values."""
    from helm_tpu.io import csv_io

    got = csv_io.read_input_wires(out_csv, typ)
    exp = csv_io.read_input_wires(golden_csv, typ)
    if got != exp:
        bad = sorted(w for w in exp.keys() | got.keys()
                     if got.get(w) != exp.get(w))
        return f"{len(bad)} wires differ, e.g. {bad[:5]}"
    return None


def run_cli(argv: list[str]) -> float:
    from helm_tpu import cli

    t0 = time.perf_counter()
    rc = cli.main(argv)
    check(rc == 0, f"cli {' '.join(argv)} returned {rc}")
    return time.perf_counter() - t0


def phase_cli(keys_dir: str, work: str, extra=(), configs=GOLDEN) -> dict:
    """The five golden configurations through the CLI."""
    times = {}
    for name, args, goldens, typ in configs:
        out = os.path.join(work, re.sub(r"\W+", "_", name) + ".csv")
        dt = run_cli([*args, "-o", out, "--keys", keys_dir, *extra])
        outs = [out] if len(goldens) == 1 else [
            f"{out}.{i}" for i in range(len(goldens))
        ]
        for o, g in zip(outs, goldens):
            err = _same_wires(o, g, typ)
            check(err is None, f"cli {name}: {o} vs {g}: {err}")
        times[name] = dt
        say(f"cli {name}: {len(goldens)} output file(s) equal the golden "
            f"CSVs; {dt:.2f} s including key load and compile")
    return times


def aes_ct_hex(out_csv: str) -> str:
    from helm_tpu.io import csv_io

    out = csv_io.read_input_wires(out_csv, "bool")
    return bytes(
        sum(int(out[f"ct[{8 * j + i}]"]) << i for i in range(8))
        for j in range(16)
    ).hex()


def phase_aes(keys_dir: str, work: str, extra=()) -> float:
    """AES-128 gates mode, one block, FIPS-197 C.1 (the README command)."""
    out = os.path.join(work, "aes128.csv")
    dt = run_cli([
        "-v", f"{NL}/aes128-gates.v",
        "-w", "pt", "ffeeddccbbaa99887766554433221100", "128",
        "-w", "key", "0f0e0d0c0b0a09080706050403020100", "128",
        "-o", out, "--keys", keys_dir, *extra,
    ])
    ct = aes_ct_hex(out)
    check(ct == AES_CT, f"aes128: ciphertext {ct}, FIPS-197 C.1 says {AES_CT}")
    say(f"cli aes128-gates: ciphertext {ct} equals FIPS-197 C.1; "
        f"{dt:.2f} s including key load and compile")
    return dt


# ----------------------------------------------------------------------
# phase 5: the serving daemon
# ----------------------------------------------------------------------


def write_vectors(netlist_path: str, dst: str, n: int, seed: int) -> list:
    """n random input CSVs for a gates netlist; returns the input maps."""
    import numpy as np

    from helm_tpu.circuit.verilog import read_verilog_file

    nl = read_verilog_file(netlist_path)
    rng = np.random.default_rng(seed)
    os.makedirs(dst, exist_ok=True)
    maps = []
    for i in range(n):
        m = {w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)}
        with open(os.path.join(dst, f"v{i:03d}.csv"), "w") as f:
            f.write("wire, value\n")
            f.writelines(f"{w}, {int(v)}\n" for w, v in m.items())
        maps.append(m)
    return maps


def oracle_outputs(netlist_path: str, inputs: dict) -> dict:
    from helm_tpu.circuit.graph import Circuit
    from helm_tpu.circuit.verilog import read_verilog_file

    nl = read_verilog_file(netlist_path)
    c = Circuit.from_netlist(nl)
    wm = c.evaluate(c.initialize_wire_map(nl.wire_set, inputs))
    return {w: bool(wm[w]) for w in c.output_wires}


def _check_outputs(netlist_path, maps, out_files, what):
    from helm_tpu.io import csv_io

    for m, f in zip(maps, out_files):
        got = csv_io.read_input_wires(f, "bool")
        check(got == oracle_outputs(netlist_path, m),
              f"{what}: {f} differs from the oracle")


class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_serve(keys_dir: str, work: str, seed: int, n: int = 32,
                batch: int = 16, extra=()) -> dict:
    from helm_tpu import serve

    nl_path = f"{NL}/c880-like.v"
    watch, outd = os.path.join(work, "watch"), os.path.join(work, "served")
    maps = write_vectors(nl_path, watch, n, seed)
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = serve.main([
            "-v", nl_path, "--watch", watch, "--outdir", outd,
            "--batch", str(batch), "--max-batches", str(n // batch),
            "--linger", "0", "--keys", keys_dir, *extra,
        ])
    check(rc == 0, f"serve returned {rc}")
    _check_outputs(nl_path, maps, [
        os.path.join(outd, f"v{i:03d}.out.csv") for i in range(n)
    ], "serve")
    per_vec = [float(s) for s in re.findall(
        r"\[serve\] batch \d+: \d+ vectors in [\d.]+s \(([\d.]+)s/vector\)",
        tee.buf.getvalue(),
    )]
    check(len(per_vec) == n // batch, f"serve ran {len(per_vec)} batches")
    res = {"s_per_vector_warm": per_vec[-1], "peak_bytes_in_use": peak_memory()}
    say(f"serve c880-like: {n} vectors in batches of {batch} match the "
        f"oracle; warm batch {res['s_per_vector_warm']} s/vector; process "
        f"peak device memory {res['peak_bytes_in_use']} bytes")
    return res


# ----------------------------------------------------------------------
# phase 6: gate sharding over four cards
# ----------------------------------------------------------------------


def phase_mesh(keys, keys_dir: str, work: str, seed: int, n_dev: int = 4,
               batch: int = 16, extra=()) -> dict:
    """c880-like at batch 16 with --mesh n_dev and without."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from helm_tpu.circuit.verilog import read_verilog_file
    from helm_tpu.engines.boolean import BooleanEngine
    from helm_tpu.parallel.mesh import replicated, shard_engine

    nl_path = f"{NL}/c880-like.v"
    vec_dir = os.path.join(work, "mesh_in")
    maps = write_vectors(nl_path, vec_dir, batch, seed)
    files = [os.path.join(vec_dir, f"v{i:03d}.csv") for i in range(batch)]
    res = {}
    for label, mesh_args in (("mesh", ["--mesh", str(n_dev)]), ("single", [])):
        out = os.path.join(work, f"c880_{label}.csv")
        res[f"{label}_s"] = run_cli([
            "-v", nl_path, "-I", *files, "-o", out, "--keys", keys_dir,
            *mesh_args, *extra,
        ])
        _check_outputs(nl_path, maps, [f"{out}.{i}" for i in range(batch)],
                       f"cli c880-like {label}")
        say(f"cli c880-like batch {batch} {label} {mesh_args}: outputs match "
            f"the oracle; {res[f'{label}_s']:.2f} s")
    res["peak_bytes_in_use"] = [peak_memory(d) for d in jax.devices()[:n_dev]]
    say(f"peak device memory per device after the mesh run: "
        f"{res['peak_bytes_in_use']}")

    # the same encrypted batch through both programs: ciphertexts must agree
    params = keys[0].params
    nl = read_verilog_file(nl_path)
    single = BooleanEngine(mode="gates", params=params, keys=keys)
    single.compile(nl)
    sharded = BooleanEngine(mode="gates", params=params, keys=keys)
    mesh = shard_engine(sharded, n_dev)
    sharded.compile(nl)
    host = np.asarray(single.encrypt_inputs(maps))
    t0 = time.perf_counter()
    a = np.asarray(single.evaluate(jnp.asarray(host)))
    res["single_warm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = np.asarray(sharded.evaluate(jax.device_put(host, replicated(mesh))))
    res["mesh_warm_s"] = time.perf_counter() - t0
    check(a.shape == b.shape and (a == b).all(),
          "mesh and single-device ciphertexts differ")
    say(f"c880-like batch {batch}: the {n_dev}-device and single-device "
        f"wire arrays {a.shape} are equal bit for bit; evaluation with "
        f"compiled programs: {n_dev} devices {res['mesh_warm_s']:.3f} s, "
        f"one device {res['single_warm_s']:.3f} s")
    return res


# ----------------------------------------------------------------------


def build_native() -> None:
    res = subprocess.run(["make", "-C", "native"], capture_output=True,
                         text=True)
    from helm_tpu.circuit import native
    from helm_tpu.io import native_loader

    say(f"native: make -C native rc={res.returncode}; graph library "
        f"{'loaded' if native.native_available() else 'NOT loaded'}, loader "
        f"library {'loaded' if native_loader.native_available() else 'NOT loaded'}")
    if res.returncode:
        say(res.stderr[-2000:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2024,
                    help="seed for keys and input vectors")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the gate-sharding phase over 4 GPUs")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "helm_tpu")):
        print(f"chip_smoke: no helm_tpu package beside {__file__}",
              file=sys.stderr)
        return 2
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    from helm_tpu import params as P
    from helm_tpu.compile_cache import enable_compile_cache
    from helm_tpu.device import card_info, require_gpu

    t_start = time.perf_counter()
    dev = require_gpu("chip_smoke")
    card = card_info()
    say(f"== phase 1: device: JAX {dev}")
    for line in card:
        say(f"nvidia-smi: {line}")
    need = 4 if args.four_cards else 1
    check(dev["count"] >= need, f"needs {need} GPUs, JAX sees {dev['count']}")
    say(f"compile cache: {enable_compile_cache()}")
    build_native()
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    tag = f"on {dev['kind']} ({card[0]})"

    if args.four_cards:
        say(f"== phase 6: gate sharding over 4 devices {tag}")
        keys = make_keys(KEYS_DIR, [P.GATES_128_K3], args.seed)
        phase_mesh(keys[P.GATES_128_K3.name], KEYS_DIR, WORK_DIR, args.seed)
    else:
        keys = make_keys(
            KEYS_DIR, [P.GATES_128_K3, P.LUT_128_K2, P.ARITH_128_MB2],
            args.seed,
        )
        say(f"== phase 2: PBS {tag}")
        phase_pbs(P.GATES_128_K3, keys[P.GATES_128_K3.name], G=1024,
                  cpu_rows=64, seed=args.seed, windows=5)
        phase_pbs(P.LUT_128_K2, keys[P.LUT_128_K2.name], G=256, cpu_rows=16,
                  seed=args.seed, lut=True)
        phase_pbs(P.ARITH_128_MB2, keys[P.ARITH_128_MB2.name], G=256,
                  cpu_rows=16, seed=args.seed, lut=True)
        say(f"== phase 3: CLI golden configurations {tag}")
        phase_cli(KEYS_DIR, WORK_DIR)
        say(f"== phase 4: AES-128 gates through the CLI {tag}")
        phase_aes(KEYS_DIR, WORK_DIR)
        say(f"== phase 5: serving c880-like {tag}")
        phase_serve(KEYS_DIR, WORK_DIR, args.seed)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    for line in card:
        say(line)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    # a crash inside XLA or the native libraries dumps every thread's
    # Python stack instead of dying silently
    faulthandler.enable(all_threads=True)
    sys.exit(main())
