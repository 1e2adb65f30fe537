"""helm-tpu CLI — same flags and mode selection as the reference binary.

Reference: src/bin/helm.rs (mode driver) and src/lib.rs:196-285 (arg spec):
  -v/--verilog FILE, -w/--input-wires W V [WIDTH]..., -i/--input-wires-file,
  -o/--output-wires-file, -c/--cycles N, -a/--arithmetic TYPE, -p/--verbose.
`--gpu`/`-g` is accepted for parity with the reference and ignored: every
mode runs on JAX's default device.

Mode selection (helm.rs:67-131): --arithmetic => arith; netlist contains
`lut` cells => LUTs; otherwise gates.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import ascii_art
from .io import csv_io
from .circuit.verilog import read_verilog_file


def get_input_wire_map(args, arithmetic_type: str) -> dict:
    """Reference src/lib.rs:113-179."""
    if args.input_wires_file:
        print("[✓] Input wires were provided.")
        return csv_io.read_input_wires(args.input_wires_file, arithmetic_type)
    if args.input_wires:
        print("[✓] Input wires were provided.")
        out = {}
        for parts in args.input_wires:
            if len(parts) == 2:
                out[parts[0]] = csv_io.parse_input_wire(parts[1], arithmetic_type)
            elif len(parts) == 3 and arithmetic_type == "bool":
                width = int(parts[2])
                bits = csv_io.hex_to_bitstring(parts[1].strip())[::-1]
                for idx in range(width):
                    out[f"{parts[0]}[{idx}]"] = idx < len(bits) and bits[idx] == "1"
            else:
                raise SystemExit("-w input should contain either two or three values")
        return out
    print("[!] No input wires specified, they will be initialized to false.")
    return {"dummy": False}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="helm-tpu",
        description="encrypted circuit evaluation through gates and lookups",
    )
    ap.add_argument("-v", "--verilog", required=True, metavar="FILE")
    ap.add_argument(
        "-w",
        "--input-wires",
        nargs="+",
        action="append",
        metavar=("STRING", "VALUE"),
        help="Input wire values (-w wire1 value1 [width1] ...)",
    )
    ap.add_argument("-i", "--input-wires-file", metavar="FILE")
    ap.add_argument(
        "-I",
        "--batch-input-files",
        nargs="+",
        metavar="FILE",
        help="several input CSVs evaluated together in one batched pass "
        "(serving shape; all modes incl. --arithmetic)",
    )
    ap.add_argument("-o", "--output-wires-file", metavar="FILE")
    ap.add_argument(
        "-a", "--arithmetic", choices=["u8", "u16", "u32", "u64", "u128"]
    )
    ap.add_argument("-c", "--cycles", type=int, default=1, metavar="NUMBER")
    ap.add_argument("-p", "--verbose", action="store_true")
    ap.add_argument(
        "--gpu", "-g", action="store_true",
        help="(accepted for parity with the reference; JAX's default "
        "device is always used)",
    )
    ap.add_argument(
        "--test-params",
        action="store_true",
        help="use tiny noise-free parameters (fast functional runs)",
    )
    ap.add_argument("--seed", type=int, default=None, help="key RNG seed")
    ap.add_argument(
        "--params",
        metavar="NAME",
        help="named parameter set (see helm_tpu.params.ALL_PARAMS), e.g. "
        "gates_128_k3 (the gates default) or lut_128_mb2",
    )
    ap.add_argument(
        "--profile",
        metavar="DIR",
        help="capture a jax.profiler trace of the evaluation into DIR",
    )
    ap.add_argument(
        "--keys",
        metavar="DIR",
        help="persist keys: load client/server keys for the parameter set "
        "from DIR when present, else generate and save them there "
        "(the reference regenerates keys every run)",
    )
    ap.add_argument(
        "--mesh",
        type=int,
        default=0,
        metavar="N",
        help="shard gate batches across N devices (0 = single device)",
    )
    ap.add_argument(
        "--fuse-levels",
        action="store_const",
        const=True,
        default=None,
        help="force all levels into one jitted lax.scan launch (latency "
        "mode; gates and LUT modes). Default: auto-enabled for "
        "narrow/deep circuits",
    )
    ap.add_argument(
        "--no-fuse-levels",
        dest="fuse_levels",
        action="store_const",
        const=False,
        help="force per-level launches",
    )
    ap.add_argument(
        "--fuse-cycles",
        action="store_true",
        help="evaluate all -c cycles in ONE jitted dispatch (sequential "
        "circuits without the READY protocol; prints amortized per-cycle "
        "time — removes the per-level dispatch overhead that dominates "
        "small sequential circuits)",
    )
    ap.add_argument(
        "--multihost",
        metavar="COORD:PORT,NPROCS,PID",
        help="initialize jax.distributed for multi-host runs (combine with "
        "--mesh N over the global device count)",
    )
    return ap


def _print_outputs(outputs: dict, verbose: bool) -> None:
    for i, w in enumerate(sorted(outputs)):
        if i > 10 and not verbose:
            print("[!] More than ten output_wires, pass `--verbose` to see output.")
            break
        print(f" {w}: {outputs[w]}")


def main(argv=None) -> int:
    ascii_art.print_art()
    args = build_argparser().parse_args(argv)

    from .compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.multihost:
        from .parallel.distributed import init_multihost, parse_multihost_flag

        init_multihost(*parse_multihost_flag(args.multihost))
    from .device import describe

    dev = describe()
    print(f"[✓] Device: {dev['platform']} {dev['kind']} x{dev['count']}")

    if args.arithmetic and args.cycles > 1:
        raise SystemExit(
            "Arithmetic does not currently support sequential. Set num_cycles to 1."
        )

    netlist = read_verilog_file(args.verilog, args.arithmetic is not None)
    is_sequential = len(netlist.dff_outputs) > 1  # quirk kept: helm.rs:49
    if args.cycles > 1 and not is_sequential:
        raise SystemExit("[!] Cannot run combinational circuit for more than one cycles.")

    if args.arithmetic:
        return _run_arith(args, netlist)
    return _run_boolean(args, netlist)


def _maybe_load_keys(args, params):
    """--keys DIR: load-or-generate persisted keys (fhe/keys.py)."""
    if not args.keys:
        return None
    from .fhe.keys import load_or_generate

    ck, sk = load_or_generate(args.keys, params, args.seed)
    print(f"[✓] Keys ({params.name}) from {args.keys}.")
    return ck, sk


def _run_boolean(args, netlist) -> int:
    from . import params as P
    from .engines.boolean import BooleanEngine

    mode = "lut" if netlist.has_luts else "gates"
    print(f" -- {'LUTs' if mode == 'lut' else 'Gates'} mode --")
    if args.batch_input_files:
        # giant vector sets parse in C++ when built (io/native_loader.py)
        from .io import native_loader

        input_wire_map = [
            native_loader.read_input_wires(f, "bool")
            for f in args.batch_input_files
        ]
        print(f"[✓] Batched input wires: {len(input_wire_map)} vectors.")
    else:
        input_wire_map = get_input_wire_map(args, "bool")

    start = time.time()
    if args.params:
        try:
            params = P.ALL_PARAMS[args.params]
        except KeyError:
            raise SystemExit(
                f"unknown --params {args.params!r}; "
                f"known: {', '.join(sorted(P.ALL_PARAMS))}"
            )
    elif args.test_params:
        params = P.TEST_PARAMS if mode == "gates" else P.TEST_PARAMS_LUT
    else:
        params = None
    engine = BooleanEngine(
        mode=mode,
        params=params,
        seed=args.seed,
        fuse_levels=args.fuse_levels,
        keys=_maybe_load_keys(
            args, params or (P.DEFAULT_GATES if mode == "gates" else P.DEFAULT_LUT)
        ),
    )
    print(f"KeyGen done in {time.time() - start} seconds.")
    if args.mesh:
        from .parallel.mesh import shard_engine

        shard_engine(engine, args.mesh)
    engine.compile(netlist)

    start = time.time()
    wires = engine.encrypt_inputs(input_wire_map)
    nbatch = len(input_wire_map) if isinstance(input_wire_map, list) else None
    valid = engine.init_ready(batch=nbatch) if engine.has_ready() else None
    print(f"Encryption done in {time.time() - start} seconds.")

    ready_flag = False
    profile_ctx = None
    if args.profile:
        import jax

        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()
    if args.fuse_cycles and args.cycles > 1 and not engine.has_ready():
        # all cycles in one jitted dispatch (engine.evaluate_cycles) —
        # the latency path for small sequential circuits; prints the
        # amortized per-cycle time (per-cycle wall-clocks do not exist
        # in a single dispatch)
        start = time.time()
        wires = engine.evaluate_cycles(wires, args.cycles)
        wires.block_until_ready()
        dt = time.time() - start
        print(
            f"Cycles 0..{args.cycles - 1}) Evaluation done in {dt} seconds "
            f"(one fused dispatch; {dt / args.cycles:.3f} s/cycle amortized).\n"
        )
    else:
        for cycle in range(args.cycles):
            start = time.time()
            wires = engine.evaluate(wires, verbose=args.verbose)
            if args.cycles > 1 and engine.has_ready():
                ready_flag = True
                valid = engine.evaluate_ready(wires, valid)
            wires.block_until_ready()
            print(f"Cycle {cycle}) Evaluation done in {time.time() - start} seconds.\n")

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
        print(f"[✓] profiler trace written to {args.profile}")

    start = time.time()
    print("Encrypted Evaluation:")
    if ready_flag:
        outputs = engine.decrypt_outputs(valid, from_valid=True)
    else:
        outputs = engine.decrypt_outputs(wires)
    if isinstance(outputs, list):
        for bi, out in enumerate(outputs):
            print(f" [vector {bi}: {args.batch_input_files[bi]}]")
            _print_outputs(out, args.verbose)
            if args.output_wires_file:
                csv_io.write_output_wires(
                    f"{args.output_wires_file}.{bi}", out
                )
    else:
        _print_outputs(outputs, args.verbose)
        csv_io.write_output_wires(args.output_wires_file, outputs)
    print(f"Decryption done in {time.time() - start} seconds.")
    return 0


def _run_arith(args, netlist) -> int:
    from . import params as P
    from .engines.arith import ArithEngine

    print(f" -- Arithmetic mode with {args.arithmetic} --")
    if args.batch_input_files:
        from .io import native_loader

        input_wire_map = [
            native_loader.read_input_wires(f, args.arithmetic)
            for f in args.batch_input_files
        ]
        print(f"[✓] Batched input wires: {len(input_wire_map)} vectors.")
    else:
        input_wire_map = get_input_wire_map(args, args.arithmetic)

    start = time.time()
    if args.params:
        try:
            params = P.ALL_PARAMS[args.params]
        except KeyError:
            raise SystemExit(
                f"unknown --params {args.params!r}; "
                f"known: {', '.join(sorted(P.ALL_PARAMS))}"
            )
    else:
        params = P.TEST_PARAMS_ARITH if args.test_params else None
    engine = ArithEngine(
        args.arithmetic,
        params=params,
        seed=args.seed,
        keys=_maybe_load_keys(args, params or P.DEFAULT_ARITH),
    )
    print(f"KeyGen done in {time.time() - start} seconds.")
    if args.mesh:
        from .parallel.mesh import batch_sharding, make_gate_mesh, replicated

        mesh = make_gate_mesh(args.mesh)
        engine.set_sharding(batch_sharding(mesh), replicated(mesh))
    engine.compile(netlist)

    start = time.time()
    wires = engine.encrypt_inputs(input_wire_map)
    print(f"Encryption done in {time.time() - start} seconds.")

    start = time.time()
    wires = engine.evaluate(wires, verbose=args.verbose)
    print(f"Evaluation done in {time.time() - start} seconds.\n")

    start = time.time()
    print("Encrypted Evaluation:")
    outputs = engine.decrypt_outputs(wires)
    if isinstance(outputs, list):
        for bi, out in enumerate(outputs):
            print(f" [vector {bi}: {args.batch_input_files[bi]}]")
            _print_outputs(out, args.verbose)
            if args.output_wires_file:
                csv_io.write_output_wires(f"{args.output_wires_file}.{bi}", out)
    else:
        _print_outputs(outputs, args.verbose)
        csv_io.write_output_wires(args.output_wires_file, outputs)
    print(f"Decryption done in {time.time() - start} seconds.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
