"""End-to-end encrypted engine tests vs the plaintext oracle.

Mirrors the reference's integration strategy (tests/circuit_test.rs): parse
-> levelize -> oracle -> encrypt -> evaluate -> decrypt -> assert equality
on every wire.
"""

import numpy as np
import pytest

from helm_tpu import params as P
from helm_tpu.circuit.graph import Circuit
from helm_tpu.circuit.verilog import read_verilog_file
from helm_tpu.engines.boolean import BooleanEngine
from helm_tpu.io import csv_io


@pytest.fixture(scope="module")
def gates_engine():
    return BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=99)


@pytest.fixture(scope="module")
def lut_engine():
    return BooleanEngine(mode="lut", params=P.TEST_PARAMS_LUT, seed=98)


def _oracle(netlist, inputs):
    c = Circuit.from_netlist(netlist)
    return c.evaluate(c.initialize_wire_map(netlist.wire_set, inputs))


def test_encrypted_two_bit_adder_all_wires(gates_engine):
    # reference tests/circuit_test.rs:48-94
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    inputs = csv_io.read_input_wires(
        "benchmarks/test-cases/2-bit-adder.inputs.csv", "bool"
    )
    exp = _oracle(nl, inputs)
    e = gates_engine
    e.compile(nl)
    wires = e.evaluate(e.encrypt_inputs(inputs))
    got = e.decrypt_all_wires(wires)
    for w, v in exp.items():
        assert got[w] == v, w


def test_encrypted_mux_and_consts(gates_engine):
    src = """
module m(a, b, s, y, o1, o0);
  input a, b, s;
  output y, o1, o0;
  mux g0(a, b, s, y);
  cone g1(o1);
  czero g2(o0);
endmodule
"""
    from helm_tpu.circuit.verilog import parse_verilog

    nl = parse_verilog(src)
    e = gates_engine
    e.compile(nl)
    for a, b, s in [(0, 0, 0), (1, 0, 1), (0, 1, 1), (1, 0, 0)]:
        inputs = {"a": bool(a), "b": bool(b), "s": bool(s)}
        out = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(inputs)))
        assert out["y"] == (bool(a) if s else bool(b)), (a, b, s)
        assert out["o1"] is True and out["o0"] is False


def test_encrypted_s27_sequential(gates_engine):
    nl = read_verilog_file("benchmarks/netlists/s27.v")
    c = Circuit.from_netlist(read_verilog_file("benchmarks/netlists/s27.v"))
    inputs = {"G0": False, "G1": True, "G2": False, "G3": True}
    e = gates_engine
    e.compile(nl)
    wires = e.encrypt_inputs(inputs)
    state = c.initialize_wire_map(nl.wire_set, inputs)
    for cycle in range(3):
        wires = e.evaluate(wires)
        state = c.evaluate(state)
        got = e.decrypt_all_wires(wires)
        for w, v in state.items():
            assert got[w] == v, (cycle, w)


def test_encrypted_lut_adder_8bit(lut_engine):
    # reference tests/circuit_test.rs:267-312 (8-bit LUT adder vs oracle)
    nl = read_verilog_file("benchmarks/netlists/8-bit-adder-lut-3-1.v")
    e = lut_engine
    e.compile(nl)
    for a, b, cin in [(173, 94, 1), (255, 1, 0)]:
        inputs = {f"a[{i}]": bool(a >> i & 1) for i in range(8)}
        inputs |= {f"b[{i}]": bool(b >> i & 1) for i in range(8)}
        inputs["cin"] = bool(cin)
        exp = _oracle(nl, inputs)
        out = e.decrypt_all_wires(e.evaluate(e.encrypt_inputs(inputs)))
        for w, v in exp.items():
            assert out[w] == int(bool(v)), w


def test_encrypted_lut_bivariate_and_unary(lut_engine):
    src = """
module m(a, b, y2, y1);
  input a, b;
  output y2, y1;
  lut g0(6, a, b, y2);
  lut g1(1, a, y1);
endmodule
"""
    from helm_tpu.circuit.verilog import parse_verilog

    nl = parse_verilog(src)
    e = lut_engine
    e.compile(nl)
    for a, b in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        out = e.decrypt_outputs(
            e.evaluate(e.encrypt_inputs({"a": bool(a), "b": bool(b)}))
        )
        assert out["y2"] == (a ^ b), (a, b)  # lut const 6 = XOR
        assert out["y1"] == (1 - a), (a, b)  # lut const 1 = NOT


def test_ready_protocol_gates(gates_engine):
    # READY high on cycle>=2 latches outputs obliviously (circuit.rs:492-504)
    src = """
module seq(a, out);
  input a;
  output out;
  dff d0(n1, s1);
  dff d1(s1, READY);
  not g0(a, n1);
  buf g1(s1, out);
endmodule
"""
    from helm_tpu.circuit.verilog import parse_verilog

    nl = parse_verilog(src)
    e = gates_engine
    e.compile(nl)
    assert e.has_ready()
    wires = e.encrypt_inputs({"a": False})
    valid = e.init_ready()
    for _ in range(3):
        wires = e.evaluate(wires)
        valid = e.evaluate_ready(wires, valid)
    out = e.decrypt_outputs(valid, from_valid=True)
    # s1 latches NOT(a)=1 after cycle 1; READY goes high at cycle 2
    assert out["out"] is True


def test_wide_lut_shannon_decomposition(lut_engine):
    """5-input LUTs lower to 3-input trees (reference C11 capability)."""
    import random

    rnd = random.Random(7)
    table = [rnd.randint(0, 1) for _ in range(32)]
    const = sum(b << i for i, b in enumerate(table))
    src = f"""
module m(a, b, c, d, e, y);
  input a, b, c, d, e;
  output y;
  lut g0({const}, a, b, c, d, e, y);
endmodule
"""
    from helm_tpu.circuit.verilog import parse_verilog

    nl = parse_verilog(src)
    e = lut_engine
    e.compile(nl)
    for trial in range(6):
        bits = [rnd.randint(0, 1) for _ in range(5)]
        inputs = dict(zip("abcde", (bool(x) for x in bits)))
        out = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(inputs)))
        idx = sum(bits[i] << (4 - i) for i in range(5))  # first wire = MSB
        assert out["y"] == table[idx], (trial, bits)


@pytest.mark.slow
def test_encrypted_c880_like_all_wires():
    """c880-scale combinational netlist, encrypted vs oracle on every wire."""
    nl = read_verilog_file("benchmarks/netlists/c880-like.v")
    e = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=880)
    e.compile(nl)
    rng = np.random.default_rng(1)
    inputs = {f"i[{j}]": bool(rng.integers(0, 2)) for j in range(60)}
    exp = _oracle(nl, inputs)
    got = e.decrypt_all_wires(e.evaluate(e.encrypt_inputs(inputs)))
    for w, v in exp.items():
        assert got[w] == v, w


def test_cli_output_file(tmp_path):
    from helm_tpu import cli

    out = tmp_path / "out.csv"
    rc = cli.main(
        [
            "-v", "benchmarks/netlists/2-bit-adder.v",
            "-i", "benchmarks/test-cases/2-bit-adder.inputs.csv",
            "-o", str(out),
            "--test-params", "--seed", "3",
        ]
    )
    assert rc == 0
    text = out.read_text()
    rows = dict(
        line.split(", ") for line in text.strip().splitlines()
    )
    assert rows == {"sum[0]": "true", "sum[1]": "true", "cout": "false"}


def test_ready_protocol_lut(lut_engine):
    """READY latching in LUT mode (reference circuit.rs:1012-1030)."""
    src = """
module seq(a, out);
  input a;
  output out;
  dff d0(n1, s1);
  dff d1(s1, READY);
  lut g0(1, a, n1);
  lut g1(2, s1, out);
endmodule
"""
    from helm_tpu.circuit.verilog import parse_verilog

    nl = parse_verilog(src)
    e = lut_engine
    e.compile(nl)
    assert e.has_ready()
    wires = e.encrypt_inputs({"a": False})
    valid = e.init_ready()
    for _ in range(3):
        wires = e.evaluate(wires)
        valid = e.evaluate_ready(wires, valid)
    out = e.decrypt_outputs(valid, from_valid=True)
    # lut const 1 = NOT; lut const 2 = identity: out latches NOT(a)=1
    assert out["out"] == 1


def test_cli_lut_and_arith_modes(tmp_path):
    """CLI end-to-end for LUTs and arithmetic modes (test params)."""
    from helm_tpu import cli

    out = tmp_path / "lut.csv"
    rc = cli.main(
        [
            "-v", "benchmarks/netlists/8-bit-adder-lut-3-1.v",
            "-i", "benchmarks/test-cases/8-bit-adder.inputs.csv",
            "-o", str(out), "--test-params", "--seed", "4",
        ]
    )
    assert rc == 0
    rows = dict(line.split(", ") for line in out.read_text().strip().splitlines())
    total = sum(int(rows[f"sum[{i}]"]) << i for i in range(8))
    total += int(rows["cout"]) << 8
    assert total == 0x5A + 0x33 + 1

    out2 = tmp_path / "chi.csv"
    rc = cli.main(
        [
            "-v", "benchmarks/netlists/chi_squared_arith.v",
            "-a", "u8",
            "-i", "benchmarks/test-cases/chi_squared_arith_2.inputs.csv",
            "-o", str(out2), "--test-params", "--seed", "5",
        ]
    )
    assert rc == 0
    rows = dict(line.split(", ") for line in out2.read_text().strip().splitlines())
    assert rows == {"alpha": "17", "beta1": "242", "beta2": "19", "beta3": "226"}


def test_encrypted_crc32_cycles(gates_engine):
    """Encrypted bit-serial CRC-32 over 4 cycles vs software model."""
    nl = read_verilog_file("benchmarks/netlists/crc32.v")
    e = gates_engine
    e.compile(nl)

    def crc_step(state, bit):
        fb = ((state >> 31) & 1) ^ bit
        return ((state << 1) & 0xFFFFFFFF) ^ (0x04C11DB7 * fb)

    data = [1, 0, 1, 1]
    state_sw = 0
    wires = e.encrypt_inputs({"din": bool(data[0])})
    for cyc, bit in enumerate(data):
        if cyc > 0:
            # re-encrypt the next input bit in place
            import jax.numpy as jnp
            from helm_tpu.fhe import lwe

            idx = e.plan.wire_index["din"]
            row = lwe.encrypt(e.client_key, e._encode(bool(bit)))
            wires = wires.at[idx].set(jnp.asarray(row))
        wires = e.evaluate(wires)
        state_sw = crc_step(state_sw, bit)
    got = e.decrypt_all_wires(wires)
    val = sum(int(got[f"s{i}"]) << i for i in range(32))
    assert val == state_sw


def test_aes_sbox_as_wide_lut(lut_engine):
    """AES S-box bit as an 8-input LUT — exercises deep Shannon trees
    (the AES family of RUNNING.md)."""
    # AES S-box, first 16 entries are enough to spot-check plus random ones
    SBOX = [
        0x63, 0x7C, 0x77, 0x7B, 0xF2, 0x6B, 0x6F, 0xC5,
        0x30, 0x01, 0x67, 0x2B, 0xFE, 0xD7, 0xAB, 0x76,
    ] + [((17 * i + 31) ^ (i >> 3)) & 0xFF for i in range(16, 256)]
    bit = 0
    table = [(SBOX[i] >> bit) & 1 for i in range(256)]
    const = sum(b << i for i, b in enumerate(table))
    ins = ", ".join(f"x{i}" for i in range(8))
    src = f"""
module sbox({ins}, y);
  input {ins};
  output y;
  lut g0({const}, {ins}, y);
endmodule
"""
    from helm_tpu.circuit.verilog import parse_verilog

    nl = parse_verilog(src)
    e = lut_engine
    e.compile(nl)
    import random

    rnd = random.Random(3)
    for _ in range(4):
        v = rnd.randrange(256)
        # first wire is the MSB of the LUT index
        inputs = {f"x{i}": bool((v >> (7 - i)) & 1) for i in range(8)}
        out = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(inputs)))
        assert out["y"] == table[v], v


def _aes_bit_inputs(pt: bytes, key: bytes) -> dict:
    inputs = {}
    for j in range(16):
        for i in range(8):
            inputs[f"pt[{8 * j + i}]"] = bool((pt[j] >> i) & 1)
            inputs[f"key[{8 * j + i}]"] = bool((key[j] >> i) & 1)
    return inputs


def _aes_ct_bytes(out: dict) -> bytes:
    return bytes(
        sum(int(out[f"ct[{8 * j + i}]"]) << i for i in range(8))
        for j in range(16)
    )


_FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
_FIPS_KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")


def test_aes128_reference_vector():
    """The AES oracle reproduces FIPS-197 appendix C.1."""
    import sys

    sys.path.insert(0, "benchmarks")
    from gen_circuits import aes_encrypt

    assert (
        aes_encrypt(_FIPS_PT, _FIPS_KEY).hex()
        == "69c4e0d86a7b0430d8cdb78070b4c55a"
    )


def test_aes128_netlist_oracle():
    """Full 10-round AES-128 netlist (key schedule in-circuit, 9.3k LUT
    cells) evaluates to the FIPS-197 ciphertext under the plaintext
    oracle — the aes-core/aes-128 family of the reference's RUNNING.md."""
    nl = read_verilog_file("benchmarks/netlists/aes128.v")
    c = Circuit.from_netlist(nl)
    wm = c.evaluate(
        c.initialize_wire_map(
            nl.wire_set, _aes_bit_inputs(_FIPS_PT, _FIPS_KEY), default=False
        )
    )
    out = {w: wm[w] for w in c.output_wires}
    assert _aes_ct_bytes(out).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_aes_sbox_gates_all_256():
    """Composite-field (GF((2^4)^2)) S-box gate circuit matches the real
    S-box table on every input."""
    import sys

    sys.path.insert(0, "benchmarks")
    from gen_circuits import _GateEmitter, aes_sbox, aes_sbox_gates

    from helm_tpu.circuit.verilog import parse_verilog

    em = _GateEmitter()
    outs = aes_sbox_gates(em, [f"x[{i}]" for i in range(8)])
    post = [f"  buf ob{k}({outs[k]}, y[{k}]);" for k in range(8)]
    src = (
        "module sboxg(x, y);\n  input [7:0] x;\n  output [7:0] y;\n"
        + "\n".join(em.lines + post)
        + "\nendmodule\n"
    )
    nl = parse_verilog(src)
    c = Circuit.from_netlist(nl)
    sb = aes_sbox()
    for v in range(256):
        inputs = {f"x[{i}]": bool((v >> i) & 1) for i in range(8)}
        wm = c.evaluate(
            c.initialize_wire_map(nl.wire_set, inputs, default=False)
        )
        assert sum(int(wm[f"y[{k}]"]) << k for k in range(8)) == sb[v], v


def test_aes128_gates_netlist_oracle():
    """Gates-mode AES-128 (composite-field S-boxes, 41.4k gates) matches
    FIPS-197 C.1 under the plaintext oracle."""
    nl = read_verilog_file("benchmarks/netlists/aes128-gates.v")
    c = Circuit.from_netlist(nl)
    wm = c.evaluate(
        c.initialize_wire_map(
            nl.wire_set, _aes_bit_inputs(_FIPS_PT, _FIPS_KEY), default=False
        )
    )
    out = {w: wm[w] for w in c.output_wires}
    assert _aes_ct_bytes(out).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_aes128_gates_one_round_encrypted(gates_engine):
    """Reduced-round gates-mode AES decrypts to the oracle bit-exactly."""
    import sys

    sys.path.insert(0, "benchmarks")
    from gen_circuits import aes128_gates_circuit, aes_encrypt

    from helm_tpu.circuit.verilog import parse_verilog

    nl = parse_verilog(aes128_gates_circuit(1, name="aes1rg"))
    e = gates_engine
    e.compile(nl)
    out = e.decrypt_outputs(
        e.evaluate(e.encrypt_inputs(_aes_bit_inputs(_FIPS_PT, _FIPS_KEY)))
    )
    assert _aes_ct_bytes(out) == aes_encrypt(_FIPS_PT, _FIPS_KEY, rounds=1)


def test_aes128_one_round_encrypted():
    """Reduced-round AES (ARK + SubBytes/ShiftRows/ARK incl.
    8-input S-box LUTs) decrypts to the reduced-round oracle bit-exactly."""
    import sys

    sys.path.insert(0, "benchmarks")
    from gen_circuits import aes128_circuit, aes_encrypt

    from helm_tpu.circuit.verilog import parse_verilog

    nl = parse_verilog(aes128_circuit(1, name="aes1r"))
    e = BooleanEngine(mode="lut", params=P.TEST_PARAMS_LUT, seed=42)
    e.compile(nl)
    out = e.decrypt_outputs(
        e.evaluate(e.encrypt_inputs(_aes_bit_inputs(_FIPS_PT, _FIPS_KEY)))
    )
    assert _aes_ct_bytes(out) == aes_encrypt(_FIPS_PT, _FIPS_KEY, rounds=1)


@pytest.mark.parametrize(
    "params", [P.TEST_PARAMS, P.TEST_PARAMS_MB], ids=["single-bit", "mb2"]
)
def test_engine_two_bit_adder_all_wires(params):
    """BooleanEngine on the single- and multi-bit PBS, every wire."""
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    inputs = csv_io.read_input_wires(
        "benchmarks/test-cases/2-bit-adder.inputs.csv", "bool"
    )
    exp = _oracle(nl, inputs)
    e = BooleanEngine(mode="gates", params=params, seed=97)
    e.compile(nl)
    got = e.decrypt_all_wires(e.evaluate(e.encrypt_inputs(inputs)))
    for w, v in exp.items():
        assert got[w] == v, (params.name, w)


@pytest.mark.parametrize(
    "params", [P.TEST_PARAMS_ARITH, P.TEST_PARAMS_ARITH_MB],
    ids=["single-bit", "mb2"],
)
def test_radix_add_mul(params):
    """RadixOps add and mul on the single- and multi-bit PBS."""
    import jax.numpy as jnp

    from helm_tpu.engines.arith import ArithEngine

    e = ArithEngine("u8", params=params, seed=41)
    xs, ys = [19, 200], [7, 99]
    x = jnp.asarray(np.stack([e._encrypt_value(v) for v in xs]))
    y = jnp.asarray(np.stack([e._encrypt_value(v) for v in ys]))
    add = e.ops.add(x, y)
    mul = e.ops.mul(x, y)
    for i in range(len(xs)):
        assert e._decrypt_value(np.asarray(add[i])) == (xs[i] + ys[i]) % 256
        assert e._decrypt_value(np.asarray(mul[i])) == (xs[i] * ys[i]) % 256


def test_fused_scan_evaluation_gates_and_lut():
    """fuse_levels=True (whole circuit as one lax.scan launch) matches the
    oracle in both modes, including a sequential circuit over cycles."""
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    inputs = csv_io.read_input_wires(
        "benchmarks/test-cases/2-bit-adder.inputs.csv", "bool"
    )
    exp = _oracle(nl, inputs)
    e = BooleanEngine(
        mode="gates", params=P.TEST_PARAMS, seed=21, fuse_levels=True
    )
    e.compile(nl)
    got = e.decrypt_all_wires(e.evaluate(e.encrypt_inputs(inputs)))
    for w, v in exp.items():
        assert got[w] == v, w

    nl2 = read_verilog_file("benchmarks/netlists/8-bit-adder-lut-3-1.v")
    rng = np.random.default_rng(17)
    inputs2 = {w: bool(rng.integers(0, 2)) for w in nl2.inputs}
    c2 = Circuit.from_netlist(nl2)
    exp2 = c2.evaluate(c2.initialize_wire_map(nl2.wire_set, inputs2))
    e2 = BooleanEngine(
        mode="lut", params=P.TEST_PARAMS_LUT, seed=22, fuse_levels=True
    )
    e2.compile(nl2)
    got2 = e2.decrypt_outputs(e2.evaluate(e2.encrypt_inputs(inputs2)))
    for w in got2:
        assert got2[w] == int(exp2[w]), w


def test_fused_scan_sequential_s27():
    nl = read_verilog_file("benchmarks/netlists/s27.v")
    inputs = {w: bool(i % 2) for i, w in enumerate(sorted(nl.inputs))}
    e = BooleanEngine(
        mode="gates", params=P.TEST_PARAMS, seed=23, fuse_levels=True
    )
    e.compile(nl)
    wires = e.encrypt_inputs(inputs)
    c = Circuit.from_netlist(nl)
    wm = c.initialize_wire_map(nl.wire_set, inputs)
    for _ in range(3):
        wires = e.evaluate(wires)
        wm = c.evaluate(wm)
    got = e.decrypt_outputs(wires)
    for w in got:
        assert got[w] == bool(wm[w]), w


def test_evaluate_cycles_matches_per_cycle():
    """evaluate_cycles (one dispatch for all cycles) is bit-identical to
    N sequential evaluate() calls — latency path for small sequential
    circuits where per-level dispatch overhead dominates."""
    import jax.numpy as jnp

    nl = read_verilog_file("benchmarks/netlists/s27.v")
    inputs = {w: bool(i % 2) for i, w in enumerate(sorted(nl.inputs))}
    for fuse in (None, True):
        e = BooleanEngine(
            mode="gates", params=P.TEST_PARAMS, seed=23, fuse_levels=fuse
        )
        e.compile(nl)
        w0 = e.encrypt_inputs(inputs)
        a = np.asarray(w0).copy()
        ref = jnp.asarray(a.copy())
        for _ in range(3):
            ref = e.evaluate(ref)
        got = e.evaluate_cycles(jnp.asarray(a), 3)
        assert (np.asarray(got) == np.asarray(ref)).all(), fuse
        # oracle check on top of the bit-equality
        c = Circuit.from_netlist(nl)
        wm = c.initialize_wire_map(nl.wire_set, inputs)
        for _ in range(3):
            wm = c.evaluate(wm)
        out = e.decrypt_outputs(got)
        for w in out:
            assert out[w] == bool(wm[w]), w


@pytest.mark.parametrize(
    "params", [P.TEST_PARAMS_LUT, P.TEST_PARAMS_LUT_MB],
    ids=["single-bit", "mb2"],
)
def test_engine_lut_mode_per_slot_test_polys(params):
    """LUT mode: per-slot test polynomials (testv [S, N]) flow through
    the batched PBS, single- and multi-bit."""
    nl = read_verilog_file("benchmarks/netlists/8-bit-adder-lut-3-1.v")
    rng = np.random.default_rng(23)
    inputs = {w: bool(rng.integers(0, 2)) for w in nl.inputs}
    c = Circuit.from_netlist(nl)
    exp = c.evaluate(c.initialize_wire_map(nl.wire_set, inputs))
    e = BooleanEngine(mode="lut", params=params, seed=29)
    e.compile(nl)
    got = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(inputs)))
    for w in got:
        assert got[w] == int(exp[w]), (params.name, w)


def test_batched_serving_shape():
    """A list of input maps encrypts to [B, W, n+1] and every level's PBS
    launch widens by B; per-vector results equal individual evaluations."""
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    rng = np.random.default_rng(31)
    batches = [
        {w: bool(rng.integers(0, 2)) for w in nl.inputs} for _ in range(3)
    ]
    for params in (P.TEST_PARAMS, P.TEST_PARAMS_MB):
        e = BooleanEngine(mode="gates", params=params, seed=61)
        e.compile(nl)
        outs = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(batches)))
        assert isinstance(outs, list) and len(outs) == 3
        for i, inp in enumerate(batches):
            single = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(inp)))
            assert outs[i] == single, (params.name, i)


def test_batched_lut_mode():
    """Batched serving shape in LUT mode (per-slot test polys tile by B)."""
    nl = read_verilog_file("benchmarks/netlists/8-bit-adder-lut-3-1.v")
    rng = np.random.default_rng(33)
    batches = [
        {w: bool(rng.integers(0, 2)) for w in nl.inputs} for _ in range(2)
    ]
    e = BooleanEngine(mode="lut", params=P.TEST_PARAMS_LUT, seed=62)
    e.compile(nl)
    outs = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(batches)))
    c = Circuit.from_netlist(nl)
    for i, inp in enumerate(batches):
        exp = c.evaluate(c.initialize_wire_map(nl.wire_set, inp))
        for w in outs[i]:
            assert outs[i][w] == int(exp[w]), (i, w)


def test_batched_sequential_ready():
    """Batched multi-cycle evaluation with the READY latching protocol."""
    nl = read_verilog_file("benchmarks/netlists/s27.v")
    rng = np.random.default_rng(35)
    batches = [
        {w: bool(rng.integers(0, 2)) for w in nl.inputs if w not in nl.dff_outputs}
        for _ in range(2)
    ]
    e = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=63)
    e.compile(nl)
    cycles = 3
    wires = e.encrypt_inputs(batches)
    valid = e.init_ready(batch=2) if e.has_ready() else None
    for _ in range(cycles):
        wires = e.evaluate(wires)
        if valid is not None:
            valid = e.evaluate_ready(wires, valid)
    outs = e.decrypt_outputs(wires)
    for i, inp in enumerate(batches):
        es = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=63)
        es.compile(nl)
        ws = es.encrypt_inputs(inp)
        for _ in range(cycles):
            ws = es.evaluate(ws)
        assert outs[i] == es.decrypt_outputs(ws), i


def test_encrypted_s386_like_sequential(gates_engine):
    """ISCAS'89-scale sequential stand-in: 3 cycles encrypted vs oracle
    on every wire (s27's pattern at s386 size)."""
    nl = read_verilog_file("benchmarks/netlists/s386-like.v")
    c = Circuit.from_netlist(read_verilog_file("benchmarks/netlists/s386-like.v"))
    rng = np.random.default_rng(386)
    inputs = {f"i[{j}]": bool(rng.integers(0, 2)) for j in range(7)}
    e = gates_engine
    e.compile(nl)
    wires = e.encrypt_inputs(inputs)
    state = c.initialize_wire_map(nl.wire_set, inputs)
    for cycle in range(3):
        wires = e.evaluate(wires)
        state = c.evaluate(state)
        got = e.decrypt_all_wires(wires)
        for w, v in state.items():
            assert got[w] == v, (cycle, w)


@pytest.mark.slow
def test_aes128_gates_full_encrypted():
    """FULL 10-round gates-mode AES-128 encrypted end-to-end (41.4k
    gates): decrypted ciphertext equals FIPS-197 C.1."""
    nl = read_verilog_file("benchmarks/netlists/aes128-gates.v")
    e = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=128)
    e.compile(nl)
    out = e.decrypt_outputs(
        e.evaluate(e.encrypt_inputs(_aes_bit_inputs(_FIPS_PT, _FIPS_KEY)))
    )
    assert _aes_ct_bytes(out).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_batched_serving_sequential(gates_engine):
    """Batched serving composes with the sequential cycle loop: two s27
    vectors in one pass, 3 cycles, every wire matches its own oracle."""
    nl = read_verilog_file("benchmarks/netlists/s27.v")
    e = gates_engine
    e.compile(nl)
    vecs = [
        {"G0": False, "G1": True, "G2": False, "G3": True},
        {"G0": True, "G1": False, "G2": True, "G3": False},
    ]
    wires = e.encrypt_inputs(vecs)
    c = Circuit.from_netlist(nl)
    states = [c.initialize_wire_map(nl.wire_set, v) for v in vecs]
    for cyc in range(3):
        wires = e.evaluate(wires)
        states = [c.evaluate(s) for s in states]
        outs = e.decrypt_all_wires(wires)
        for bi in range(2):
            for w, v in states[bi].items():
                assert outs[bi][w] == v, (cyc, bi, w)


def test_fused_levels_sequential_matches_oracle():
    """Auto/forced level fusion composes with the sequential DFF loop:
    s386-scale circuit, 2 cycles, fused vs oracle on every output."""
    nl = read_verilog_file("benchmarks/netlists/s386-like.v")
    c = Circuit.from_netlist(read_verilog_file("benchmarks/netlists/s386-like.v"))
    e = BooleanEngine(
        mode="gates", params=P.TEST_PARAMS, seed=21, fuse_levels=True
    )
    e.compile(nl)
    assert e._scan_levels is not None
    ins = {f"i[{j}]": bool(j % 2) for j in range(7)}
    wires = e.encrypt_inputs(ins)
    wm = c.initialize_wire_map(nl.wire_set, ins)
    for _ in range(2):
        wires = e.evaluate(wires)
        wm = c.evaluate(wm)
    out = e.decrypt_outputs(wires)
    assert all(bool(wm[w]) == bool(v) for w, v in out.items())


def test_fuse_levels_auto_heuristic():
    """None = auto: deep/narrow circuits fuse, shallow ones don't."""
    e = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=22)
    e.compile(read_verilog_file("benchmarks/netlists/c880-like.v"))
    assert e._scan_levels is not None  # 383 gates over ~55 narrow levels
    e2 = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=22)
    e2.compile(read_verilog_file("benchmarks/netlists/2-bit-adder.v"))
    assert e2._scan_levels is None  # 5 levels: per-level launches


def test_chunked_fusion_deep_chain(tmp_path):
    """>128 levels: the fused path must split into equal-length scan
    chunks (tail padded with no-op levels) and still match the oracle.
    Chunks of <= HELM_TPU_MAXC (128) levels share one compiled
    executable."""
    depth = 300
    lines = ["module chain(a, b, out);", "input a, b;", "output out;"]
    lines += [f"wire w{i};" for i in range(depth)]
    lines.append("xor g0(a, b, w0);")
    for i in range(1, depth):
        if i % 3 == 0:
            lines.append(f"not g{i}(w{i-1}, w{i});")
        elif i % 3 == 1:
            lines.append(f"xor g{i}(w{i-1}, a, w{i});")
        else:
            lines.append(f"and g{i}(w{i-1}, b, w{i});")
    lines.append(f"buf gout(w{depth-1}, out);")
    lines.append("endmodule")
    path = tmp_path / "chain.v"
    path.write_text("\n".join(lines) + "\n")

    nl = read_verilog_file(str(path))
    inputs = {"a": True, "b": True}
    exp = _oracle(nl, inputs)
    e = BooleanEngine(
        mode="gates", params=P.TEST_PARAMS, seed=31, fuse_levels=True
    )
    e.compile(nl)
    assert e._scan_levels is not None and len(e._scan_levels) >= 3
    # equal chunk lengths (one executable) and full level coverage
    lens = {c["slot_in"].shape[0] for c in e._scan_levels}
    assert len(lens) == 1
    assert lens.pop() * len(e._scan_levels) >= len(e.plan.levels)
    got = e.decrypt_all_wires(e.evaluate(e.encrypt_inputs(inputs)))
    for w, v in exp.items():
        assert got[w] == v, w


def _fused_adder_engine():
    e = BooleanEngine(
        mode="gates", params=P.TEST_PARAMS, seed=3, fuse_levels=True
    )
    e.compile(read_verilog_file("benchmarks/netlists/2-bit-adder.v"))
    return e


def test_dispatch_bound_auto_clamp(monkeypatch):
    """Chunk length derives from BOTH per-dispatch caps: the 128-level
    scan cap and chunk_levels x batch x slot width <= 184320 — so wide
    batches get shorter scans automatically."""
    e = _fused_adder_engine()  # S=4 slots per level
    assert e._max_chunk_levels(1) == 128  # length cap binds
    # batch 4096: 16384 slots per level -> 184320//16384 = 11 levels max
    assert e._max_chunk_levels(4096) == 11
    monkeypatch.setenv("HELM_TPU_DISPATCH_LANES", "32768")
    assert e._max_chunk_levels(4096) == 2
    monkeypatch.setenv("HELM_TPU_MAXC", "64")
    assert e._max_chunk_levels(1) == 64
    monkeypatch.delenv("HELM_TPU_DISPATCH_LANES")
    monkeypatch.delenv("HELM_TPU_MAXC")
    # chunking respects the clamp and pads the tail with no-op levels
    e._chunk_cache.clear()
    chunks = e._chunks_for_batch(4096)
    assert all(c["slot_in"].shape[0] <= 12 for c in chunks)
    assert sum(c["slot_in"].shape[0] for c in chunks) >= len(e.plan.levels)


def test_batch_chunking_matches_unfused(monkeypatch):
    """Batch-dependent chunk splits are semantically invisible: a batch-3
    fused evaluation forced into multiple tiny scan chunks decrypts to
    the same outputs as the unfused engine."""
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    rng = np.random.default_rng(5)
    batch = [
        {w: bool(rng.integers(0, 2)) for w in nl.inputs} for _ in range(3)
    ]
    e1 = BooleanEngine(
        mode="gates", params=P.TEST_PARAMS, seed=9, fuse_levels=False
    )
    e1.compile(nl)
    out1 = e1.decrypt_outputs(e1.evaluate(e1.encrypt_inputs(batch)))
    monkeypatch.setenv("HELM_TPU_DISPATCH_LANES", "24")  # -> 2-level chunks
    e2 = BooleanEngine(
        mode="gates", params=P.TEST_PARAMS, seed=9, fuse_levels=True
    )
    e2.compile(nl)
    assert e2._max_chunk_levels(3) == 2
    out2 = e2.decrypt_outputs(e2.evaluate(e2.encrypt_inputs(batch)))
    assert out1 == out2


def test_real_slots_count_gate_work():
    """Plan levels count real PBS slots apart from pow2 padding."""
    e = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=3)
    e.compile(read_verilog_file("benchmarks/netlists/2-bit-adder.v"))
    lps = e.plan.levels
    assert all(lp.real_slots <= lp.num_slots for lp in lps)
    assert sum(lp.real_slots for lp in lps) == 10  # 2-bit adder gates
