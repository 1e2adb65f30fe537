"""Arithmetic-mode tests: radix ops and the chi-squared benchmark.

Mirrors reference tests/circuit_test.rs:315-474 (chi-squared with recorded
vectors) but checks against the arithmetic plaintext oracle at several
precisions and input sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from helm_tpu import params as P
from helm_tpu.fhe import lwe
from helm_tpu.circuit.graph import Circuit
from helm_tpu.circuit.verilog import parse_verilog, read_verilog_file
from helm_tpu.engines.arith import ArithEngine
from helm_tpu.engines.radix import RadixOps, trivial_blocks


@pytest.fixture(scope="module")
def engine_u8():
    return ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=5)


def _roundtrip(engine, vals):
    cts = np.stack([engine._encrypt_value(v) for v in vals])
    return [engine._decrypt_value(ct) for ct in cts]


def test_radix_encrypt_decrypt(engine_u8):
    vals = [0, 1, 100, 255]
    assert _roundtrip(engine_u8, vals) == vals


def test_radix_primitives(engine_u8):
    import jax.numpy as jnp

    e = engine_u8
    ops = e.ops
    xs = [17, 250, 3, 200]
    ys = [5, 10, 77, 200]
    x = jnp.asarray(np.stack([e._encrypt_value(v) for v in xs]))
    y = jnp.asarray(np.stack([e._encrypt_value(v) for v in ys]))
    add = ops.add(x, y)
    sub = ops.sub(x, y)
    mul = ops.mul(x, y)
    for i in range(len(xs)):
        assert e._decrypt_value(np.asarray(add[i])) == (xs[i] + ys[i]) % 256
        assert e._decrypt_value(np.asarray(sub[i])) == (xs[i] - ys[i]) % 256
        assert e._decrypt_value(np.asarray(mul[i])) == (xs[i] * ys[i]) % 256


def test_bootstrap_multi_width_cap(engine_u8, monkeypatch):
    """Oversized merged launches split into capped sub-launches that are
    bit-identical to the single launch (HELM_TPU_MAX_G, the arith analog
    of the fused-scan dispatch bound)."""
    from helm_tpu.engines import radix

    e = engine_u8
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 256, 16)
    pres = [jnp.asarray(np.stack([e._encrypt_value(int(v)) for v in vals]))
            .reshape(-1, e.params.n + 1)]
    tv = jnp.asarray(
        radix.pbs_jnp.lut_test_poly(
            e.params,
            np.arange(e.params.msg_space // 2, dtype=np.uint64)
            % (1 << e.params.message_bits),
        )
    )[None, :]
    tvs = [tv]
    big = radix._bootstrap_multi(e.dsk, pres, tvs)[0]
    monkeypatch.setenv("HELM_TPU_MAX_G", "8")
    n0 = radix.LAUNCHES[0]
    small = radix._bootstrap_multi(e.dsk, pres, tvs)[0]
    assert radix.LAUNCHES[0] - n0 > 1  # split into several sub-launches
    np.testing.assert_array_equal(np.asarray(big), np.asarray(small))


def test_radix_mul_plain(engine_u8):
    import jax.numpy as jnp

    e = engine_u8
    xs = [17, 250, 3, 200]
    x = jnp.asarray(np.stack([e._encrypt_value(v) for v in xs]))
    # 0/1 edge cases, powers of two (zero-bootstrap relabels), odd shifts,
    # dense constants, and truncating constants
    for c in (0, 1, 2, 4, 64, 3, 5, 171, 255, 300):
        got = e.ops.mul_plain(x, c)
        for i, v in enumerate(xs):
            assert e._decrypt_value(np.asarray(got[i])) == (v * c) % 256, (
                c, v,
            )


def test_radix_add_sub_mixed(engine_u8):
    import jax.numpy as jnp

    e = engine_u8
    xs = [200, 17, 99, 5]
    ys = [57, 250, 99, 6]
    sub = [False, True, False, True]
    x = jnp.asarray(np.stack([e._encrypt_value(v) for v in xs]))
    y = jnp.asarray(np.stack([e._encrypt_value(v) for v in ys]))
    got = e.ops.add_sub_mixed(x, y, sub)
    for i in range(4):
        exp = (xs[i] - ys[i]) % 256 if sub[i] else (xs[i] + ys[i]) % 256
        assert e._decrypt_value(np.asarray(got[i])) == exp, i


def test_arith_fused_add_sub_level(engine_u8):
    """add and sub at the SAME level go through the fused launch."""
    from helm_tpu.circuit.verilog import parse_verilog

    src = """
module m(a, b, s, d);
  input [7:0] a, b;
  output [7:0] s, d;
  add g0(a, b, s);
  sub g1(a, b, d);
endmodule
"""
    e = engine_u8
    e.compile(parse_verilog(src, is_arith=True))
    wires = e.evaluate(e.encrypt_inputs({"a": 77, "b": 200}))
    out = e.decrypt_outputs(wires)
    assert out["s"] == (77 + 200) % 256
    assert out["d"] == (77 - 200) % 256


def test_radix_shift_plain_many(engine_u8):
    import jax.numpy as jnp

    e = engine_u8
    xs = [0x5A, 0xFF, 0x01, 0x80, 0x33]
    amounts = [0, 1, 3, 4, 9]  # even, odd, mixed relabels, >= width
    x = jnp.asarray(np.stack([e._encrypt_value(v) for v in xs]))
    for left in (True, False):
        got = e.ops.shift_plain_many(x, amounts, left)
        for i, (v, a) in enumerate(zip(xs, amounts)):
            exp = (v << a) % 256 if left else v >> a
            if a >= 8:
                exp = 0
            assert e._decrypt_value(np.asarray(got[i])) == exp, (left, v, a)


def test_radix_div(engine_u8):
    import jax.numpy as jnp

    e = engine_u8
    xs = [100, 255, 7]
    ys = [7, 16, 9]
    x = jnp.asarray(np.stack([e._encrypt_value(v) for v in xs]))
    y = jnp.asarray(np.stack([e._encrypt_value(v) for v in ys]))
    div = e.ops.div(x, y)
    for i in range(len(xs)):
        assert e._decrypt_value(np.asarray(div[i])) == xs[i] // ys[i]


def test_radix_shifts(engine_u8):
    import jax.numpy as jnp

    e = engine_u8
    x = jnp.asarray(np.stack([e._encrypt_value(v) for v in [0b10110101, 3]]))
    for s in [0, 1, 3, 6]:
        shl = e.ops.shift_plain(x, s, True)
        shr = e.ops.shift_plain(x, s, False)
        assert e._decrypt_value(np.asarray(shl[0])) == (0b10110101 << s) % 256
        assert e._decrypt_value(np.asarray(shr[0])) == 0b10110101 >> s
    # encrypted shift amount
    y = jnp.asarray(np.stack([e._encrypt_value(v) for v in [2, 5]]))
    shl = e.ops.shift_ct(x, y, True)
    assert e._decrypt_value(np.asarray(shl[0])) == (0b10110101 << 2) % 256
    assert e._decrypt_value(np.asarray(shl[1])) == (3 << 5) % 256


ARITH_SRC = """
module m(a, b, s, d, p, q);
  input [7:0] a, b;
  output [7:0] s, d, p, q;
  add g0(a, b, s);
  sub g1(a, b, d);
  mult g2(a, 3, p);
  add g3(7, b, q);
endmodule
"""


def test_arith_engine_with_plain_operands(engine_u8):
    nl = parse_verilog(ARITH_SRC, True)
    e = engine_u8
    e.compile(nl)
    inputs = {"a": 23, "b": 190}
    wires = e.evaluate(e.encrypt_inputs(inputs))
    out = e.decrypt_outputs(wires)
    c = Circuit.from_netlist(parse_verilog(ARITH_SRC, True))
    exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, inputs, default=0), 8)
    for w in ("s", "d", "p", "q"):
        assert out[w] == exp[w], w


def test_arith_batched_serving(engine_u8):
    """A list of input maps evaluates in one pass; every vector decrypts
    to its own oracle result (the arith analog of boolean batched serving)."""
    nl = parse_verilog(ARITH_SRC, True)
    e = engine_u8
    e.compile(nl)
    vecs = [
        {"a": 23, "b": 190},
        {"a": 0, "b": 255},
        {"a": 101, "b": 3},
    ]
    outs = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(vecs)))
    assert isinstance(outs, list) and len(outs) == 3
    c = Circuit.from_netlist(parse_verilog(ARITH_SRC, True))
    for inputs, out in zip(vecs, outs):
        exp = c.evaluate_arith(
            c.initialize_wire_map(nl.wire_set, inputs, default=0), 8
        )
        for w in ("s", "d", "p", "q"):
            assert out[w] == exp[w], (inputs, w)


def test_dataflow_scheduler_launch_count(engine_u8):
    """The dataflow scheduler merges every round's PBS requests across all
    runnable gates, so total launches track the critical-path depth in
    bootstrap rounds — for chi-squared u8 that is well under the sum of
    per-level per-op-type chains (~35 with level-group batching)."""
    from helm_tpu.engines import radix

    nl = read_verilog_file("benchmarks/netlists/chi_squared_arith.v", True)
    e = engine_u8
    e.compile(nl)
    inputs = {"n0": 10, "n1": 20, "n2": 30}
    w = e.encrypt_inputs(inputs)
    radix.LAUNCHES[0] = 0
    out = e.decrypt_outputs(e.evaluate(w))
    assert radix.LAUNCHES[0] <= 28, radix.LAUNCHES[0]
    c = Circuit.from_netlist(nl)
    exp = c.evaluate_arith(
        c.initialize_wire_map(nl.wire_set, inputs, default=0), 8
    )
    for k in out:
        assert out[k] == exp[k], k


def test_chi_squared_u8():
    nl = read_verilog_file("benchmarks/netlists/chi_squared_arith.v", True)
    e = ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=6)
    e.compile(nl)
    c = Circuit.from_netlist(read_verilog_file("benchmarks/netlists/chi_squared_arith.v", True))
    inputs = {"n0": 2, "n1": 7, "n2": 9}
    exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, inputs, default=0), 8)
    out = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(inputs)))
    for w in ("alpha", "beta1", "beta2", "beta3"):
        assert out[w] == exp[w], w


def test_box_blur_u8():
    """Box blur (RUNNING.md blur family): adds + plaintext-divisor division."""
    nl = read_verilog_file("benchmarks/netlists/box_blur_arith.v", True)
    e = ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=9)
    e.compile(nl)
    pix = {"p0": 10, "p1": 40, "p2": 70, "p3": 100, "p4": 130, "p5": 160}
    out = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(pix)))
    c = Circuit.from_netlist(read_verilog_file("benchmarks/netlists/box_blur_arith.v", True))
    exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, pix, default=0), 8)
    for w in ("b1", "b2", "b3", "b4"):
        assert out[w] == exp[w], w


def test_euclidean_and_mmult_u8():
    """Euclidean distance and matrix-multiply families (RUNNING.md)."""
    for path, inputs, outs in [
        (
            "benchmarks/netlists/euclidean_arith.v",
            {"a0": 9, "a1": 4, "a2": 7, "a3": 1, "b0": 3, "b1": 8, "b2": 2, "b3": 5},
            ["dist"],
        ),
        (
            "benchmarks/netlists/mmult2_arith.v",
            {"a00": 2, "a01": 3, "a10": 5, "a11": 7, "b00": 1, "b01": 4, "b10": 6, "b11": 2},
            ["c00", "c01", "c10", "c11"],
        ),
    ]:
        nl = read_verilog_file(path, True)
        e = ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=12)
        e.compile(nl)
        out = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(inputs)))
        c = Circuit.from_netlist(read_verilog_file(path, True))
        exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, inputs, default=0), 8)
        for w in outs:
            assert out[w] == exp[w], (path, w)


def test_gaussian_blur_u8():
    """Gaussian blur (RUNNING.md blur family): weighted window sums via
    plain shifts, /16 via shr."""
    nl = read_verilog_file("benchmarks/netlists/gaussian_blur_arith.v", True)
    e = ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=15)
    e.compile(nl)
    rng = np.random.default_rng(8)
    # pixels < 16 so the weighted sum (max 16*15) stays inside u8 — the
    # direct-formula cross-check below assumes no mod-256 wrap
    pix = {
        f"p{r}{c}": int(rng.integers(0, 16)) for r in range(3) for c in range(4)
    }
    out = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(pix)))
    c = Circuit.from_netlist(
        read_verilog_file("benchmarks/netlists/gaussian_blur_arith.v", True)
    )
    exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, pix, default=0), 8)
    for w in ("g1", "g2"):
        assert out[w] == exp[w], w
    # cross-check the oracle against the direct formula
    k = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]
    for name, c0 in (("g1", 0), ("g2", 1)):
        acc = sum(
            k[r][cc] * pix[f"p{r}{cc + c0}"] for r in range(3) for cc in range(3)
        )
        assert exp[name] == (acc // 16) % 256, name


def test_euclidean32_oracle_and_encrypted():
    """euclidean n=32 (the RUNNING.md size): oracle check at u32, plus an
    encrypted u8 run with the dataflow scheduler."""
    import random

    rnd = random.Random(4)
    nl = read_verilog_file("benchmarks/netlists/euclidean32_arith.v", True)
    c = Circuit.from_netlist(nl)
    a = [rnd.randrange(1000) for _ in range(32)]
    b = [rnd.randrange(1000) for _ in range(32)]
    ins = {f"a{i}": a[i] for i in range(32)}
    ins |= {f"b{i}": b[i] for i in range(32)}
    wm = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, ins, default=0), 32)
    assert wm["dist"] == sum((x - y) ** 2 for x, y in zip(a, b)) % 2**32
    e = ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=12)
    e.compile(nl)
    ins8 = {k: v % 16 for k, v in ins.items()}
    out = e.decrypt_outputs(e.evaluate(e.encrypt_inputs(ins8)))
    exp = c.evaluate_arith(
        c.initialize_wire_map(nl.wire_set, ins8, default=0), 8
    )
    assert out["dist"] == exp["dist"]


def test_mmult5_oracle():
    """5x5 encrypted matrix-multiply netlist (mmult family, RUNNING.md
    sizes) against the arithmetic oracle."""
    import random

    rnd = random.Random(9)
    nl = read_verilog_file("benchmarks/netlists/mmult5_arith.v", True)
    c = Circuit.from_netlist(nl)
    A = [[rnd.randrange(100) for _ in range(5)] for _ in range(5)]
    B = [[rnd.randrange(100) for _ in range(5)] for _ in range(5)]
    ins = {f"a{i}_{l}": A[i][l] for i in range(5) for l in range(5)}
    ins |= {f"b{l}_{j}": B[l][j] for l in range(5) for j in range(5)}
    wm = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, ins, default=0), 32)
    for i in range(5):
        for j in range(5):
            assert wm[f"c{i}_{j}"] == sum(
                A[i][l] * B[l][j] for l in range(5)
            ) % 2**32, (i, j)


def test_euclidean64_oracle():
    """euclidean n=64 (the larger RUNNING.md size) against the oracle."""
    import random

    rnd = random.Random(11)
    nl = read_verilog_file("benchmarks/netlists/euclidean64_arith.v", True)
    c = Circuit.from_netlist(nl)
    a = [rnd.randrange(1000) for _ in range(64)]
    b = [rnd.randrange(1000) for _ in range(64)]
    ins = {f"a{i}": a[i] for i in range(64)}
    ins |= {f"b{i}": b[i] for i in range(64)}
    wm = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, ins, default=0), 32)
    assert wm["dist"] == sum((x - y) ** 2 for x, y in zip(a, b)) % 2**32


@pytest.mark.parametrize("k", [10, 15])
def test_mmult_large_oracle(k):
    """10x10 and 15x15 matrix multiplies (mmult family, RUNNING.md runs
    5x5..15x15) against the arithmetic oracle."""
    import random

    rnd = random.Random(k)
    nl = read_verilog_file(f"benchmarks/netlists/mmult{k}_arith.v", True)
    c = Circuit.from_netlist(nl)
    A = [[rnd.randrange(100) for _ in range(k)] for _ in range(k)]
    B = [[rnd.randrange(100) for _ in range(k)] for _ in range(k)]
    ins = {f"a{i}_{l}": A[i][l] for i in range(k) for l in range(k)}
    ins |= {f"b{l}_{j}": B[l][j] for l in range(k) for j in range(k)}
    wm = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, ins, default=0), 32)
    for i in range(k):
        for j in range(k):
            assert wm[f"c{i}_{j}"] == sum(
                A[i][l] * B[l][j] for l in range(k)
            ) % 2**32, (i, j)


def test_div_plain_reciprocal(engine_u8):
    """Plain-divisor division (mul-by-reciprocal, Granlund-Montgomery):
    exact floor(x/d) for edge divisors incl. 0 (all-ones), 1, powers of
    two (pure relabels), and odd reciprocals."""
    e = engine_u8
    rng = np.random.default_rng(1)
    xs = rng.integers(0, 256, 12)
    cts = jnp.asarray(
        np.stack([np.asarray(e._encrypt_value(int(v))) for v in xs])
    )
    for d in (0, 1, 3, 4, 7, 10, 100, 255):
        q = e.ops.div_plain(cts, d)
        got = [e._decrypt_value(np.asarray(q[i])) for i in range(len(xs))]
        exp = [int(x) // d if d else 255 for x in xs]
        assert got == exp, d


def test_ge_carry_only(engine_u8):
    """Carry-only comparison (log-depth status reduction)."""
    e = engine_u8
    xs = [0, 1, 200, 255, 17, 42]
    ys = [0, 2, 200, 1, 18, 41]
    cx = jnp.asarray(np.stack([np.asarray(e._encrypt_value(v)) for v in xs]))
    cy = jnp.asarray(np.stack([np.asarray(e._encrypt_value(v)) for v in ys]))
    ge = e.ops.ge(cx, cy)
    ph = lwe.decrypt_phase(e.client_key, np.asarray(ge))
    got = [int(v) % 4 for v in lwe.decode_msg(e.params, ph)]
    assert got == [int(x >= y) for x, y in zip(xs, ys)]


def test_launch_counts_pinned(engine_u8):
    """Critical-path launch counts stay pinned: box blur rides the
    plain-divisor reciprocal path (was 130 launches with encrypted
    restoring division), chi-squared u8 the fused log-propagate."""
    from helm_tpu.engines import radix

    nl = read_verilog_file("benchmarks/netlists/box_blur_arith.v", True)
    e = engine_u8
    e.compile(nl)
    ins = {f"p{i}": 10 * (i + 1) for i in range(6)}
    w = e.encrypt_inputs(ins)
    radix.LAUNCHES[0] = 0
    out = e.decrypt_outputs(e.evaluate(w))
    assert radix.LAUNCHES[0] <= 34, radix.LAUNCHES[0]
    c = Circuit.from_netlist(nl)
    exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, ins, default=0), 8)
    for k in out:
        assert int(out[k]) == int(exp[k]), k


def test_square_symmetric_schoolbook(engine_u8):
    """Squaring bootstraps each symmetric partial product once (pool
    index listed twice in the compression columns) — fewer slots, same
    result as the full schoolbook."""
    e = engine_u8
    rng = np.random.default_rng(2)
    xs = rng.integers(0, 256, 16)
    cts = jnp.asarray(
        np.stack([np.asarray(e._encrypt_value(int(v))) for v in xs])
    )
    sq = e.ops.mul(cts, cts, square=True)
    got = [e._decrypt_value(np.asarray(sq[i])) for i in range(16)]
    assert got == [(int(x) * int(x)) % 256 for x in xs]


@pytest.mark.parametrize("typ,width", [("u64", 64), ("u128", 128)])
def test_wide_precisions(typ, width):
    """u64/u128 (32/64 radix blocks): add, mul_plain, and (u64) full mul
    — the log-depth propagate and compressor endgame at reference-claimed
    maximum widths (lib.rs:21-29 goes to U128)."""
    e = ArithEngine(typ, params=P.TEST_PARAMS_ARITH, seed=5)
    rng = np.random.default_rng(1)
    xs = [int.from_bytes(rng.bytes(width // 8), "little") for _ in range(2)]
    ys = [int.from_bytes(rng.bytes(width // 8), "little") for _ in range(2)]
    cx = jnp.asarray(np.stack([np.asarray(e._encrypt_value(v)) for v in xs]))
    cy = jnp.asarray(np.stack([np.asarray(e._encrypt_value(v)) for v in ys]))
    s = e.ops.add(cx, cy)
    m = e.ops.mul_plain(cx, 171)
    assert [e._decrypt_value(np.asarray(s[i])) for i in range(2)] == [
        (x + y) % 2**width for x, y in zip(xs, ys)
    ]
    assert [e._decrypt_value(np.asarray(m[i])) for i in range(2)] == [
        (x * 171) % 2**width for x in xs
    ]
    if typ == "u64":
        mm = e.ops.mul(cx, cy)
        assert [e._decrypt_value(np.asarray(mm[i])) for i in range(2)] == [
            (x * y) % 2**width for x, y in zip(xs, ys)
        ]
