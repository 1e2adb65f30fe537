"""Multi-bit (grouped) PBS: truth tables and LUT correctness."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from helm_tpu import params as P
from helm_tpu.fhe import lwe, pbs_jnp, server_key


@pytest.fixture(scope="module")
def mb_keys():
    p = P.TEST_PARAMS_MB
    ck = lwe.keygen(p, seed=31)
    dsk = pbs_jnp.DeviceServerKey.from_host(server_key.gen_server_key(ck))
    return p, ck, dsk


def test_multibit_bsk_shape(mb_keys):
    p, ck, dsk = mb_keys
    g = p.grouping
    rows = (p.k + 1) * p.pbs_level
    assert dsk.bsk_ntt.shape == (p.n // g, (1 << g) - 1, rows, p.k + 1, 4, p.N)


def test_multibit_gate_truth_tables(mb_keys):
    p, ck, dsk = mb_keys
    q8 = 1 << 29
    combos = [(a, b) for a in (False, True) for b in (False, True)]
    c1 = lwe.encrypt(ck, lwe.encode_bool([a for a, _ in combos]))
    c2 = lwe.encrypt(ck, lwe.encode_bool([b for _, b in combos]))
    testv = jnp.asarray(pbs_jnp.gates_test_poly(p))
    bs = jax.jit(pbs_jnp.bootstrap)
    cases = {
        "and": ((c1 + c2 - lwe.trivial(p, np.full(4, np.uint32(q8)))),
                [a and b for a, b in combos]),
        "xor": ((2 * (c1 + c2) + lwe.trivial(p, np.full(4, np.uint32(2 * q8)))),
                [a != b for a, b in combos]),
        "nor": (((0 - (c1 + c2)) - lwe.trivial(p, np.full(4, np.uint32(q8)))),
                [not (a or b) for a, b in combos]),
    }
    for name, (lin, exp) in cases.items():
        out = np.asarray(bs(dsk, jnp.asarray(lin.astype(np.uint32)), testv))
        got = list(lwe.decode_bool(lwe.decrypt_phase(ck, out)))
        assert got == exp, name


def test_k3_glwe_bootstrap_jnp_and_mxu():
    """GLWE dimension k=3 (the GATES_128_K3 production shape, tfhe-rs 0.4
    boolean DEFAULT_PARAMETERS-like — reference L0 via Cargo.toml:18):
    the jnp pipeline's AND and XOR bootstraps decrypt to the plaintext
    oracle on every input combination."""
    p = P.TEST_PARAMS_K3
    ck = lwe.keygen(p, seed=31)
    dsk = pbs_jnp.DeviceServerKey.from_host(server_key.gen_server_key(ck))
    rows = (p.k + 1) * p.pbs_level
    assert dsk.bsk_ntt.shape == (p.n // 2, 3, rows, p.k + 1, 4, p.N)
    q8 = 1 << 29
    combos = [(a, b) for a in (False, True) for b in (False, True)]
    c1 = lwe.encrypt(ck, lwe.encode_bool([a for a, _ in combos]))
    c2 = lwe.encrypt(ck, lwe.encode_bool([b for _, b in combos]))
    testv = jnp.asarray(pbs_jnp.gates_test_poly(p))
    for name, lin, exp in (
        ("and", c1 + c2 - lwe.trivial(p, np.full(4, np.uint32(q8))),
         [a and b for a, b in combos]),
        ("xor", 2 * (c1 + c2) + lwe.trivial(p, np.full(4, np.uint32(2 * q8))),
         [a != b for a, b in combos]),
    ):
        lin = jnp.asarray(lin.astype(np.uint32))
        out = np.asarray(jax.jit(pbs_jnp.bootstrap)(dsk, lin, testv))
        got = list(lwe.decode_bool(lwe.decrypt_phase(ck, out)))
        assert got == exp, name


def test_approximate_mask_gadget():
    """Approximate gadget decomposition (mask components on a wider,
    shallower gadget — the original TFHE paper's trick; see params.py):
    correct through the jnp pipeline at k=3 and k=1, including (k=1)
    base-2^15 digits that exceed the
    smallest NTT prime (the _digit_residues full-reduction path). Mask
    bases are the widest that fit the PRIMES_512 convolution bound
    (TfheParams.conv_bound; base-2^16 needs the old >=2^59 prime
    product)."""
    from dataclasses import replace

    q8 = 1 << 29
    combos = [(a, b) for a in (False, True) for b in (False, True)]
    for base, mbl in ((P.TEST_PARAMS_K3, 13), (P.TEST_PARAMS_MB, 15)):
        p = replace(base, pbs_mask_base_log=mbl, pbs_mask_level=1)
        assert p.gadget_rows == base.k * 1 + base.pbs_level
        ck = lwe.keygen(p, seed=31)
        dsk = pbs_jnp.DeviceServerKey.from_host(server_key.gen_server_key(ck))
        c1 = lwe.encrypt(ck, lwe.encode_bool([a for a, _ in combos]))
        c2 = lwe.encrypt(ck, lwe.encode_bool([b for _, b in combos]))
        testv = jnp.asarray(pbs_jnp.gates_test_poly(p))
        lin = jnp.asarray(
            (c1 + c2 - lwe.trivial(p, np.full(4, np.uint32(q8)))).astype(
                np.uint32
            )
        )
        out = np.asarray(jax.jit(pbs_jnp.bootstrap)(dsk, lin, testv))
        got = list(lwe.decode_bool(lwe.decrypt_phase(ck, out)))
        assert got == [a and b for a, b in combos], p.name


@pytest.mark.slow
def test_gates_128_k3_end_to_end():
    """The k=3 128-bit gates set bootstraps correctly with real noise."""
    p = P.GATES_128_K3
    ck = lwe.keygen(p, seed=78)
    dsk = pbs_jnp.DeviceServerKey.from_host(server_key.gen_server_key(ck))
    q8 = 1 << 29
    combos = [(a, b) for a in (False, True) for b in (False, True)]
    c1 = lwe.encrypt(ck, lwe.encode_bool([a for a, _ in combos]))
    c2 = lwe.encrypt(ck, lwe.encode_bool([b for _, b in combos]))
    testv = jnp.asarray(pbs_jnp.gates_test_poly(p))
    bs = jax.jit(pbs_jnp.bootstrap)
    for name, lin, exp in (
        ("and", c1 + c2 - lwe.trivial(p, np.full(4, np.uint32(q8))),
         [a and b for a, b in combos]),
        ("xor", 2 * (c1 + c2) + lwe.trivial(p, np.full(4, np.uint32(2 * q8))),
         [a != b for a, b in combos]),
    ):
        out = np.asarray(bs(dsk, jnp.asarray(lin.astype(np.uint32)), testv))
        got = list(lwe.decode_bool(lwe.decrypt_phase(ck, out)))
        assert got == exp, name


@pytest.mark.slow
def test_gates_128_set_end_to_end():
    """The hardened 128-bit gates set (SECURITY.md) bootstraps correctly
    with real noise: all four input combos of AND and XOR (XOR is the
    worst-case linear growth the failure model pins at 2^-74)."""
    p = P.GATES_128_MB2
    ck = lwe.keygen(p, seed=77)
    dsk = pbs_jnp.DeviceServerKey.from_host(server_key.gen_server_key(ck))
    q8 = 1 << 29
    combos = [(a, b) for a in (False, True) for b in (False, True)]
    c1 = lwe.encrypt(ck, lwe.encode_bool([a for a, _ in combos]))
    c2 = lwe.encrypt(ck, lwe.encode_bool([b for _, b in combos]))
    testv = jnp.asarray(pbs_jnp.gates_test_poly(p))
    bs = jax.jit(pbs_jnp.bootstrap)
    for name, lin, exp in (
        ("and", c1 + c2 - lwe.trivial(p, np.full(4, np.uint32(q8))),
         [a and b for a, b in combos]),
        ("xor", 2 * (c1 + c2) + lwe.trivial(p, np.full(4, np.uint32(2 * q8))),
         [a != b for a, b in combos]),
    ):
        out = np.asarray(bs(dsk, jnp.asarray(lin.astype(np.uint32)), testv))
        got = list(lwe.decode_bool(lwe.decrypt_phase(ck, out)))
        assert got == exp, name


def test_multibit_matches_standard_phases():
    """Same circuit input bits give the same decrypted result under g=1 and
    g=2 keys (independent keys; bit-level equality of decoded outputs)."""
    rng = np.random.default_rng(9)
    bits1 = rng.integers(0, 2, 16).astype(bool)
    bits2 = rng.integers(0, 2, 16).astype(bool)
    results = {}
    for params in (P.TEST_PARAMS, P.TEST_PARAMS_MB):
        ck = lwe.keygen(params, seed=55)
        dsk = pbs_jnp.DeviceServerKey.from_host(server_key.gen_server_key(ck))
        c1 = lwe.encrypt(ck, lwe.encode_bool(bits1))
        c2 = lwe.encrypt(ck, lwe.encode_bool(bits2))
        lin = (c1 + c2).astype(np.uint32)
        lin[:, params.n] += np.uint32((1 << 29))  # OR
        out = np.asarray(
            jax.jit(pbs_jnp.bootstrap)(
                dsk,
                jnp.asarray(lin),
                jnp.asarray(pbs_jnp.gates_test_poly(params)),
            )
        )
        results[params.grouping] = list(
            lwe.decode_bool(lwe.decrypt_phase(ck, out))
        )
    assert results[1] == results[2] == list(bits1 | bits2)
