"""pbs_jnp.bootstrap against a numpy schoolbook bootstrap, bit for bit.

The reference below is written from the TFHE definitions alone: mod
switch, blind rotation by CMux (or the multi-bit sum over key subsets),
sample extract and keyswitch, with every negacyclic product computed as
an exact integer convolution and reduced mod 2^32. It shares no code
with the pipeline under test, whose NTT/CRT arithmetic must reproduce
those integers exactly. The bootstrap key enters in coefficient form
(server_key.bsk_coefficients, from the same seeded key stream), the
keyswitch key as the integer it stores in int8 limbs.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chip_smoke import pbs_inputs
from helm_tpu import params as P
from helm_tpu.fhe import lwe, pbs_jnp, server_key

Q = 1 << 32

_TINY_N2048 = P.TfheParams(
    name="test_tiny_n2048", n=8, k=1, N=2048, pbs_base_log=8, pbs_level=2,
    ks_base_log=4, ks_level=4, lwe_noise_std=0.0, glwe_noise_std=0.0,
    msg_space_log=5, message_bits=2,
)

#: geometry -> (params, LUT mode with per-gate test polys?)
GEOMETRIES = {
    "single-bit": (P.TEST_PARAMS, False),
    "mb2": (P.TEST_PARAMS_MB, False),
    "mb4": (P.TEST_PARAMS_MB4, False),
    "k3": (P.TEST_PARAMS_K3, False),
    "n2048": (_TINY_N2048, False),
    "n2048-mb2": (replace(_TINY_N2048, name="test_tiny_n2048_mb2",
                          grouping=2), False),
    "lut": (P.TEST_PARAMS_LUT, True),
    "lut-mb2": (P.TEST_PARAMS_LUT_MB, True),
    "approx-mask-k3": (replace(P.TEST_PARAMS_K3, pbs_mask_base_log=13,
                               pbs_mask_level=1), False),
}


# ----------------------------------------------------------------------
# the schoolbook reference (numpy int64, values mod 2^32)
# ----------------------------------------------------------------------


def _round_top(v, bits: int):
    """v (int64 in [0, 2^32)) rounded to its top `bits` bits."""
    if bits >= 32:
        return v
    return ((v + (1 << (31 - bits))) >> (32 - bits)) % (1 << bits)


def ref_mod_switch(v, N: int):
    return _round_top(v, int(np.log2(2 * N)))


def ref_decompose(v, base_log: int, levels: int) -> list:
    """Signed digits in [-B/2, B/2), level 0 most significant."""
    B = 1 << base_log
    r = _round_top(v, base_log * levels)
    digits = []
    for _ in range(levels):
        d = r % B
        r = r // B
        carry = d >= B // 2
        digits.append(np.where(carry, d - B, d))
        r = r + carry
    return digits[::-1]


def ref_monomial(poly, r: int):
    """X^r * poly mod (X^N + 1), r in [0, 2N)."""
    N = poly.shape[-1]
    sign = 1
    if r >= N:
        r, sign = r - N, -1
    out = np.concatenate([-poly[..., N - r:], poly[..., : N - r]], axis=-1)
    return (sign * out) % Q


def ref_negacyclic(small, big):
    """Exact negacyclic product of a small-digit poly and a u32 poly."""
    N = small.shape[-1]
    c = np.convolve(small.astype(np.int64), big.astype(np.int64))
    out = c[:N].copy()
    out[: N - 1] -= c[N:]
    return out % Q


def ref_external_product(p, acc, ggsw):
    """sum_r dec(acc)_r * ggsw[r]: acc [k+1, N], ggsw [rows, k+1, N]."""
    rows = []
    for c, (bl, lv) in enumerate(p.component_gadgets):
        rows += ref_decompose(acc[c], bl, lv)
    out = np.zeros_like(acc)
    for d, row in zip(rows, ggsw):
        for c in range(p.k + 1):
            out[c] = (out[c] + ref_negacyclic(d, row[c])) % Q
    return out


def ref_bootstrap(p, bsk_coef, ksk, lwe_in, testv):
    """One LWE row -> one LWE row; bsk_coef from bsk_coefficients, ksk
    the u32 keyswitch key [kN*ks_level, n+1]."""
    n, N, k, g = p.n, p.N, p.k, p.grouping
    x = lwe_in.astype(np.int64)
    abar = ref_mod_switch(x[:n], N)
    bbar = int(ref_mod_switch(x[n], N))
    acc = np.zeros((k + 1, N), np.int64)
    acc[k] = ref_monomial(testv.astype(np.int64), (2 * N - bbar) % (2 * N))
    if g == 1:
        for i in range(n):
            rot = (ref_monomial(acc, int(abar[i])) - acc) % Q
            acc = (acc + ref_external_product(p, rot, bsk_coef[i])) % Q
    else:
        for j in range(n // g):
            a = [int(v) for v in abar[j * g:(j + 1) * g]]
            # E = sum_v prod_{i in v} (X^a_i - 1) * GGSW_v
            e = np.zeros(bsk_coef.shape[2:], np.int64)
            for v in range(1, 1 << g):
                t = bsk_coef[j, v - 1].astype(np.int64)
                for i in range(g):
                    if (v >> i) & 1:
                        t = (ref_monomial(t, a[i]) - t) % Q
                e = (e + t) % Q
            acc = (acc + ref_external_product(p, acc, e)) % Q
    # sample extract: coefficient 0 under the flattened GLWE key
    mask = np.concatenate(
        [np.concatenate([acc[c, :1], -acc[c, :0:-1]]) for c in range(k)]
    ) % Q
    body = acc[k, 0]
    # keyswitch: b - sum_ij dec(a_i)_j * KSK[i*l + j]
    d = np.stack(ref_decompose(mask, p.ks_base_log, p.ks_level), axis=1)
    out = -(d.reshape(-1) @ ksk.astype(np.int64)) % Q
    out[n] = (out[n] + body) % Q
    return out.astype(np.uint32)


def ksk_from_limbs(limbs):
    """The u32 keyswitch key that int8 limbs [4, rows, n+1] encode."""
    v = sum(limbs[i].astype(np.int64) << (8 * i) for i in range(4))
    return v % Q


# ----------------------------------------------------------------------


_KEYS: dict = {}


def _keys(geom: str):
    if geom not in _KEYS:
        p, _ = GEOMETRIES[geom]
        sk = server_key.gen_server_key(lwe.keygen(p, seed=17))
        # same seed, same key stream: the coefficient rows behind sk
        coef = server_key.bsk_coefficients(lwe.keygen(p, seed=17))
        _KEYS[geom] = (p, lwe.keygen(p, seed=17), sk, coef)
    return _KEYS[geom]


@pytest.mark.parametrize("G", [1, 5, 11], ids=lambda g: f"G{g}")
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_bootstrap_matches_schoolbook(geom, G):
    p, ck, sk, coef = _keys(geom)
    lut = GEOMETRIES[geom][1]
    x, tv, expect = pbs_inputs(p, ck, G, np.random.default_rng(G), lut)
    dsk = pbs_jnp.DeviceServerKey.from_host(sk)
    got = np.asarray(
        jax.jit(pbs_jnp.bootstrap)(dsk, jnp.asarray(x), jnp.asarray(tv))
    )
    ksk = ksk_from_limbs(sk.ksk_limbs)
    ref = np.stack([
        ref_bootstrap(p, coef, ksk, x[i], tv[i if tv.shape[0] > 1 else 0])
        for i in range(G)
    ])
    np.testing.assert_array_equal(got, ref)
    # and the reference itself decrypts to the gate's value
    ph = lwe.decrypt_phase(ck, ref)
    dec = lwe.decode_msg(p, ph) if lut else lwe.decode_bool(ph)
    np.testing.assert_array_equal(dec, expect)


@pytest.mark.parametrize(
    "p",
    [P.GATES_128_K3, P.LUT_128_K2, P.ARITH_128_MB2, P.GATES_128_MB2],
    ids=lambda p: p.name,
)
def test_keyswitch_int8_limbs_match_int64_product(p):
    """The int8-limb keyswitch (int32 accumulation) equals the int64
    product at the real shapes of the 128-bit sets."""
    rng = np.random.default_rng(3)
    rows = p.big_n * p.ks_level
    ksk = rng.integers(0, Q, (rows, p.n + 1), dtype=np.uint32)
    limbs = server_key._balanced_limbs(ksk)
    ksk64 = ksk_from_limbs(limbs)
    np.testing.assert_array_equal(ksk64, ksk)
    big = rng.integers(0, Q, (3, p.big_n + 1), dtype=np.uint32)
    dsk = pbs_jnp.DeviceServerKey(p, None, None, None, jnp.asarray(limbs))
    got = np.asarray(jax.jit(pbs_jnp.keyswitch)(dsk, jnp.asarray(big)))
    for i in range(big.shape[0]):
        x = big[i].astype(np.int64)
        d = np.stack(ref_decompose(x[: p.big_n], p.ks_base_log, p.ks_level),
                     axis=1)
        ref = -(d.reshape(-1) @ ksk64) % Q
        ref[p.n] = (ref[p.n] + x[p.big_n]) % Q
        np.testing.assert_array_equal(got[i], ref.astype(np.uint32))


def test_keyswitch_int32_accumulation_bound():
    """Every set's int8 x int8 limb products sum below 2^31 in int32:
    kN * ks_level digits of |d| <= B/2 <= 128 times limbs >= -128."""
    for p in P.ALL_PARAMS.values():
        half_base = min(1 << (p.ks_base_log - 1), 128)
        assert p.big_n * p.ks_level * half_base * 128 < 1 << 31, p.name
