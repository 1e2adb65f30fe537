"""Exact negacyclic NTT over the 4-prime CRT ring, in wrapping uint32.

Backend-agnostic: every function takes an array namespace `xp` (numpy or
jax.numpy). All arithmetic is uint32; every modular multiply is a Shoup
multiply against a precomputed table (modring.py), so the same code is the
correctness reference (numpy / jnp-CPU) and the accelerator compute path
(jnp under jit).

Shapes: data arrays are [..., NP, N] with the prime axis second-to-last so a
stage reshape [..., NP, m, 2, t] stays contiguous. Forward = merged-psi
Cooley-Tukey DIT (natural -> bit-reversed); inverse = Gentleman-Sande
(bit-reversed -> natural) with a final N^-1 scale. Pointwise products happen
in the bit-reversed domain.
"""

from __future__ import annotations

import numpy as np

from .modring import NUM_PRIMES, SHOUP_SHIFT, NttTables


def _u32(xp, x):
    return x.astype(xp.uint32)


def mul_shoup(xp, a, w, w_sh, p):
    """(a * w) mod p with precomputed w_sh = floor(w*2^16/p). Exact.

    Requires a <= 2^16 (true for reduced residues of any of our primes).
    Intermediate u32 overflow is harmless: only the small remainder survives.
    """
    q = (a * w_sh) >> SHOUP_SHIFT
    r = a * w - q * p
    return xp.where(r >= p, r - p, r)


def add_mod(xp, a, b, p):
    r = a + b
    return xp.where(r >= p, r - p, r)


def sub_mod(xp, a, b, p):
    r = a - b
    return xp.where(a < b, r + p, r)


def reduce_small_sum(xp, r, p, max_mult: int):
    """Reduce r < max_mult*p to [0, p) by conditional subtractions."""
    m = 1
    while m * 2 < max_mult:
        m *= 2
    while m >= 1:
        mp = p * xp.uint32(m)
        r = xp.where(r >= mp, r - mp, r)
        m //= 2
    return r


def _bcast_tables(xp, tab: NttTables):
    primes = xp.asarray(tab.primes).reshape(NUM_PRIMES, 1, 1)
    return primes


def ntt_fwd(xp, x, tab: NttTables):
    """Forward negacyclic NTT. x: uint32[..., NP, N] reduced mod primes."""
    N = tab.N
    lead = x.shape[:-2]
    psi = xp.asarray(tab.psi_rev)
    psi_sh = xp.asarray(tab.psi_rev_sh)
    p3 = _bcast_tables(xp, tab)
    m, t = 1, N
    while m < N:
        t //= 2
        v = x.reshape(lead + (NUM_PRIMES, m, 2, t))
        s = psi[:, m : 2 * m].reshape(NUM_PRIMES, m, 1)
        s_sh = psi_sh[:, m : 2 * m].reshape(NUM_PRIMES, m, 1)
        u = v[..., 0, :]
        w = mul_shoup(xp, v[..., 1, :], s, s_sh, p3)
        x = xp.stack(
            [add_mod(xp, u, w, p3), sub_mod(xp, u, w, p3)], axis=-2
        ).reshape(lead + (NUM_PRIMES, N))
        m *= 2
    return x


def ntt_inv(xp, x, tab: NttTables):
    """Inverse negacyclic NTT (consumes bit-reversed order)."""
    N = tab.N
    lead = x.shape[:-2]
    psi = xp.asarray(tab.psi_inv_rev)
    psi_sh = xp.asarray(tab.psi_inv_rev_sh)
    p3 = _bcast_tables(xp, tab)
    t, m = 1, N
    while m > 1:
        h = m // 2
        v = x.reshape(lead + (NUM_PRIMES, h, 2, t))
        s = psi[:, h : 2 * h].reshape(NUM_PRIMES, h, 1)
        s_sh = psi_sh[:, h : 2 * h].reshape(NUM_PRIMES, h, 1)
        u = v[..., 0, :]
        w = v[..., 1, :]
        x = xp.stack(
            [
                add_mod(xp, u, w, p3),
                mul_shoup(xp, sub_mod(xp, u, w, p3), s, s_sh, p3),
            ],
            axis=-2,
        ).reshape(lead + (NUM_PRIMES, N))
        t *= 2
        m = h
    ninv = xp.asarray(tab.n_inv).reshape(NUM_PRIMES, 1)
    ninv_sh = xp.asarray(tab.n_inv_sh).reshape(NUM_PRIMES, 1)
    p2 = xp.asarray(tab.primes).reshape(NUM_PRIMES, 1)
    return mul_shoup(xp, x, ninv, ninv_sh, p2)


def to_residues(xp, x_u32, tab: NttTables):
    """Balanced-signed residues of uint32 values: [..., N] -> [..., NP, N].

    Values are interpreted as signed representatives in [-2^31, 2^31).
    """
    primes = xp.asarray(tab.primes).reshape(NUM_PRIMES, 1)
    x = x_u32[..., None, :]
    # balanced: v >= 2^31 represents v - 2^32; v - 2^32 === v - (2^32 mod p)
    q_mod_p = xp.asarray(
        np.array([(1 << 32) % int(p) for p in tab.primes], dtype=np.uint32)
    ).reshape(NUM_PRIMES, 1)
    neg = x >= xp.uint32(1 << 31)
    r = _u32(xp, x % primes)
    r_neg = xp.where(r < q_mod_p, r + primes - q_mod_p, r - q_mod_p)
    return xp.where(neg, r_neg, r)


def digits_to_residues(xp, d_i32, primes_col):
    """Signed gadget digits (int32, |d| <= 2^15) -> residues [..., NP, N].

    Exact for any digit magnitude up to the approximate-gadget mask base
    2^16 (digits +-2^15), which EXCEEDS the smallest NTT prime (12289) —
    a single conditional add is not enough there, so reduce fully
    (floor-mod with a positive divisor is non-negative in numpy/jnp)."""
    d = d_i32[..., None, :]
    return _u32(xp, d % primes_col.astype(xp.int32))


def garner_to_u32(xp, r, tab: NttTables):
    """Residues [..., NP, N] -> exact signed value mod 2^32 ([..., N] uint32)."""
    g = tab.garner
    p0, p1, p2, p3 = (int(p) for p in tab.primes)
    r0 = r[..., 0, :]
    r1 = r[..., 1, :]
    r2 = r[..., 2, :]
    r3 = r[..., 3, :]
    u32 = xp.uint32

    def ms(a, w, w_sh, p):
        return mul_shoup(xp, a, u32(w), u32(w_sh), u32(p))

    # v1 = (r1 - v0) * inv(p0) mod p1   (v0 = r0 < p0 < p1)
    v0 = r0
    t1 = sub_mod(xp, r1, v0 % u32(p1), u32(p1))
    v1 = ms(t1, g.inv_p0_mod_p1, g.inv_p0_mod_p1_sh, p1)
    # v2 = (r2 - v0 - v1*p0) * inv(p0*p1) mod p2
    m2 = add_mod(xp, v0 % u32(p2), ms(v1, g.p0_mod_p2, g.p0_mod_p2_sh, p2), u32(p2))
    t2 = sub_mod(xp, r2, m2, u32(p2))
    v2 = ms(t2, g.inv_p01_mod_p2, g.inv_p01_mod_p2_sh, p2)
    # v3 = (r3 - v0 - v1*p0 - v2*p0*p1) * inv(p0*p1*p2) mod p3
    m3 = add_mod(xp, v0 % u32(p3), ms(v1, g.p0_mod_p3, g.p0_mod_p3_sh, p3), u32(p3))
    m3 = add_mod(xp, m3, ms(v2, g.p01_mod_p3, g.p01_mod_p3_sh, p3), u32(p3))
    t3 = sub_mod(xp, r3, m3, u32(p3))
    v3 = ms(t3, g.inv_p012_mod_p3, g.inv_p012_mod_p3_sh, p3)
    # wrapping-u32 Horner evaluation == value mod 2^32
    x = v0 + u32(p0) * (v1 + u32(p1) * (v2 + u32(p2) * v3))
    # balanced lift: the true value is negative iff the top digit is large
    return xp.where(v3 > u32(g.half_p3), x - u32(g.prod_mod_q), x)


def negacyclic_mul_u32(xp, a_u32, b_u32, tab: NttTables):
    """Exact negacyclic product mod 2^32 of [..., N] uint32 polys (test/ref)."""
    ra = ntt_fwd(xp, to_residues(xp, a_u32, tab), tab)
    rb = ntt_fwd(xp, to_residues(xp, b_u32, tab), tab)
    primes = xp.asarray(tab.primes).reshape(NUM_PRIMES, 1)
    # generic modmul (no Shoup precompute available for rb): use 16-bit split
    rr = _generic_modmul(xp, ra, rb, primes)
    return garner_to_u32(xp, ntt_inv(xp, rr, tab), tab)


def _generic_modmul(xp, a, b, p):
    """(a*b) mod p for a,b < p <= 2^16+1 without precomputation (slow path)."""
    # 64-bit-free: split b = bh*2^8 + bl; a*bh < 2^25, reduce, shift, add.
    bh = b >> 8
    bl = b & xp.uint32(0xFF)
    t = (a * bh) % p  # a*bh <= 2^16 * 2^9 fits u32 exactly? a<=2^16, bh<2^9 -> <2^25 ok
    t = ((t << 8) % p + (a * bl) % p) % p
    return t
