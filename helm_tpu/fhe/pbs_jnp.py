"""Batched programmable bootstrapping — pure-jnp pipeline.

One launch bootstraps G independent gates at once: this generalizes the
reference's per-level batching (rayon threads at circuit.rs:531; grouped
CUDA vector launches at circuit.rs:650-934) with a single fused path
instead of per-gate-type kernels — the gate type only changes the linear
combination and (in LUT mode) the test polynomial.

This is the one PBS path of every mode, on every device: XLA compiles it
for the GPU and the CPU alike. All arithmetic is exact integer arithmetic
(u32, int8 and int32), so every device returns the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..params import TfheParams
from . import ops
from .modring import NUM_PRIMES, NttTables, get_tables
from .ntt import (
    digits_to_residues,
    garner_to_u32,
    mul_shoup,
    ntt_fwd,
    ntt_inv,
    reduce_small_sum,
)
from .server_key import ServerKey


def decompose_glwe(p: TfheParams, x: jax.Array) -> jax.Array:
    """Signed-decompose a GLWE batch [G, k+1, N] into gadget rows
    [G, gadget_rows, N], c-major / level-minor, honoring per-component
    (approximate mask) gadgets — params.component_gadgets."""
    parts = []
    for c, (bl, lv) in enumerate(p.component_gadgets):
        dg = ops.signed_decompose(jnp, x[:, c], bl, lv)  # [lv, G, N]
        parts.append(jnp.transpose(dg, (1, 0, 2)))
    return jnp.concatenate(parts, axis=1)


@dataclass(frozen=True)
class DeviceServerKey:
    """Server key resident on device (jnp arrays) + static metadata."""

    params: TfheParams
    tab: NttTables
    bsk_ntt: jax.Array  # u32 [n, rows, k+1, NP, N]
    bsk_ntt_sh: jax.Array
    ksk_limbs: jax.Array  # i8 [4, big_n*ks_level, n+1]

    @staticmethod
    def from_host(sk: ServerKey) -> "DeviceServerKey":
        return DeviceServerKey(
            params=sk.params,
            tab=get_tables(sk.params.N),
            bsk_ntt=jnp.asarray(sk.bsk_ntt),
            bsk_ntt_sh=jnp.asarray(sk.bsk_ntt_sh),
            ksk_limbs=jnp.asarray(sk.ksk_limbs),
        )


jax.tree_util.register_pytree_node(
    DeviceServerKey,
    lambda k: ((k.bsk_ntt, k.bsk_ntt_sh, k.ksk_limbs), (k.params, k.tab)),
    lambda aux, ch: DeviceServerKey(aux[0], aux[1], *ch),
)


def blind_rotate(
    dsk: DeviceServerKey, lwe_in: jax.Array, testv: jax.Array
) -> jax.Array:
    """Blind rotation of per-gate test polys by per-gate phases.

    lwe_in: u32 [G, n+1]; testv: u32 [G, N] or [1, N].
    Returns the GLWE accumulator batch u32 [G, k+1, N].
    """
    p = dsk.params
    tab = dsk.tab
    n, N, k = p.n, p.N, p.k
    G = lwe_in.shape[0]
    rows = p.gadget_rows
    primes_col = jnp.asarray(tab.primes).reshape(NUM_PRIMES, 1)

    abar = ops.mod_switch(jnp, lwe_in[:, :n], N)  # [G, n] in [0, 2N)
    bbar = ops.mod_switch(jnp, lwe_in[:, n], N)  # [G]

    # acc = X^{-bbar} * testv  (as trivial GLWE)
    neg_b = (jnp.uint32(2 * N) - bbar) & jnp.uint32(2 * N - 1)
    body = ops.negacyclic_rotate(jnp, jnp.broadcast_to(testv, (G, N)), neg_b, N)
    acc = jnp.concatenate(
        [jnp.zeros((G, k, N), jnp.uint32), body[:, None, :]], axis=1
    )

    def step(acc, xs):
        bsk_i, bsk_sh_i, a_i = xs  # [rows,k+1,NP,N] x2, [G]
        rot = ops.negacyclic_rotate(jnp, acc, a_i[:, None], N)
        diff = rot - acc  # u32 wrap
        d = decompose_glwe(p, diff)  # [G, rows, N], c-major
        res = digits_to_residues(jnp, d, primes_col)  # [G, rows, NP, N]
        f = ntt_fwd(jnp, res, tab)
        outs = []
        for c in range(k + 1):
            s = None
            for r in range(rows):
                t = mul_shoup(
                    jnp, f[:, r], bsk_i[r, c], bsk_sh_i[r, c], primes_col
                )
                s = t if s is None else s + t
            s = reduce_small_sum(jnp, s, primes_col, rows + 1)
            outs.append(s)
        prod = jnp.stack(outs, axis=1)  # [G, k+1, NP, N]
        conv = garner_to_u32(jnp, ntt_inv(jnp, prod, tab), tab)
        return acc + conv, None

    acc, _ = jax.lax.scan(
        step, acc, (dsk.bsk_ntt, dsk.bsk_ntt_sh, abar.T), length=n
    )
    return acc


import functools


@functools.lru_cache(maxsize=None)
def monomial_tables(N: int):
    """T[b, pi, f] = psi^(2^b * e_f) mod p_pi with e_f = 2*bitrev(f)+1: the
    NTT-domain image of X^(2^b), used to build NTT(X^a) by a bit ladder.
    Returns (tables, shoup) as uint32 [log2(2N), NP, N]."""
    from .modring import primes_for, shoup as _shoup, root_of_unity, _bit_reverse

    primes = primes_for(N)
    L2N = N.bit_length()  # log2(2N)
    bits = N.bit_length() - 1
    t = np.zeros((L2N, len(primes), N), np.uint32)
    t_sh = np.zeros_like(t)
    for pi, p in enumerate(primes):
        psi = root_of_unity(p, 2 * N)
        for f in range(N):
            e = 2 * _bit_reverse(f, bits) + 1
            for b in range(L2N):
                w = pow(psi, ((1 << b) * e) % (2 * N), p)
                t[b, pi, f] = w
                t_sh[b, pi, f] = _shoup(w, p)
    return t, t_sh


def _generic_modmul_jnp(a, b, p):
    """(a*b) mod p for a,b < p <= 2^16+1, no precomputation (16-bit split)."""
    bh = b >> 8
    bl = b & jnp.uint32(0xFF)
    t = (a * bh) % p
    return ((t << 8) % p + (a * bl) % p) % p


def blind_rotate_multibit(
    dsk: DeviceServerKey, lwe_in: jax.Array, testv: jax.Array
) -> jax.Array:
    """Multi-bit blind rotation: one external product per group of g mask
    elements, with the effective GGSW assembled in the NTT domain as
    sum_v P_v(X) (.) BSK_v, P_v = prod_{i in v} (X^{a_i} - 1)."""
    p = dsk.params
    tab = dsk.tab
    g = p.grouping
    n, N, k = p.n, p.N, p.k
    groups = n // g
    G = lwe_in.shape[0]
    kp1 = k + 1
    rows = p.gadget_rows
    primes_col = jnp.asarray(tab.primes).reshape(NUM_PRIMES, 1)
    mono, mono_sh = monomial_tables(N)
    mono = jnp.asarray(mono)
    mono_sh = jnp.asarray(mono_sh)
    L2N = N.bit_length()

    abar = ops.mod_switch(jnp, lwe_in[:, :n], N)  # [G, n]
    bbar = ops.mod_switch(jnp, lwe_in[:, n], N)
    neg_b = (jnp.uint32(2 * N) - bbar) & jnp.uint32(2 * N - 1)
    body = ops.negacyclic_rotate(jnp, jnp.broadcast_to(testv, (G, N)), neg_b, N)
    acc = jnp.concatenate(
        [jnp.zeros((G, k, N), jnp.uint32), body[:, None, :]], axis=1
    )

    a_groups = abar.reshape(G, groups, g).transpose(1, 0, 2)  # [groups, G, g]

    def mono_ntt(a):
        """NTT(X^a) for per-gate exponents a [G] -> [G, NP, N]."""
        m = jnp.ones((G, NUM_PRIMES, N), jnp.uint32)
        for b in range(L2N):
            bit = ((a >> b) & 1).astype(bool)[:, None, None]
            m2 = mul_shoup(jnp, m, mono[b], mono_sh[b], primes_col)
            m = jnp.where(bit, m2, m)
        return m

    ones = jnp.ones((1, NUM_PRIMES, N), jnp.uint32)

    def step(acc, xs):
        bsk_j, bsk_sh_j, a_j = xs  # [2^g - 1, rows, kp1, NP, N] x2, [G, g]
        # subset polynomials P_v in NTT domain
        d = [
            ntt_sub_mod(mono_ntt(a_j[:, i]), ones, primes_col) for i in range(g)
        ]
        pv = {}
        for v in range(1, 1 << g):
            idxs = [i for i in range(g) if (v >> i) & 1]
            if len(idxs) == 1:
                pv[v] = d[idxs[0]]
            else:
                acc_p = d[idxs[0]]
                for i in idxs[1:]:
                    acc_p = _generic_modmul_jnp(acc_p, d[i], primes_col)
                pv[v] = acc_p
        # decompose acc and forward-NTT the rows
        dd = decompose_glwe(p, acc)  # [G, rows, N], c-major
        f = ntt_fwd(jnp, digits_to_residues(jnp, dd, primes_col), tab)
        outs = []
        for c in range(kp1):
            s = None
            for r in range(rows):
                # E[r, c] = sum_{v>=1} P_v (.) BSK_v; the empty subset
                # (GGSW of 1) is handled additively below — the
                # additive-identity CMux form, so it is never keyed,
                # loaded, or multiplied (see server_key.bsk_coefficients)
                e = None
                for v in range(1, 1 << g):
                    t = mul_shoup(
                        jnp, pv[v], bsk_j[v - 1, r, c], bsk_sh_j[v - 1, r, c],
                        primes_col,
                    )
                    e = t if e is None else e + t
                e = reduce_small_sum(jnp, e, primes_col, 1 << g)
                t = _generic_modmul_jnp(f[:, r], e, primes_col)
                s = t if s is None else s + t
            s = reduce_small_sum(jnp, s, primes_col, rows + 1)
            outs.append(s)
        prod = jnp.stack(outs, axis=1)
        # acc += dec(acc) (.) (E - GGSW(1)): identity handled additively
        return acc + garner_to_u32(jnp, ntt_inv(jnp, prod, tab), tab), None

    acc, _ = jax.lax.scan(
        step, acc, (dsk.bsk_ntt, dsk.bsk_ntt_sh, a_groups), length=groups
    )
    return acc


def ntt_sub_mod(a, b, p):
    r = a - b
    return jnp.where(a < b, r + p, r)


def keyswitch(dsk: DeviceServerKey, big_lwe: jax.Array) -> jax.Array:
    """Big-LWE [G, kN+1] -> small-LWE [G, n+1] via an int8-limb matmul.

    Each int8 x int8 product accumulates in int32; the sums stay far below
    2^31 (kN*ks_level terms of at most 128*128)."""
    p = dsk.params
    kn = p.big_n
    a, b = big_lwe[:, :kn], big_lwe[:, kn]
    digits = ops.signed_decompose(jnp, a, p.ks_base_log, p.ks_level)
    # [l, G, kN] -> [G, kN*l] with row order i*l + j (matches gen_ksk)
    d = jnp.transpose(digits, (1, 2, 0)).reshape(a.shape[0], kn * p.ks_level)
    d8 = d.astype(jnp.int8)
    acc = None
    for limb in range(4):
        part = jax.lax.dot_general(
            d8,
            dsk.ksk_limbs[limb],
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        term = part.astype(jnp.uint32) << (8 * limb)
        acc = term if acc is None else acc + term
    out = jnp.uint32(0) - acc
    return out.at[:, p.n].add(b)


def bootstrap(
    dsk: DeviceServerKey, lwe_in: jax.Array, testv: jax.Array
) -> jax.Array:
    """Full PBS: blind rotate -> sample extract -> keyswitch. [G,n+1]->[G,n+1]."""
    if dsk.params.grouping > 1:
        acc = blind_rotate_multibit(dsk, lwe_in, testv)
    else:
        acc = blind_rotate(dsk, lwe_in, testv)
    big = ops.sample_extract(jnp, acc, dsk.params.k, dsk.params.N)
    return keyswitch(dsk, big)


# ----------------------------------------------------------------------
# Test polynomials
# ----------------------------------------------------------------------


def gates_test_poly(params: TfheParams) -> np.ndarray:
    """Constant q/8 poly: blind rotation yields +-q/8 (the sign bootstrap)."""
    return np.full((1, params.N), np.uint32(1 << 29), dtype=np.uint32)


def lut_test_poly(params: TfheParams, table: np.ndarray) -> np.ndarray:
    """Programmable test poly from f-values over the padded message space.

    table: uint64 [..., msg_space/2] of f(m) values (m has a padding bit, so
    only msg_space/2 inputs are reachable). Returns uint32 [..., N].
    """
    p = params
    half_space = p.msg_space // 2
    box = p.N // half_space
    vals = (np.asarray(table, dtype=np.uint64) % p.msg_space) * p.delta
    v = np.repeat(vals.astype(np.uint32), box, axis=-1)  # [..., N]
    # negacyclic rotate by -box/2 so each box is centered on its phase
    h = box // 2
    lead = v[..., h:]
    wrap = (0 - v[..., :h].astype(np.int64)) % (1 << 32)
    return np.concatenate([lead, wrap.astype(np.uint32)], axis=-1)
