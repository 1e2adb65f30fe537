"""Server key generation: bootstrap key (GGSW) and keyswitch key.

Host-side (numpy, exact NTT) generation of the evaluation keys, plus their
device forms:

- BSK in the NTT/CRT domain with Shoup companions, laid out
  [n, (k+1)*l, k+1, NP, N] so one scan step slices all rows of GGSW_i.
- KSK recoded into balanced int8 limbs [4, rows, n+1] feeding the int8
  matmul keyswitch (DESIGN.md §3).

Counterpart of the reference's per-mode keygen (src/bin/helm.rs:88,160-192,
241,301); unlike the reference, keys are arrays, not opaque library objects.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import functools

from ..params import Q, TfheParams
from . import ntt
from .lwe import ClientKey, _noise
from .modring import NUM_PRIMES, get_tables


@functools.lru_cache(maxsize=None)
def _keygen_cpu_jit(N: int):
    """Jitted host-CPU helpers for keygen-scale NTT batches.

    Keygen stays a host/client-side operation, but the pure-numpy NTT is
    single-threaded and dominates multi-bit keygen (~8 min at n=512,
    grouping=2). The ntt module is backend-agnostic, so the same exact
    integer pipeline runs ~20x faster as jitted jnp on the CPU backend
    (never the accelerator: jax.default_device pins the local CPU).
    Returns (fwd, body) callables operating on/returning numpy arrays.
    """
    import jax
    import jax.numpy as jnp

    tab = get_tables(N)
    # local_devices, not devices(): under multi-process (jax.distributed)
    # the global list starts with process 0's devices, and pinning keygen
    # to a non-addressable device breaks every other controller
    cpu = jax.local_devices(backend="cpu")[0]

    @jax.jit
    def fwd(raw):  # u32 [..., N] -> NTT residues u32 [..., NP, N]
        return ntt.ntt_fwd(jnp, ntt.to_residues(jnp, raw, tab), tab)

    @jax.jit
    def body(a, s_ntt):  # mask polys [rows, k, N], key NTT [k, NP, N]
        primes = jnp.asarray(tab.primes).reshape(NUM_PRIMES, 1)
        a_ntt = ntt.ntt_fwd(jnp, ntt.to_residues(jnp, a, tab), tab)
        prod = ntt._generic_modmul(jnp, a_ntt, s_ntt[None], primes)
        acc = prod[:, 0]
        for c in range(1, s_ntt.shape[0]):
            acc = ntt.add_mod(jnp, acc, prod[:, c], primes)
        return ntt.garner_to_u32(jnp, ntt.ntt_inv(jnp, acc, tab), tab)

    def run(fn):
        def wrapped(*args):
            with jax.default_device(cpu):
                return np.asarray(fn(*jax.device_put(args, cpu)))

        return wrapped

    return run(fwd), run(body)


@dataclass
class ServerKey:
    """Host (numpy) server key; convert with engines' to_device()."""

    params: TfheParams
    bsk_ntt: np.ndarray  # uint32 [n, (k+1)*l, k+1, NP, N]
    bsk_ntt_sh: np.ndarray  # uint32, same shape
    ksk_limbs: np.ndarray  # int8 [4, k*N*ks_level, n+1]


def _glwe_enc_zero_batch(ck: ClientKey, rows: int) -> np.ndarray:
    """Batch of GLWE encryptions of zero: uint32 [rows, k+1, N]."""
    p = ck.params
    tab = get_tables(p.N)
    a = ck.rng.integers(0, Q, size=(rows, p.k, p.N), dtype=np.uint32)
    fwd, body_fn = _keygen_cpu_jit(p.N)
    s_ntt = fwd(ck.glwe_key)
    body = body_fn(a, s_ntt)
    body = body + _noise(ck.rng, p.glwe_noise_std, (rows, p.N))
    return np.concatenate([a, body[:, None, :]], axis=1)


def bsk_coefficients(ck: ClientKey) -> np.ndarray:
    """The bootstrap key's GGSW rows in the coefficient domain (uint32).

    Single-bit: [n, rows, k+1, N], a GGSW encryption of each small-key
    bit. Multi-bit (grouping g > 1): [n/g, 2^g-1, rows, k+1, N], see
    gen_bsk_multibit. gen_server_key transforms these rows to the NTT
    domain; the coefficient form is what a schoolbook reference needs."""
    _check_conv_bound(ck.params)
    if ck.params.grouping > 1:
        return _bsk_multibit_coefficients(ck)
    p = ck.params
    kp1 = p.k + 1
    rows_per = p.gadget_rows
    raw = _glwe_enc_zero_batch(ck, p.n * rows_per).reshape(
        p.n, rows_per, kp1, p.N
    )
    # add s_i * q/B_c^(j+1) * X^0 to poly c of row (c, j); rows are c-major
    # with per-component gadgets (approximate mask gadget — params.py)
    r = 0
    for c in range(kp1):
        bl, lv = p.component_gadgets[c]
        for j in range(lv):
            raw[:, r, c, 0] += ck.lwe_key * np.uint32(1 << (32 - bl * (j + 1)))
            r += 1
    return raw


def _to_ntt(raw: np.ndarray, N: int) -> tuple[np.ndarray, np.ndarray]:
    """Coefficient rows -> NTT/CRT residues [..., NP, N] + Shoup companions."""
    fwd, _ = _keygen_cpu_jit(N)
    bsk_ntt = fwd(raw)
    primes = get_tables(N).primes.reshape(NUM_PRIMES, 1).astype(np.uint64)
    sh = ((bsk_ntt.astype(np.uint64) << 16) // primes).astype(np.uint32)
    return bsk_ntt, sh


def _balanced_limbs(v: np.ndarray) -> np.ndarray:
    """uint32 [...] -> int8 [4, ...] with v === sum limb_i * 2^(8i) mod 2^32."""
    x = v.astype(np.int64)
    out = np.empty((4,) + v.shape, dtype=np.int8)
    for i in range(4):
        d = ((x + 128) & 255) - 128
        out[i] = d.astype(np.int8)
        x = (x - d) >> 8
    return out


def gen_ksk(ck: ClientKey) -> np.ndarray:
    """KSK rows enc_small(s_big_i * q/B^(j+1)), i major / level j minor,
    recoded to balanced int8 limbs [4, big_n*ks_level, n+1]."""
    p = ck.params
    s_big = ck.extracted_key  # [kN]
    rows = p.big_n * p.ks_level
    msgs = np.zeros((p.big_n, p.ks_level), dtype=np.uint32)
    for j in range(p.ks_level):
        w = np.uint32(1 << (32 - p.ks_base_log * (j + 1)))
        msgs[:, j] = s_big * w
    a = ck.rng.integers(0, Q, size=(rows, p.n), dtype=np.uint32)
    dot = (a.astype(np.uint64) * ck.lwe_key.astype(np.uint64)).sum(axis=-1)
    b = (
        dot.astype(np.uint32)
        + msgs.reshape(rows)
        + _noise(ck.rng, p.lwe_noise_std, (rows,))
    ).astype(np.uint32)
    ksk = np.concatenate([a, b[:, None]], axis=-1)  # [rows, n+1]
    return _balanced_limbs(ksk)


def _bsk_multibit_coefficients(ck: ClientKey) -> np.ndarray:
    """Grouped bootstrap key for multi-bit PBS (params.grouping = g > 1).

    For each group j of g secret bits and each NONEMPTY subset mask
    v in [1, 2^g), a GGSW encryption of prod_{i in v} s_{jg+i} (analog of
    tfhe-rs's multi-bit BSK; the reference's arith mode uses GROUP_3
    parameters, src/bin/helm.rs:81-88). The empty subset (GGSW of 1) is
    NOT keyed: the PBS uses the additive-identity CMux form
    acc += dec(acc) (.) sum_{v>=1} P_v BSK_v, so the v=0 external product
    — 25%% of the pointwise terms, BSK loads, and key bytes at g=2 —
    never happens (and contributes no noise, matching the noise model's
    (3^g-1)/(2g) multiplier exactly). Shape [n/g, 2^g-1, rows, k+1, N].
    """
    p = ck.params
    g = p.grouping
    assert g >= 1 and p.n % g == 0, (g, p.n)
    groups = p.n // g
    kp1 = p.k + 1
    rows_per = p.gadget_rows
    nv = 1 << g
    raw = _glwe_enc_zero_batch(ck, groups * (nv - 1) * rows_per).reshape(
        groups, nv - 1, rows_per, kp1, p.N
    )
    s = ck.lwe_key.reshape(groups, g)
    for v in range(1, nv):
        # m_v[j] = prod of the selected bits of group j
        m = np.ones(groups, dtype=np.uint32)
        for i in range(g):
            if (v >> i) & 1:
                m = m * s[:, i]
        r = 0
        for c in range(kp1):
            bl, lv = p.component_gadgets[c]
            for j in range(lv):
                raw[:, v - 1, r, c, 0] += m * np.uint32(
                    1 << (32 - bl * (j + 1))
                )
                r += 1
    return raw


def _check_conv_bound(p: TfheParams) -> None:
    import math

    prod = math.prod(int(q) for q in get_tables(p.N).primes)
    assert 2 * p.conv_bound() < prod, (
        f"{p.name}: external-product convolution bound 2^"
        f"{math.log2(p.conv_bound()):.2f} exceeds half the CRT prime "
        f"product 2^{math.log2(prod):.2f} for N={p.N} "
        "(modring.primes_for) — results would be wrong; use a smaller "
        "gadget base or a larger prime set"
    )


def gen_server_key(ck: ClientKey) -> ServerKey:
    bsk_ntt, bsk_sh = _to_ntt(bsk_coefficients(ck), ck.params.N)
    return ServerKey(ck.params, bsk_ntt, bsk_sh, gen_ksk(ck))
