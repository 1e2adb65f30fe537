"""Shared TFHE primitives (backend-agnostic over numpy / jax.numpy).

Gadget decomposition, negacyclic barrel rotation, mod-switch, sample extract.
These are the building blocks of the batched PBS pipeline (DESIGN.md §3);
the same code runs under numpy (host reference) and jnp on any device.
"""

from __future__ import annotations


def signed_decompose(xp, v, base_log: int, levels: int):
    """Signed gadget decomposition of uint32 values.

    Returns int32 digits with shape [levels, ...v.shape], where level j has
    weight q / B^(j+1) (j=0 most significant), each digit in [-B/2, B/2],
    and sum_j d_j * q/B^(j+1) ~= v (mod q) up to q/(2 B^levels) rounding.

    Matches the closest-representative semantics of tfhe-rs's decomposer
    (behavioral contract only; implementation is original).
    """
    total = base_log * levels
    assert total <= 32
    b = 1 << base_log
    half = b // 2
    # round v to `total` top bits (keep one extra bit, round-half-up)
    r = ((v >> (32 - total - 1)) + xp.uint32(1)) >> 1
    r = r & xp.uint32((1 << total) - 1)
    digits = []
    for _ in range(levels):
        d = (r & xp.uint32(b - 1)).astype(xp.int32)
        carry = d >= half
        d = xp.where(carry, d - b, d)
        r = (r >> base_log) + carry.astype(xp.uint32)
        digits.append(d)
    digits.reverse()  # level 0 = most significant (weight q/B)
    return xp.stack(digits, axis=0)


def recompose(xp, digits, base_log: int, levels: int):
    """Inverse of signed_decompose (up to rounding): uint32 [...]."""
    acc = None
    for j in range(levels):
        w = xp.uint32(1 << (32 - base_log * (j + 1)))
        term = digits[j].astype(xp.uint32) * w
        acc = term if acc is None else acc + term
    return acc


def negacyclic_rotate(xp, x, r, N: int):
    """Multiply [..., N] polys by X^r, r uint32 in [0, 2N), batched.

    `r` must broadcast against x.shape[:-1]. Implemented as a barrel rotator
    (log2(2N) static rolls + selects) — no data-dependent gathers.
    """
    log2n = N.bit_length() - 1
    zero = xp.uint32(0)
    idx = None
    for s_log in range(log2n):
        s = 1 << s_log
        bit = ((r >> s_log) & 1).astype(bool)[..., None]
        rolled = xp.roll(x, s, axis=-1)
        if idx is None:
            import numpy as _np

            idx = xp.asarray(_np.arange(N, dtype=_np.int32))
        wrapped = idx < s
        rotated = xp.where(wrapped, zero - rolled, rolled)
        x = xp.where(bit, rotated, x)
    # the X^N = -1 bit
    bit = ((r >> log2n) & 1).astype(bool)[..., None]
    return xp.where(bit, zero - x, x)


def mod_switch(xp, v, N: int):
    """Round uint32 torus values to [0, 2N) buckets."""
    lg = N.bit_length()  # log2(2N)
    r = ((v >> (32 - lg - 1)) + xp.uint32(1)) >> 1
    return r & xp.uint32(2 * N - 1)


def sample_extract(xp, acc, k: int, N: int):
    """Extract coefficient 0 of a batch of GLWE ctxts as big-LWE rows.

    acc: uint32 [..., k+1, N]  ->  uint32 [..., k*N + 1]
    Big-LWE key ordering: s_big[j*N + i] = S_j[i] (glwe key flattened).
    """
    zero = xp.uint32(0)
    mask = acc[..., :k, :]
    a0 = mask[..., :, 0:1]
    rest = zero - mask[..., :, :0:-1]  # -[x_{N-1} ... x_1]
    a = xp.concatenate([a0, rest], axis=-1).reshape(acc.shape[:-2] + (k * N,))
    b = acc[..., k, 0:1]
    return xp.concatenate([a, b], axis=-1)
