"""Radix-integer homomorphic ops (arith mode building blocks).

Counterpart of tfhe-rs's radix integer operations used by the reference's
ArithCircuit (src/circuit.rs:1113-1483, src/gates.rs:306-702). Values are
vectors of 2-bit-message / 2-bit-carry blocks (MESSAGE_2_CARRY_2 analog):
value = sum_i block_i * 4^i, u8..u128 = 4..64 blocks.

Everything reduces to batched PBS launches:

- add/sub: linear block ops + a sequential carry-propagation pass whose every
  round is ONE batched (msg, carry) launch across the whole gate batch.
- mul: schoolbook partial products, ALL (lo, hi) pairs in one bivariate-PBS
  launch, then a carry-save compression tree (one launch per tree round).
- div: restoring long division from encrypted comparisons (carry-out of
  x + ~y + 1), quotient bits via bivariate products.
- shifts: plain amounts are block relabels + one bit-shift launch;
  encrypted amounts use a mux ladder over the amount's bits.

Blocks are kept *clean* (message < 4, no carries) after every public op.

Every op is written as a COROUTINE that yields lists of (pre, test_poly)
PBS requests and receives the bootstrapped results — the dataflow
scheduler in engines/arith.py advances all runnable gates together and
merges every round's requests into ONE launch, so independent gates (of
any type, at any circuit level) share blind rotations instead of queueing
behind each other. The plain methods on RadixOps drive a single coroutine
to completion for direct library use.
"""

from __future__ import annotations

from functools import partial

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..fhe import pbs_jnp
from ..params import TfheParams

WIDTH_BLOCKS = {"u8": 4, "u16": 8, "u32": 16, "u64": 32, "u128": 64}


# ----------------------------------------------------------------------
# Test polynomial bank for radix ops
# ----------------------------------------------------------------------


class RadixTestPolys:
    def __init__(self, params: TfheParams):
        half = params.msg_space // 2  # reachable messages (padding bit)
        ms = np.arange(half, dtype=np.uint64)

        def tv(f):
            return jnp.asarray(
                pbs_jnp.lut_test_poly(params, f(ms).astype(np.uint64))
            )[None, :]

        self.msg = tv(lambda m: m % 4)
        self.carry = tv(lambda m: m // 4)
        self.mul_lo = tv(lambda m: ((m >> 2) * (m & 3)) % 4)
        self.mul_hi = tv(lambda m: ((m >> 2) * (m & 3)) // 4)
        self.lobit = tv(lambda m: m % 2)
        self.hibit = tv(lambda m: (m % 4) // 2)
        # shr helper: 2 * (x % 2) to splice a low bit into the block above
        self.lobit2 = tv(lambda m: 2 * (m % 2))
        self.half = tv(lambda m: (m % 4) // 2)
        # log-depth carry propagation (Hillis-Steele over carry status):
        # status of a raw block sum s<=7: 2=generate (s>=4), 1=propagate
        # (s==3, carries a carry-in through), 0=kill
        self.status = tv(lambda m: np.where(m >= 4, 2, np.where(m == 3, 1, 0)))
        # combine(newer=idx>>2, older=idx&3): newer==1 ? older : newer
        self.cmb = tv(lambda m: np.where((m >> 2) == 1, m & 3, m >> 2))
        # fused combine-then-carry for the LAST scan round: carry bit of
        # the combined status (status==2 -> 1)
        self.cmbc = tv(
            lambda m: np.where((m >> 2) == 1, m & 3, m >> 2) // 2
        )
        # final message from idx = 2*s + carry_in
        self.msgc = tv(lambda m: ((m >> 1) + (m & 1)) % 4)


_bootstrap_jit = jax.jit(pbs_jnp.bootstrap)

#: optional NamedSharding applied to every radix PBS batch (parallel/mesh.py)
BATCH_SHARD = [None]

#: diagnostic: total _bootstrap_multi launches and bootstrapped slots
LAUNCHES = [0]
SLOTS = [0]


@partial(jax.jit, static_argnums=(0,))
def _bootstrap_sharded(shard, dsk, pre, tv):
    pre = jax.lax.with_sharding_constraint(pre, shard)
    return pbs_jnp.bootstrap(dsk, pre, tv)


def _bootstrap_multi(dsk, pres: list, tvs: list):
    """One launch for several (pre, testv) groups of equal width.

    Batch widths are bucket-padded to powers of two (at least 128 on an
    accelerator, 8 on the CPU): radix ops launch at many distinct widths,
    and every distinct width would otherwise re-trace and re-compile the
    PBS program. Padding slots bootstrap trivial zeros and are sliced off
    after."""
    sizes = [p.shape[0] for p in pres]
    pre = jnp.concatenate(pres) if len(pres) > 1 else pres[0]
    tv = jnp.concatenate(
        [jnp.broadcast_to(t, (s, t.shape[-1])) for s, t in zip(sizes, tvs)]
    )
    total = pre.shape[0]
    floor = 8 if jax.default_backend() == "cpu" else 128
    bucket = max(floor, 1 << (total - 1).bit_length())
    if bucket != total:
        pad = bucket - total
        pre = jnp.concatenate(
            [pre, jnp.zeros((pad, pre.shape[1]), pre.dtype)]
        )
        tv = jnp.concatenate(
            [tv, jnp.broadcast_to(tv[:1], (pad, tv.shape[1]))]
        )
    SLOTS[0] += bucket

    def _launch(p_, t_):
        LAUNCHES[0] += 1
        if BATCH_SHARD[0] is not None:
            return _bootstrap_sharded(BATCH_SHARD[0], dsk, p_, t_)
        return _bootstrap_jit(dsk, p_, t_)

    # per-launch width cap: oversized batches split into equal power-of-
    # two sub-launches that all reuse ONE compiled executable.
    # HELM_TPU_MAX_G overrides. The defaults come from a crash of the TPU
    # worker this program first ran on, while it compiled one giant
    # merged mmult15 launch at ARITH_128_MB2; no such failure is known on
    # the GPU (ROADMAP.md lists deciding the cap from GPU measurements).
    cap = int(
        os.environ.get(
            "HELM_TPU_MAX_G", "2048" if dsk.params.N >= 2048 else "4096"
        )
    )
    if bucket > cap:
        out = jnp.concatenate(
            [
                _launch(pre[i : i + cap], tv[i : i + cap])
                for i in range(0, bucket, cap)
            ]
        )
    else:
        out = _launch(pre, tv)
    res, off = [], 0
    for s in sizes:
        res.append(out[off : off + s])
        off += s
    return res


def _run(dsk, gen):
    """Drive one op coroutine to completion, launching every yielded
    request list immediately (the single-op / library-API path)."""
    try:
        reqs = gen.send(None)
        while True:
            outs = _bootstrap_multi(
                dsk, [r[0] for r in reqs], [r[1] for r in reqs]
            )
            reqs = gen.send(outs)
    except StopIteration as e:
        return e.value


def trivial_blocks(params: TfheParams, value: int, nb: int, batch: int) -> jnp.ndarray:
    """Trivial radix encryption [batch, nb, n+1]."""
    out = np.zeros((batch, nb, params.n + 1), dtype=np.uint32)
    for i in range(nb):
        out[:, i, params.n] = np.uint32(((value >> (2 * i)) & 3) * params.delta)
    return jnp.asarray(out)


def _propagate_g(tp: RadixTestPolys, z, with_carry=False):
    """Carry-propagate blocks -> clean blocks (+ carry-out).

    z: [B, nb, n+1]. Invariant at every call site: block sums <= 6 for
    blocks >= 1 and <= 7 at block 0 (carry-in 0 there), so every running
    carry is 0/1. nb >= 8 uses log-depth carry-lookahead (Hillis-Steele
    scan over encrypted generate/propagate status, ceil(log2 nb)+3
    rounds); smaller widths ripple sequentially (nb rounds).
    """
    n1 = z.shape[-1]
    B, nb = z.shape[0], z.shape[1]
    if nb < 8:
        c = jnp.zeros((B, n1), jnp.uint32)
        outs = []
        for i in range(nb):
            t = z[:, i] + c
            m, c = yield [(t, tp.msg), (t, tp.carry)]
            outs.append(m)
        res = jnp.stack(outs, axis=1)
        return (res, c) if with_carry else res
    flat = z.reshape(B * nb, n1)
    (a,) = yield [(flat, tp.status)]
    a = a.reshape(B, nb, n1)
    o = 1
    while 2 * o < nb:
        # inclusive scan: a[i] <- combine(a[i] over a[i-o])
        pre = 4 * a[:, o:] + a[:, :-o]
        (upd,) = yield [(pre.reshape(B * (nb - o), n1), tp.cmb)]
        a = jnp.concatenate([a[:, :o], upd.reshape(B, nb - o, n1)], axis=1)
        o *= 2
    # final scan round, fused with carry extraction: positions < o are
    # already final (Hillis-Steele: position i is final once o > i), so
    # this ONE launch maps them through `half` while the rest combine
    # straight to a carry bit via `cmbc` — saving the separate half round
    pre = 4 * a[:, o:] + a[:, :-o]
    hic, loc = yield [
        (pre.reshape(B * (nb - o), n1), tp.cmbc),
        (a[:, :o].reshape(B * o, n1), tp.half),
    ]
    cs = jnp.concatenate(
        [loc.reshape(B, o, n1), hic.reshape(B, nb - o, n1)], axis=1
    )
    cin = jnp.concatenate(
        [jnp.zeros((B, 1, n1), jnp.uint32), cs[:, : nb - 1]], axis=1
    )
    pre = (2 * z + cin).reshape(B * nb, n1)
    (m,) = yield [(pre, tp.msgc)]
    res = m.reshape(B, nb, n1)
    return (res, cs[:, nb - 1]) if with_carry else res


def _prop_rounds(nb: int) -> int:
    """Bootstrap rounds _propagate_g takes at width nb."""
    if nb < 8:
        return nb
    o, iters = 1, 0
    while 2 * o < nb:
        o *= 2
        iters += 1
    return 1 + iters + 1 + 1  # status + scan + fused final + msgc


def _sim_compress(cols_w: list[list[int]], limit: int, nb: int) -> int:
    """Round count of _compress_g's loop on weights alone (the chunking
    is deterministic host-side scheduling, so both endgames can be
    costed exactly before spending any bootstraps)."""
    rounds = 0
    cw = [list(ws) for ws in cols_w]
    while any(sum(ws) > limit for ws in cw):
        rounds += 1
        new: list[list[int]] = [[] for _ in range(nb)]
        for c, ws in enumerate(cw):
            if sum(ws) <= limit:
                new[c].extend(ws)
                continue
            k = 0
            while k < len(ws):
                w, cnt = 0, 0
                while k < len(ws) and w + ws[k] <= 5:
                    w += ws[k]
                    k += 1
                    cnt += 1
                new[c].append(1)
                if not (cnt == 1 and w == 1) and c + 1 < nb:
                    new[c + 1].append(1)
        cw = new
    return rounds


_RTP_FIELDS = (
    "msg", "carry", "mul_lo", "mul_hi", "lobit", "hibit", "lobit2", "half",
    "status", "cmb", "cmbc", "msgc",
)

jax.tree_util.register_pytree_node(
    RadixTestPolys,
    lambda t: (tuple(getattr(t, f) for f in _RTP_FIELDS), None),
    lambda _, ch: _rtp_unflatten(ch),
)


def _rtp_unflatten(ch):
    t = object.__new__(RadixTestPolys)
    for f, v in zip(_RTP_FIELDS, ch):
        setattr(t, f, v)
    return t


class RadixOps:
    """Device key + test polys + the radix op suite.

    `*_g` methods are coroutines (yield PBS request lists, receive
    results); the plain methods drive them synchronously."""

    def __init__(self, params: TfheParams, dsk):
        self.params = params
        self.dsk = dsk
        self.tp = RadixTestPolys(params)

    # -- add / sub -----------------------------------------------------
    def add_g(self, x, y, with_carry: bool = False):
        return _propagate_g(self.tp, x + y, with_carry=with_carry)

    def sub_g(self, x, y, with_carry: bool = False):
        """x - y via x + (3-y per block) + 1; carry-out == (x >= y)."""
        p = self.params
        neg = jnp.uint32(0) - y
        neg = neg.at[:, :, p.n].add(jnp.uint32(3 * p.delta))
        z = x + neg
        z = z.at[:, 0, p.n].add(jnp.uint32(p.delta))
        return _propagate_g(self.tp, z, with_carry=with_carry)

    def add_sub_mixed_g(self, x, y, is_sub):
        """Fused batch of adds and subs: row i computes x-y when is_sub[i]
        (a static python sequence) else x+y. Both ops end in the same
        carry-propagate, so the whole batch shares ONE bootstrap chain."""
        p = self.params
        neg = jnp.uint32(0) - y
        neg = neg.at[:, :, p.n].add(jnp.uint32(3 * p.delta))
        neg = neg.at[:, 0, p.n].add(jnp.uint32(p.delta))
        sel = jnp.asarray(is_sub, dtype=bool)[:, None, None]
        return _propagate_g(self.tp, x + jnp.where(sel, neg, y))

    def add_scalar_block0_g(self, x, v: int):
        p = self.params
        z = x.at[:, 0, p.n].add(jnp.uint32(v * p.delta))
        return _propagate_g(self.tp, z)

    def ge_g(self, x, y):
        """Carry-only comparison: (x >= y) as one encrypted bit — the
        carry-out of x + ~y + 1 via a log-depth generate/propagate status
        REDUCTION (a full subtraction computes every prefix carry plus a
        final message round just to discard them; the reduction needs
        ceil(log2 nb) combine rounds over a halving batch)."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        n1 = p.n + 1
        neg = jnp.uint32(0) - y
        neg = neg.at[:, :, p.n].add(jnp.uint32(3 * p.delta))
        z = x + neg
        z = z.at[:, 0, p.n].add(jnp.uint32(p.delta))
        (a,) = yield [(z.reshape(B * nb, n1), self.tp.status)]
        a = a.reshape(B, nb, n1)
        m = nb
        while m > 2:
            h = m // 2
            pre = 4 * a[:, 1 : 2 * h : 2] + a[:, 0 : 2 * h : 2]
            (cmb,) = yield [(pre.reshape(B * h, n1), self.tp.cmb)]
            cmb = cmb.reshape(B, h, n1)
            a = (
                jnp.concatenate([cmb, a[:, 2 * h :]], axis=1)
                if m % 2
                else cmb
            )
            m = h + m % 2
        if m == 2:  # final combine straight to the carry bit
            pre = (4 * a[:, 1] + a[:, 0]).reshape(B, n1)
            (c,) = yield [(pre, self.tp.cmbc)]
        else:
            (c,) = yield [(a[:, 0], self.tp.half)]
        return c

    # -- mul -----------------------------------------------------------
    def mul_g(self, x, y, square: bool = False):
        """Schoolbook + carry-save compression; all rounds fully batched.

        Request preambles are built with ONE gather + arithmetic op per
        round (index arrays over a term pool) rather than per-(i,j) slice
        ops: every eager jnp op is a separate dispatch, so op count per
        round matters as well as PBS count.

        square=True (y is x): symmetric pairs are bootstrapped ONCE and
        their pool index listed twice in the compression columns —
        ~47% fewer slots in the dominant partial-product round."""
        B, nb = x.shape[0], x.shape[1]
        n1 = self.params.n + 1
        if square:
            pairs = [
                (i, j) for i in range(nb) for j in range(i, nb) if i + j < nb
            ]
        else:
            pairs = [
                (i, j) for i in range(nb) for j in range(nb) if i + j < nb
            ]
        hi_pairs = [(i, j) for (i, j) in pairs if i + j + 1 < nb]

        def pair_pre(ps):  # [len(ps)*B, n+1], pair-major
            I = jnp.asarray([i for i, _ in ps], dtype=jnp.int32)
            J = jnp.asarray([j for _, j in ps], dtype=jnp.int32)
            z = 4 * x[:, I] + y[:, J]  # [B, P, n+1]
            return jnp.swapaxes(z, 0, 1).reshape(len(ps) * B, n1)

        if hi_pairs:
            lo, hi = yield [
                (pair_pre(pairs), self.tp.mul_lo),
                (pair_pre(hi_pairs), self.tp.mul_hi),
            ]
        else:
            (lo,) = yield [(pair_pre(pairs), self.tp.mul_lo)]
            hi = lo[:0]
        # term pool [T, B, n+1]; row T is a zero pad for short chunks
        pool = jnp.concatenate(
            [
                lo.reshape(len(pairs), B, n1),
                hi.reshape(len(hi_pairs), B, n1),
                jnp.zeros((1, B, n1), jnp.uint32),
            ]
        )
        zpad = len(pairs) + len(hi_pairs)
        cols: list[list[tuple[int, int]]] = [[] for _ in range(nb)]
        mult = (lambda i, j: 2 if i != j else 1) if square else (lambda i, j: 1)
        for idx, (i, j) in enumerate(pairs):
            cols[i + j].extend([(idx, 1)] * mult(i, j))
        for idx, (i, j) in enumerate(hi_pairs):
            cols[i + j + 1].extend([(len(pairs) + idx, 1)] * mult(i, j))
        return (yield from self._compress_g(pool, cols, zpad, B, n1))

    def _compress_g(self, pool, cols, zpad, B, n1):
        """Carry-save column compression to one CLEAN block per column.

        cols[c] holds (pool_index, weight) entries; weight w means the
        block's value is <= 3*w (clean blocks w=1, doubled blocks w=2).
        Each round greedily packs chunks of total weight <= 5 per column
        (chunk sums <= 15, inside the PBS domain), bootstraps msg+carry
        for every chunk in ONE launch, and feeds carries one column up.
        Rounds ~ log_2.5(max terms) — far cheaper than pairwise adds,
        whose every tree level is a full carry propagate.

        Endgame: compressing all the way to one entry makes the final
        carries RIPPLE one column per round (~nb rounds); stopping at
        column weight <= 2 (block sums <= 6, the propagate invariant)
        and finishing with ONE log-depth carry propagate is often
        cheaper. Scheduling is host-side and deterministic, so both
        endgames are SIMULATED on the weights and the cheaper one runs
        (u32 mul: 16 -> 11 rounds; a u32 doubling: 16 -> 6)."""
        nb = len(cols)

        def colw(terms):
            return sum(w for _, w in terms)

        r1 = _sim_compress([[w for _, w in t] for t in cols], 1, nb)
        r2 = _sim_compress([[w for _, w in t] for t in cols], 2, nb)
        prop_end = r2 + _prop_rounds(nb) < r1
        limit = 2 if prop_end else 1

        while any(colw(terms) > limit for terms in cols):
            chunk_idx, chunk_col = [], []
            new_cols: list[list[tuple[int, int]]] = [[] for _ in range(nb)]
            for c, terms in enumerate(cols):
                if colw(terms) <= limit:
                    new_cols[c].extend(terms)
                    continue
                k = 0
                while k < len(terms):
                    chunk, w = [], 0
                    while k < len(terms) and w + terms[k][1] <= 5:
                        chunk.append(terms[k][0])
                        w += terms[k][1]
                        k += 1
                    if len(chunk) == 1 and w == 1:
                        new_cols[c].append((chunk[0], 1))
                    else:
                        chunk_idx.append(chunk + [zpad] * (5 - len(chunk)))
                        chunk_col.append(c)
            if chunk_idx:
                C = len(chunk_idx)
                sel = jnp.asarray(chunk_idx, dtype=jnp.int32)  # [C, 5]
                pre = pool[sel].sum(axis=1).reshape(C * B, n1)
                msgs, carries = yield [
                    (pre, self.tp.msg),
                    (pre, self.tp.carry),
                ]
                base = pool.shape[0] - 1  # overwrite the zero pad position
                pool = jnp.concatenate(
                    [
                        pool[:-1],
                        msgs.reshape(C, B, n1),
                        carries.reshape(C, B, n1),
                        jnp.zeros((1, B, n1), jnp.uint32),
                    ]
                )
                zpad = base + 2 * C
                for ci, c in enumerate(chunk_col):
                    new_cols[c].append((base + ci, 1))
                    if c + 1 < nb:
                        new_cols[c + 1].append((base + C + ci, 1))
            cols = new_cols
        if prop_end:
            sel1 = jnp.asarray(
                [t[0][0] if t else zpad for t in cols], dtype=jnp.int32
            )
            sel2 = jnp.asarray(
                [t[1][0] if len(t) > 1 else zpad for t in cols],
                dtype=jnp.int32,
            )
            z = jnp.swapaxes(pool[sel1] + pool[sel2], 0, 1)  # [B, nb, n+1]
            return (yield from _propagate_g(self.tp, z))
        sel = jnp.asarray(
            [terms[0][0] if terms else zpad for terms in cols],
            dtype=jnp.int32,
        )
        return jnp.swapaxes(pool[sel], 0, 1)  # [B, nb, n+1]

    def mul_plain_g(self, x, c: int):
        """x * plaintext c via binary expansion feeding the carry-save
        compressor directly: even shifts contribute x's blocks relabeled
        (free), odd shifts contribute DOUBLED blocks (2*ct, linear,
        weight 2 in the compressor) — zero propagates anywhere; total
        rounds ~ log_2.5(popcount). Counterpart of the reference's
        ct (x) pt mul (gates.rs:306-702 _plain variants) — power-of-two
        constants cost ZERO bootstraps here. Truncates mod 2^width like
        the encrypted schoolbook."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        n1 = p.n + 1
        width = 2 * nb
        c &= (1 << width) - 1
        if c == 0:
            return trivial_blocks(p, 0, nb, B)
        # pool: x's blocks (idx i), doubled blocks (idx nb+i), zero pad
        xt = jnp.swapaxes(x, 0, 1)  # [nb, B, n+1]
        pool = jnp.concatenate(
            [xt, 2 * xt, jnp.zeros((1, B, n1), jnp.uint32)]
        )
        zpad = 2 * nb
        cols: list[list[tuple[int, int]]] = [[] for _ in range(nb)]
        for k in range(width):
            if not (c >> k) & 1:
                continue
            s, bit = divmod(k, 2)
            for j in range(s, nb):  # term block j = (2x if odd else x)[j-s]
                cols[j].append((nb + (j - s), 2) if bit else ((j - s), 1))
        return (yield from self._compress_g(pool, cols, zpad, B, n1))

    # -- division ------------------------------------------------------
    def div_g(self, x, y):
        """Restoring long division; div-by-zero yields all-ones (like the
        hardware algorithm; documented divergence from Rust's panic)."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        bits = 2 * nb
        # extract all bits of x in one round
        flat = x.reshape(B * nb, p.n + 1)
        los, his = yield [(flat, self.tp.lobit), (flat, self.tp.hibit)]
        los = los.reshape(B, nb, p.n + 1)
        his = his.reshape(B, nb, p.n + 1)
        xbit = [
            (his[:, k // 2] if k % 2 else los[:, k // 2]) for k in range(bits)
        ]
        # remainder register gets one extra block so 2R+b never truncates
        # before the comparison
        nbe = nb + 1
        zero_blk = jnp.zeros((B, 1, p.n + 1), jnp.uint32)
        y_ext = jnp.concatenate([y, zero_blk], axis=1)
        r = jnp.zeros((B, nbe, p.n + 1), jnp.uint32)
        gy = None  # conditional subtrahend, DEFERRED into the next double
        qbits = [None] * bits
        for k in reversed(range(bits)):
            if gy is None:
                # r = 2r + x_bit_k (values <= 7 before propagate)
                z = 2 * r
                z = z.at[:, 0].add(xbit[k])
            else:
                # fold the pending r -= ge*y into the doubling: z =
                # 2*(r + ~gy + 1) + b, blocks <= 15 (inside the PBS
                # domain) — one msg/carry split brings it back under the
                # propagate invariant, replacing a whole extra propagate
                neg = jnp.uint32(0) - gy
                neg = neg.at[:, :, p.n].add(jnp.uint32(3 * p.delta))
                neg = neg.at[:, 0, p.n].add(jnp.uint32(p.delta))
                z = 2 * (r + neg)
                z = z.at[:, 0].add(xbit[k])
                flat = z.reshape(B * nbe, p.n + 1)
                m, cr = yield [(flat, self.tp.msg), (flat, self.tp.carry)]
                m = m.reshape(B, nbe, p.n + 1)
                cr = cr.reshape(B, nbe, p.n + 1)
                z = m.at[:, 1:].add(cr[:, : nbe - 1])  # sums <= 6
            r = yield from _propagate_g(self.tp, z)
            # ge = (r >= y), carry-only log-depth comparison
            ge = yield from self.ge_g(r, y_ext)
            # gy = ge*y via bivariate (4*ge + y_i); subtraction deferred
            # (the last iteration's never happens — r is discarded)
            qbits[k] = ge
            if k:
                gy_pre = jnp.swapaxes(4 * ge[:, None] + y_ext, 0, 1).reshape(
                    B * nbe, p.n + 1
                )
                (gy,) = yield [(gy_pre, self.tp.mul_lo)]
                gy = jnp.swapaxes(gy.reshape(nbe, B, p.n + 1), 0, 1)
        blocks = []
        for i in range(nb):
            blk = qbits[2 * i] + 2 * qbits[2 * i + 1]
            blocks.append(blk)
        # quotient blocks are already clean (two 0/1 bits, <= 3): one
        # batched refresh round, no carry propagation needed
        q = jnp.stack(blocks, axis=1)
        (m,) = yield [(q.reshape(B * nb, p.n + 1), self.tp.msg)]
        return m.reshape(B, nb, p.n + 1)

    def div_plain_g(self, x, d: int):
        """Division by a plaintext divisor via multiply-by-reciprocal
        (Granlund-Montgomery): floor(x/d) == floor(x*M / 2^k) exactly for
        all x < 2^w with l = ceil(log2 d), k = w + l, M = ceil(2^k / d)
        (then M*d - 2^k < d <= 2^l = 2^(k-w), the exactness condition).
        One widened mul_plain + a free right relabel — ~5-16x fewer
        bootstrap rounds than restoring division with a trivially
        encrypted divisor. Counterpart of the reference's ct/pt div
        (gates.rs:306-702 _plain variants, which tfhe-rs also computes
        far cheaper than ct/ct)."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        w = 2 * nb
        d &= (1 << w) - 1
        if d == 0:  # all-ones, like the restoring-division path
            return trivial_blocks(p, (1 << w) - 1, nb, B)
        if d == 1:
            return x
        if d & (d - 1) == 0:
            return (
                yield from self.shift_plain_g(x, d.bit_length() - 1, False)
            )
        l = (d - 1).bit_length()
        k = w + l
        M = ((1 << k) + d - 1) // d
        # widen so x*M (< 2^(w+k)) never truncates, then shift right by k
        nb2 = (w + k + 1) // 2
        zpad = jnp.zeros((B, nb2 - nb, p.n + 1), jnp.uint32)
        xw = jnp.concatenate([x, zpad], axis=1)
        prod = yield from self.mul_plain_g(xw, M)
        q = yield from self.shift_plain_g(prod, k, False)
        return q[:, :nb]

    # -- shifts --------------------------------------------------------
    def shift_plain_g(self, x, amount: int, left: bool):
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        width = 2 * nb
        if amount >= width:
            return trivial_blocks(p, 0, nb, B)
        blocks, bit = divmod(amount, 2)
        zero = jnp.zeros((B, 1, p.n + 1), jnp.uint32)
        if left:
            if blocks:
                x = jnp.concatenate(
                    [jnp.tile(zero, (1, blocks, 1)), x[:, : nb - blocks]], axis=1
                )
            if bit:
                x = yield from _propagate_g(self.tp, 2 * x)
        else:
            if blocks:
                x = jnp.concatenate(
                    [x[:, blocks:], jnp.tile(zero, (1, blocks, 1))], axis=1
                )
            if bit:
                flat = x.reshape(B * nb, p.n + 1)
                halves, lob2 = yield [
                    (flat, self.tp.half),
                    (flat, self.tp.lobit2),
                ]
                halves = halves.reshape(B, nb, p.n + 1)
                lob2 = lob2.reshape(B, nb, p.n + 1)
                x = halves.at[:, : nb - 1].add(lob2[:, 1:])
        return x

    def shift_plain_many_g(self, x, amounts, left: bool):
        """Batched plain-amount shifts, one per row of x with its own
        amount. Block relabels are free; all rows with an odd amount share
        ONE bootstrap round (a batched 2*x propagate for SHL, one
        halves+lobit2 pair for SHR) instead of one launch per gate."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        width = 2 * nb
        rows, odd = [], []
        for i, a in enumerate(amounts):
            if a >= width:
                rows.append(jnp.zeros((nb, p.n + 1), jnp.uint32))
                continue
            blocks, bit = divmod(a, 2)
            xi = x[i]
            if blocks:
                zpad = jnp.zeros((blocks, p.n + 1), jnp.uint32)
                xi = (
                    jnp.concatenate([zpad, xi[: nb - blocks]])
                    if left
                    else jnp.concatenate([xi[blocks:], zpad])
                )
            rows.append(xi)
            if bit:
                odd.append(i)
        base = jnp.stack(rows)
        if not odd:
            return base
        sel = jnp.asarray(odd, dtype=jnp.int32)
        sub = base[sel]
        if left:
            upd = yield from _propagate_g(self.tp, 2 * sub)
        else:
            bs = len(odd)
            flat = sub.reshape(bs * nb, p.n + 1)
            halves, lob2 = yield [
                (flat, self.tp.half),
                (flat, self.tp.lobit2),
            ]
            halves = halves.reshape(bs, nb, p.n + 1)
            lob2 = lob2.reshape(bs, nb, p.n + 1)
            upd = halves.at[:, : nb - 1].add(lob2[:, 1:])
        return base.at[sel].set(upd)

    def shift_ct_g(self, x, y, left: bool):
        """Shift by encrypted amount: mux ladder over the amount's bits
        (amounts >= width wrap mod width; documented)."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        width = 2 * nb
        ybits = []
        flat = y.reshape(B * nb, p.n + 1)
        los, his = yield [(flat, self.tp.lobit), (flat, self.tp.hibit)]
        los = los.reshape(B, nb, p.n + 1)
        his = his.reshape(B, nb, p.n + 1)
        for k in range(max(1, (width - 1).bit_length())):
            ybits.append(his[:, k // 2] if k % 2 else los[:, k // 2])
        for k, sel in enumerate(ybits):
            shifted = yield from self.shift_plain_g(x, 1 << k, left)
            x = yield from self._mux_blocks_g(sel, shifted, x)
        return x

    def _mux_blocks_g(self, sel, a, b):
        """per-block sel ? a : b via two bivariate products + linear add.

        One PBS round: sel*a_i and (1-sel)*b_i are fresh bootstraps and
        one of them is an encryption of 0, so the sum's message is the
        selected block (< 4 — no carries, nothing to propagate; the 2x
        fresh variance only nudges the next bivariate pack's input
        budget from 17 to 18 sigma^2)."""
        p = self.params
        B, nb = a.shape[0], a.shape[1]
        n1 = p.n + 1
        not_sel = jnp.uint32(0) - sel
        not_sel = not_sel.at[:, p.n].add(jnp.uint32(p.delta))
        pre1 = jnp.swapaxes(4 * sel[:, None] + a, 0, 1).reshape(B * nb, n1)
        pre2 = jnp.swapaxes(4 * not_sel[:, None] + b, 0, 1).reshape(B * nb, n1)
        t1, t2 = yield [(pre1, self.tp.mul_lo), (pre2, self.tp.mul_lo)]
        return jnp.swapaxes((t1 + t2).reshape(nb, B, n1), 0, 1)

    # -- synchronous single-op drivers ----------------------------------
    def add(self, x, y, with_carry: bool = False):
        return _run(self.dsk, self.add_g(x, y, with_carry=with_carry))

    def sub(self, x, y, with_carry: bool = False):
        return _run(self.dsk, self.sub_g(x, y, with_carry=with_carry))

    def add_sub_mixed(self, x, y, is_sub):
        return _run(self.dsk, self.add_sub_mixed_g(x, y, is_sub))

    def add_scalar_block0(self, x, v: int):
        return _run(self.dsk, self.add_scalar_block0_g(x, v))

    def mul(self, x, y, square: bool = False):
        return _run(self.dsk, self.mul_g(x, y, square=square))

    def mul_plain(self, x, c: int):
        return _run(self.dsk, self.mul_plain_g(x, c))

    def div(self, x, y):
        return _run(self.dsk, self.div_g(x, y))

    def div_plain(self, x, d: int):
        return _run(self.dsk, self.div_plain_g(x, d))

    def ge(self, x, y):
        return _run(self.dsk, self.ge_g(x, y))

    def shift_plain(self, x, amount: int, left: bool):
        return _run(self.dsk, self.shift_plain_g(x, amount, left))

    def shift_plain_many(self, x, amounts, left: bool):
        return _run(self.dsk, self.shift_plain_many_g(x, amounts, left))

    def shift_ct(self, x, y, left: bool):
        return _run(self.dsk, self.shift_ct_g(x, y, left))

    def _mux_blocks(self, sel, a, b):
        return _run(self.dsk, self._mux_blocks_g(sel, a, b))
