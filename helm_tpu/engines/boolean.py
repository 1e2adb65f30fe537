"""Boolean engines: gates mode and LUTs mode.

Counterparts of the reference's GateCircuit (circuit.rs:449-577) and
LutCircuit (circuit.rs:969-1111). The wire map is a dense device array
uint32[W, n+1]; every level executes as one jitted step: gather inputs,
per-gate linear combination, ONE batched PBS over all slots, scatter,
vectorized linear ops. Sequential circuits loop `evaluate` per cycle with
DFF state copies on the final level; the READY protocol latches outputs
obliviously (circuit.rs:482-504, 1002-1030).
"""

from __future__ import annotations

from functools import partial

import os
import time

import jax
import jax.numpy as jnp

import numpy as np

from ..circuit.graph import Circuit
from ..circuit.plan import (CircuitPlan, Q8, binarize, build_plan, decompose_wide_luts)
from ..circuit.verilog import Netlist
from ..fhe import lwe, pbs_jnp
from ..fhe.server_key import gen_server_key
from ..params import DEFAULT_GATES, DEFAULT_LUT, Q, TfheParams, warn_if_weak


def _level_body(
    shard,
    dsk,
    wires,
    slot_in,
    slot_coef,
    slot_off,
    slot_dst,
    testv,
    mux_pairs,
    mux_dst,
    lin_src,
    lin_coef,
    lin_off,
    lin_dst,
):
    n = dsk.params.n
    # wires: [W, n+1] or [B, W, n+1] (batched serving shape: B independent
    # input vectors through the same circuit — every PBS launch widens by B)
    ins = jnp.take(wires, slot_in, axis=-2)  # [.., S, 3, n+1]
    coef = slot_coef[..., None].astype(jnp.uint32)
    pre = jnp.sum(ins * coef, axis=-2, dtype=jnp.uint32)
    pre = pre.at[..., n].add(slot_off)
    lead = pre.shape[:-2]
    pre = pre.reshape(-1, n + 1)
    if lead and testv.shape[0] != 1 and testv.shape[0] != pre.shape[0]:
        testv = jnp.tile(testv, (pre.shape[0] // testv.shape[0], 1))
    if shard is not None:
        # gate-parallel across the mesh: the PBS batch is the scaling axis;
        # GSPMD partitions the whole pipeline from the constraint alone
        pre = jax.lax.with_sharding_constraint(pre, shard)
        if testv.shape[0] == pre.shape[0]:
            testv = jax.lax.with_sharding_constraint(testv, shard)
    outs = pbs_jnp.bootstrap(dsk, pre, testv)
    outs = outs.reshape(lead + (-1, n + 1))
    wires = wires.at[..., slot_dst, :].set(outs)
    mval = jnp.take(outs, mux_pairs[:, 0], axis=-2) + jnp.take(
        outs, mux_pairs[:, 1], axis=-2
    )
    mval = mval.at[..., n].add(jnp.uint32(Q8))
    wires = wires.at[..., mux_dst, :].set(mval)
    lv = jnp.take(wires, lin_src, axis=-2) * lin_coef[:, None].astype(jnp.uint32)
    lv = lv.at[..., n].add(lin_off)
    return wires.at[..., lin_dst, :].set(lv)


_pbs_level_step = jax.jit(_level_body, static_argnums=(0,), donate_argnums=(2,))


@partial(jax.jit, static_argnums=(0,), donate_argnums=(2,))
def _scan_eval_step(shard, dsk, wires, levels, testv_base):
    """All levels in ONE jitted lax.scan (latency mode): every level is
    padded to the same slot/mux/lin widths so a single compiled PBS
    program is reused for the whole circuit — one dispatch, one compile,
    no host gaps between levels.

    levels: dict of stacked arrays, leading axis = number of levels.
    testv_base: [1, N] gates test poly, or the [T, N] LUT test-poly bank
    (levels then carries a per-slot "testv_sel").
    """

    def body(w, lv):
        tv = (
            testv_base[lv["testv_sel"]]
            if "testv_sel" in lv
            else testv_base
        )
        w = _level_body(
            shard,
            dsk,
            w,
            lv["slot_in"],
            lv["slot_coef"],
            lv["slot_off"],
            lv["slot_dst"],
            tv,
            lv["mux_pairs"],
            lv["mux_dst"],
            lv["lin_src"],
            lv["lin_coef"],
            lv["lin_off"],
            lv["lin_dst"],
        )
        return w, None

    wires, _ = jax.lax.scan(body, wires, levels)
    return wires


@partial(jax.jit, static_argnums=(0, 5), donate_argnums=(2,))
def _scan_eval_cycles(shard, dsk, wires, chunks, testv_base, cycles):
    """`cycles` full circuit evaluations in ONE jitted dispatch.

    Sequential circuits advance state purely through the wire array (DFF
    copies are plan levels), so scanning the fused level program over a
    cycle axis is semantically identical to `cycles` evaluate() calls —
    but pays one host dispatch instead of cycles x levels, which matters
    for small sequential circuits, where per-dispatch overhead dominates.

    chunks: tuple of stacked-level dicts (as built by _stack_levels).
    """

    def cycle(w, _):
        for lvs in chunks:
            def body(w_, lv):
                tv = (
                    testv_base[lv["testv_sel"]]
                    if "testv_sel" in lv
                    else testv_base
                )
                w_ = _level_body(
                    shard, dsk, w_,
                    lv["slot_in"], lv["slot_coef"], lv["slot_off"],
                    lv["slot_dst"], tv, lv["mux_pairs"], lv["mux_dst"],
                    lv["lin_src"], lv["lin_coef"], lv["lin_off"],
                    lv["lin_dst"],
                )
                return w_, None

            w, _ = jax.lax.scan(body, w, lvs)
        return w, None

    wires, _ = jax.lax.scan(cycle, wires, None, length=cycles)
    return wires


@partial(jax.jit, donate_argnums=(0,))
def _lin_level_step(wires, lin_src, lin_coef, lin_off, lin_dst):
    n1 = wires.shape[-1] - 1
    lv = jnp.take(wires, lin_src, axis=-2) * lin_coef[:, None].astype(jnp.uint32)
    lv = lv.at[..., n1].add(lin_off)
    return wires.at[..., lin_dst, :].set(lv)


@jax.jit
def _ready_step_gates(dsk, ready, new, valid, testv):
    """valid <- mux(READY, new, valid), batched as one PBS launch.

    ready: [.., n+1]; new/valid: [.., n_out, n+1] (optional leading batch)."""
    n = dsk.params.n
    off = jnp.uint32((-Q8) % Q)
    pre1 = (ready[..., None, :] + new).at[..., n].add(off)
    pre2 = (valid - ready[..., None, :]).at[..., n].add(off)
    both = jnp.concatenate([pre1, pre2], axis=-2)
    outs = pbs_jnp.bootstrap(dsk, both.reshape(-1, n + 1), testv).reshape(
        both.shape
    )
    k = new.shape[-2]
    s1, s2 = outs[..., :k, :], outs[..., k:, :]
    return (s1 + s2).at[..., n].add(jnp.uint32(Q8))


@jax.jit
def _ready_step_lut(dsk, ready, new, valid, testv_and, delta):
    """valid <- new*READY + valid*(1-READY) (circuit.rs:1012-1030)."""
    n = dsk.params.n
    not_ready = (jnp.uint32(0) - ready).at[..., n].add(delta)
    pre1 = 2 * new + ready[..., None, :]
    pre2 = 2 * valid + not_ready[..., None, :]
    both = jnp.concatenate([pre1, pre2], axis=-2)
    outs = pbs_jnp.bootstrap(dsk, both.reshape(-1, n + 1), testv_and).reshape(
        both.shape
    )
    k = new.shape[-2]
    return outs[..., :k, :] + outs[..., k:, :]


def _pad_noop_levels(stk: dict, pad_l: int, trash: int) -> dict:
    """Append no-op levels (every destination = the trash wire)."""
    noop_fill = {"slot_dst": trash, "mux_dst": trash, "lin_dst": trash}
    return {
        k: np.concatenate(
            [v, np.full((pad_l,) + v.shape[1:], noop_fill.get(k, 0), v.dtype)],
            axis=0,
        )
        for k, v in stk.items()
    }


class BooleanEngine:
    """Gates- or LUTs-mode encrypted circuit evaluator."""

    def __init__(
        self,
        mode: str = "gates",
        params: TfheParams | None = None,
        seed=None,
        fuse_levels: bool | None = None,
        keys=None,
    ):
        # fuse_levels: True/False force; None = auto-decide at compile()
        # from the level profile (narrow/deep circuits fuse)
        assert mode in ("gates", "lut")
        self.fuse_levels = fuse_levels
        self.mode = mode
        self.params = params or (DEFAULT_GATES if mode == "gates" else DEFAULT_LUT)
        warn_if_weak(self.params)
        if keys is not None:  # preloaded (client, server) keys (fhe/keys.py)
            self.client_key, sk = keys
            assert self.client_key.params.name == self.params.name
        else:
            self.client_key = lwe.keygen(self.params, seed)
            sk = gen_server_key(self.client_key)
        self.dsk = pbs_jnp.DeviceServerKey.from_host(sk)
        self.plan: CircuitPlan | None = None
        self._batch_shard = None
        self._repl_shard = None
        self._min_slots = 1
        self._testv_gates = jnp.asarray(pbs_jnp.gates_test_poly(self.params))
        if mode == "lut":
            and_tab = [
                ((m >> 1) & 1) & (m & 1) for m in range(self.params.msg_space // 2)
            ]
            self._testv_and = jnp.asarray(
                pbs_jnp.lut_test_poly(self.params, np.array(and_tab, np.uint64))
            )[None, :]

    def set_sharding(self, batch_shard, repl_shard) -> None:
        """Enable gate sharding (call before compile; parallel/mesh.py)."""
        assert self.plan is None, "set_sharding must be called before compile()"
        self._batch_shard = batch_shard
        self._repl_shard = repl_shard
        self._min_slots = batch_shard.mesh.size

    # -- compilation ---------------------------------------------------
    def compile(self, netlist: Netlist) -> None:
        gates = binarize(netlist.gates)
        if self.mode == "lut":
            gates = decompose_wide_luts(gates)
        circuit = Circuit(
            gates, netlist.inputs, netlist.outputs, netlist.dff_outputs
        )
        circuit.sort_circuit()
        circuit.compute_levels()
        # binarize/decompose introduce fresh intermediate wires
        wire_set = set(netlist.wire_set) | {g.output for g in gates}
        self.plan = build_plan(
            circuit,
            wire_set,
            self.params,
            self.mode,
            lut_test_poly_fn=lambda tab: pbs_jnp.lut_test_poly(self.params, tab),
            min_slots=self._min_slots,
        )
        self._testv_bank = (
            jnp.asarray(self.plan.testv_bank)
            if self.plan.testv_bank is not None
            else None
        )
        self._dev_levels = [
            {
                "slot_in": jnp.asarray(lp.slot_in),
                "slot_coef": jnp.asarray(lp.slot_coef),
                "slot_off": jnp.asarray(lp.slot_off),
                "slot_dst": jnp.asarray(lp.slot_dst),
                "testv_sel": (
                    jnp.asarray(lp.testv_sel) if lp.testv_sel is not None else None
                ),
                "mux_pairs": jnp.asarray(lp.mux_pairs),
                "mux_dst": jnp.asarray(lp.mux_dst),
                "lin_src": jnp.asarray(lp.lin_src),
                "lin_coef": jnp.asarray(lp.lin_coef),
                "lin_off": jnp.asarray(lp.lin_off),
                "lin_dst": jnp.asarray(lp.lin_dst),
            }
            for lp in self.plan.levels
        ]
        fuse = self.fuse_levels
        if fuse is None:
            # auto: fusing wins when per-level dispatch dominates — many
            # levels, small padded width, bounded pad waste
            lps = self.plan.levels
            S = max(max(lp.slot_in.shape[0] for lp in lps), 1)
            real = max(sum(lp.slot_in.shape[0] for lp in lps), 1)
            fuse = (
                8 <= len(lps)
                and S <= 256
                and S * len(lps) <= 3 * real
            )
        # deep circuits are CHUNKED into uniform-length scans (see
        # _max_chunk_levels); equal-shape chunks share one compiled
        # executable, and the last chunk is padded with no-op levels
        # (every destination = the trash wire). The chunk length is
        # batch-dependent, so stacking and chunking are separate steps.
        self._scan_stacked = self._stack_levels() if fuse else None
        self._chunk_cache: dict[int, list] = {}
        self._scan_levels = self._chunks_for_batch(1) if fuse else None

    def _stack_levels(self):
        """Pad all plan levels to uniform widths and stack for lax.scan."""
        lps = self.plan.levels
        trash = self.plan.num_wires - 1
        S = max(max(lp.slot_in.shape[0] for lp in lps), self._min_slots, 1)
        M = max(max(lp.mux_pairs.shape[0] for lp in lps), 1)
        L = max(max(lp.lin_src.shape[0] for lp in lps), 1)

        def pad(a, n, fill):
            if a.shape[0] == n:
                return a
            extra = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, extra], axis=0)

        stk = {
            "slot_in": np.stack([pad(lp.slot_in, S, 0) for lp in lps]),
            "slot_coef": np.stack([pad(lp.slot_coef, S, 0) for lp in lps]),
            "slot_off": np.stack([pad(lp.slot_off, S, 0) for lp in lps]),
            "slot_dst": np.stack([pad(lp.slot_dst, S, trash) for lp in lps]),
            "mux_pairs": np.stack([pad(lp.mux_pairs, M, 0) for lp in lps]),
            "mux_dst": np.stack([pad(lp.mux_dst, M, trash) for lp in lps]),
            "lin_src": np.stack([pad(lp.lin_src, L, 0) for lp in lps]),
            "lin_coef": np.stack([pad(lp.lin_coef, L, 0) for lp in lps]),
            "lin_off": np.stack([pad(lp.lin_off, L, 0) for lp in lps]),
            "lin_dst": np.stack([pad(lp.lin_dst, L, trash) for lp in lps]),
        }
        if self.mode == "lut":
            stk["testv_sel"] = np.stack(
                [pad(lp.testv_sel, S, 0) for lp in lps]
            )
        return stk

    def _max_chunk_levels(self, batch: int) -> int:
        """Per-dispatch level cap: at most HELM_TPU_MAXC (default 128)
        levels per fused scan, and at most HELM_TPU_DISPATCH_LANES
        (default 184320) chunk levels x batch x slot width.

        Both defaults come from crashes of the TPU worker this program
        first ran on: a 358-level scan, and AES-128 at batch 8 with 120
        levels of 2048 slots. No failure of either kind is known on the
        GPU; ROADMAP.md lists deciding them from GPU measurements."""
        maxc = int(os.environ.get("HELM_TPU_MAXC", "128"))
        bound = int(os.environ.get("HELM_TPU_DISPATCH_LANES", "184320"))
        S = max(
            (lp.slot_in.shape[0] for lp in self.plan.levels),
            default=1,
        )
        lw = max(1, batch) * max(S, 1)
        return max(1, min(maxc, bound // lw))

    def _chunks_for_batch(self, batch: int):
        """Chunk the stacked levels into <= _max_chunk_levels(batch)-level
        scans of EQUAL length (one compiled executable, ceil(L/C)
        dispatches); the tail is padded with no-op levels whose every
        destination is the trash wire."""
        if self._scan_stacked is None:
            return None
        batch = max(1, int(batch))
        cached = self._chunk_cache.get(batch)
        if cached is not None:
            return cached
        stk = self._scan_stacked
        trash = self.plan.num_wires - 1
        MAXC = self._max_chunk_levels(batch)
        L_tot = stk["slot_in"].shape[0]
        nch = -(-L_tot // MAXC)
        C = -(-L_tot // nch)
        pad_l = nch * C - L_tot
        if pad_l:
            stk = _pad_noop_levels(stk, pad_l, trash)
        chunks = [
            {k: jnp.asarray(v[i * C : (i + 1) * C]) for k, v in stk.items()}
            for i in range(nch)
        ]
        self._chunk_cache[batch] = chunks
        return chunks

    # -- client role ---------------------------------------------------
    def _encode(self, v) -> np.ndarray:
        if self.mode == "gates":
            return lwe.encode_bool(bool(v))
        return lwe.encode_msg(self.params, int(bool(v)))

    def _encrypt_host(self, input_wire_map: dict) -> np.ndarray:
        p = self.params
        zero = self._encode(False)
        wires = np.zeros((self.plan.num_wires, p.n + 1), dtype=np.uint32)
        wires[:, p.n] = zero  # trivial encryptions of false/0
        dummy = not input_wire_map or "dummy" in input_wire_map
        dff = set(self.plan.dff_outputs)
        for w in self.plan.input_wires:
            if w in dff:
                continue
            if dummy:
                val = False
            elif w not in input_wire_map:
                raise KeyError(f'Input wire "{w}" not found in input wires!')
            else:
                val = input_wire_map[w]
            wires[self.plan.wire_index[w]] = lwe.encrypt(
                self.client_key, self._encode(val)
            )
        for w in self.plan.dff_outputs:
            wires[self.plan.wire_index[w]] = lwe.encrypt(
                self.client_key, self._encode(False)
            )
        return wires

    def _encrypt_host_batched(self, maps: list) -> np.ndarray:
        """All B maps' input bits in ONE encryption call — giant serving
        batches hit the threaded C++ encryptor via lwe.encrypt_many."""
        p = self.params
        zero = self._encode(False)
        B, W = len(maps), self.plan.num_wires
        arr = np.zeros((B, W, p.n + 1), dtype=np.uint32)
        arr[:, :, p.n] = zero  # trivial encryptions of false/0
        dff = set(self.plan.dff_outputs)
        idxs, mus = [], []
        for m in maps:
            dummy = not m or "dummy" in m
            for w in self.plan.input_wires:
                if w in dff:
                    continue
                if dummy:
                    val = False
                elif w not in m:
                    raise KeyError(
                        f'Input wire "{w}" not found in input wires!'
                    )
                else:
                    val = m[w]
                idxs.append(self.plan.wire_index[w])
                mus.append(self._encode(val))
            for w in self.plan.dff_outputs:
                idxs.append(self.plan.wire_index[w])
                mus.append(self._encode(False))
        if not idxs:
            return arr
        cts = lwe.encrypt_many(self.client_key, np.asarray(mus))
        per = len(idxs) // B
        for bi in range(B):
            sl = slice(bi * per, (bi + 1) * per)
            arr[bi, np.asarray(idxs[sl])] = cts[sl]
        return arr

    def encrypt_inputs(self, input_wire_map) -> jax.Array:
        """Reference EvalCircuit::encrypt_inputs (circuit.rs:450-480).

        A list of input maps encrypts to the batched serving shape
        [B, W, n+1]: every level's PBS launch then bootstraps B*S slots —
        the throughput shape for narrow circuits, with no reference analog."""
        assert self.plan is not None
        if isinstance(input_wire_map, (list, tuple)):
            arr = self._encrypt_host_batched(list(input_wire_map))
        else:
            arr = self._encrypt_host(input_wire_map)
        dev = jnp.asarray(arr)
        if self._repl_shard is not None:
            dev = jax.device_put(dev, self._repl_shard)
        return dev

    # -- evaluation ----------------------------------------------------
    def evaluate(self, wires: jax.Array, verbose: bool = False) -> jax.Array:
        assert self.plan is not None
        self._lvl_t0 = time.perf_counter() if verbose else None
        if self._scan_levels is not None:
            testv = (
                self._testv_bank if self.mode == "lut" else self._testv_gates
            )
            B = wires.shape[0] if wires.ndim == 3 else 1
            chunks = self._chunks_for_batch(B)
            for chunk in chunks:
                wires = _scan_eval_step(
                    self._batch_shard,
                    self.dsk,
                    wires,
                    chunk,
                    testv,
                )
            if verbose:
                print(
                    f"  Evaluated all {len(self.plan.levels)} levels in"
                    f" {len(chunks)} fused scan launch(es)"
                )
            return wires
        total = len(self._dev_levels)
        for i, lp in enumerate(self._dev_levels):
            if lp["slot_in"].shape[0] == 0:
                wires = _lin_level_step(
                    wires, lp["lin_src"], lp["lin_coef"], lp["lin_off"], lp["lin_dst"]
                )
            else:
                if self.mode == "lut":
                    testv = self._testv_bank[lp["testv_sel"]]
                else:
                    testv = self._testv_gates
                wires = _pbs_level_step(
                    self._batch_shard,
                    self.dsk,
                    wires,
                    lp["slot_in"],
                    lp["slot_coef"],
                    lp["slot_off"],
                    lp["slot_dst"],
                    testv,
                    lp["mux_pairs"],
                    lp["mux_dst"],
                    lp["lin_src"],
                    lp["lin_coef"],
                    lp["lin_off"],
                    lp["lin_dst"],
                )
            if verbose:
                ns = self.plan.levels[i].num_slots
                extra = ""
                if self.mode == "lut" and ns:
                    # amortized per-LUT-gate PBS time (reference prints a
                    # per-gate "PBS time: {} us" at src/gates.rs:293-302;
                    # here gates of a level share one batched launch)
                    import numpy as _np

                    _np.asarray(wires[0, 0])  # sync this level's launch
                    now = time.perf_counter()
                    if self._lvl_t0 is not None:
                        us = (now - self._lvl_t0) * 1e6 / ns
                        extra = f"; PBS time: {us:.0f} us/gate amortized"
                    self._lvl_t0 = now
                print(
                    f"  Evaluated gates in level [{i + 1}/{total}]"
                    f" ({ns} PBS slots in one launch){extra}"
                )
        return wires

    def evaluate_cycles(self, wires: jax.Array, cycles: int) -> jax.Array:
        """Evaluate `cycles` sequential cycles in one jitted dispatch.

        Bit-identical to calling evaluate() `cycles` times (DFF state
        advances through the wire array; tests pin the equality) but
        pays one host dispatch total — the per-cycle latency win for
        small sequential circuits (s27, crc32) where per-level dispatch
        overhead dominates. Falls back to the evaluate() loop when the
        total unrolled program would exceed the per-dispatch level cap
        (levels x cycles over _max_chunk_levels) or when the circuit uses
        the READY protocol (host-side latch step per cycle).
        """
        assert self.plan is not None
        n_lv = len(self.plan.levels)
        B = wires.shape[0] if wires.ndim == 3 else 1
        if self.has_ready() or n_lv * cycles > self._max_chunk_levels(B):
            for _ in range(cycles):
                wires = self.evaluate(wires)
            return wires
        if self._scan_stacked is None:
            self._scan_stacked = self._stack_levels()
        # within the bound the chunker returns exactly one chunk
        chunks = self._chunks_for_batch(B)
        testv = self._testv_bank if self.mode == "lut" else self._testv_gates
        return _scan_eval_cycles(
            self._batch_shard,
            self.dsk,
            wires,
            tuple(chunks),
            testv,
            cycles,
        )

    # -- READY protocol ------------------------------------------------
    def has_ready(self) -> bool:
        return self.plan is not None and "READY" in self.plan.wire_index

    def init_ready(self, batch: int | None = None) -> jax.Array:
        """Trivial-zero latches for output wires (circuit.rs:482-490)."""
        p = self.params
        n_out = len(self.plan.output_wires)
        shape = (n_out, p.n + 1) if batch is None else (batch, n_out, p.n + 1)
        valid = np.zeros(shape, dtype=np.uint32)
        valid[..., p.n] = self._encode(False)
        return jnp.asarray(valid)

    def evaluate_ready(self, wires: jax.Array, valid: jax.Array) -> jax.Array:
        idx = jnp.asarray(
            [self.plan.wire_index[w] for w in self.plan.output_wires],
            dtype=jnp.int32,
        )
        ready = wires[..., self.plan.wire_index["READY"], :]
        new = jnp.take(wires, idx, axis=-2)
        if self.mode == "gates":
            return _ready_step_gates(self.dsk, ready, new, valid, self._testv_gates)
        return _ready_step_lut(
            self.dsk,
            ready,
            new,
            valid,
            self._testv_and,
            jnp.uint32(self.params.delta),
        )

    # -- decryption ----------------------------------------------------
    def _gather_host(self, wires) -> np.ndarray:
        from ..parallel.mesh import gather_host

        return gather_host(wires, self._repl_shard)

    def decrypt_outputs(self, wires: jax.Array, from_valid: bool = False):
        host = self._gather_host(wires)
        if host.ndim == 3:  # batched: one dict per input vector
            return [self._decrypt_outputs_one(h, from_valid) for h in host]
        return self._decrypt_outputs_one(host, from_valid)

    def _decrypt_outputs_one(self, host: np.ndarray, from_valid: bool) -> dict:
        out = {}
        for i, w in enumerate(self.plan.output_wires):
            row = host[i] if from_valid else host[self.plan.wire_index[w]]
            ph = lwe.decrypt_phase(self.client_key, row)
            if self.mode == "gates":
                out[w] = bool(lwe.decode_bool(ph))
            else:
                out[w] = int(lwe.decode_msg(self.params, ph))
        return out

    def decrypt_all_wires(self, wires: jax.Array):
        """Every wire, not just outputs — the reference tests assert equality
        on all wires (tests/circuit_test.rs:91-93)."""
        host = self._gather_host(wires)
        if host.ndim == 3:
            return [self._decrypt_all_one(h) for h in host]
        return self._decrypt_all_one(host)

    def _decrypt_all_one(self, host: np.ndarray) -> dict:
        out = {}
        for w, i in self.plan.wire_index.items():
            ph = lwe.decrypt_phase(self.client_key, host[i])
            if self.mode == "gates":
                out[w] = bool(lwe.decode_bool(ph))
            else:
                out[w] = int(lwe.decode_msg(self.params, ph))
        return out
