"""Key serialization (save/load client and server keys).

The reference has no key or ciphertext persistence (SURVEY.md §5 —
"every run does fresh keygen"); this framework adds explicit, unencrypted
npz serialization so large-key production deployments can reuse keys.
Files are stored uncompressed: the NTT-domain bootstrap key is close to
random, so deflate saved about a quarter of the bytes at the cost of
minutes per 128-bit key.
"""

from __future__ import annotations

import numpy as np

from ..params import ALL_PARAMS
from .lwe import ClientKey
from .server_key import ServerKey


def save_client_key(path: str, ck: ClientKey) -> None:
    np.savez(
        path,
        kind="client",
        params=ck.params.name,
        lwe_key=ck.lwe_key,
        glwe_key=ck.glwe_key,
    )


def load_client_key(path: str) -> ClientKey:
    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "client", "not a client key file"
    params = ALL_PARAMS[str(z["params"])]
    from .csprng import make_rng

    return ClientKey(params, z["lwe_key"], z["glwe_key"], make_rng())


def save_server_key(path: str, sk: ServerKey) -> None:
    from .modring import primes_for

    np.savez(
        path,
        kind="server",
        params=sk.params.name,
        # the BSK is serialized in the NTT/CRT domain, so the file is only
        # valid for the prime set it was built under (modring.primes_for)
        primes=np.asarray(primes_for(sk.params.N), dtype=np.uint32),
        bsk_ntt=sk.bsk_ntt,
        bsk_ntt_sh=sk.bsk_ntt_sh,
        ksk_limbs=sk.ksk_limbs,
    )


def load_server_key(path: str) -> ServerKey:
    from .modring import primes_for

    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "server", "not a server key file"
    params = ALL_PARAMS[str(z["params"])]
    want = np.asarray(primes_for(params.N), dtype=np.uint32)
    if "primes" in z.files:
        got = z["primes"]
    else:  # pre-PRIMES_512 files recorded no prime set: legacy mapping
        from .modring import PRIMES, PRIMES_1024

        got = np.asarray(
            PRIMES_1024 if params.N <= 1024 else PRIMES, dtype=np.uint32
        )
    if not np.array_equal(got, want):
        raise ValueError(
            f"{path}: server key was built under CRT primes "
            f"{got.tolist()} but this build uses {want.tolist()} for "
            f"N={params.N} — regenerate the key"
        )
    ksk = z["ksk_limbs"]
    want_rows = params.big_n * params.ks_level
    if ksk.shape[1] != want_rows:
        # e.g. the 2026-08-20 keyswitch geometry change (B=4/l=8 ->
        # B=2/l=14..17 on the 128-bit family): fail loudly here instead of
        # with a shape error deep inside a jitted keyswitch
        raise ValueError(
            f"{path}: KSK has {ksk.shape[1]} decomposition rows but "
            f"params '{params.name}' expect big_n*ks_level = {want_rows} "
            f"(keyswitch geometry changed) — regenerate the key"
        )
    return ServerKey(params, z["bsk_ntt"], z["bsk_ntt_sh"], ksk)


def load_or_generate(dir_path: str, params, seed=None):
    """Cache-style persistence: load (client, server) keys for `params`
    from dir_path when present, else generate and save them there.
    Backs the CLI's --keys flag."""
    import os

    from .lwe import keygen
    from .server_key import gen_server_key

    os.makedirs(dir_path, exist_ok=True)
    ckp = os.path.join(dir_path, f"ck_{params.name}.npz")
    skp = os.path.join(dir_path, f"sk_{params.name}.npz")
    if os.path.exists(ckp) and os.path.exists(skp):
        try:
            return load_client_key(ckp), load_server_key(skp)
        except ValueError as e:  # e.g. CRT prime set changed
            # NEVER overwrite the old client key in place: ciphertexts or
            # exported interop vectors encrypted under it would be
            # silently invalidated. Park both files under a .stale-N
            # suffix so they stay recoverable.
            idx = 0
            while os.path.exists(f"{ckp}.stale-{idx}") or os.path.exists(
                f"{skp}.stale-{idx}"
            ):
                idx += 1
            for p_ in (ckp, skp):
                if os.path.exists(p_):
                    os.replace(p_, f"{p_}.stale-{idx}")
            print(
                f"[keys] cached keys invalid ({e}); regenerating — old "
                f"keys kept as *.stale-{idx}"
            )
    ck = keygen(params, seed)
    sk = gen_server_key(ck)
    save_client_key(ckp, ck)
    save_server_key(skp, sk)
    return ck, sk
