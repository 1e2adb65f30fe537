"""Decompose the measured PBS output-phase error into per-stage empirical
variances and pin each against its analytical model term.

tools/noise_validate.py measures the END-TO-END output-phase std against
sqrt(var_pbs_out + var_ks); when the ratio is off, this tool says WHICH
term is off: it decrypts the big-LWE ciphertext between sample-extract
and keyswitch (lwe.decrypt_phase(big=True)), giving

  - empirical var(blind rotate + sample extract)  vs  params.var_pbs_out()
  - empirical var(keyswitch contribution)         vs  params.var_ks()
    (variance of the post-KS error minus the pre-KS error, i.e. the
    exact additive KS noise realization per sample)

Runs the jnp pipeline on JAX's default device (JAX_PLATFORMS=cpu for
the CPU); the noise statistics are exact integer results, the same on
every device.

Env: PSET (default GATES_128_K3), SAMPLES (default 8192), G (default
2048), SEED. Keys are kept in <repo>/.keys, shared with noise_validate.
"""
import json
import math
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import numpy as np
import jax.numpy as jnp

from helm_tpu import params as P
from helm_tpu.fhe import lwe, ops, pbs_jnp
from helm_tpu.fhe.keys import load_or_generate

p = getattr(P, os.environ.get("PSET", "GATES_128_K3"))
SAMPLES = int(os.environ.get("SAMPLES", "8192"))
G = int(os.environ.get("G", "2048"))
seed = int(os.environ.get("SEED", "7"))

ck, sk = load_or_generate(
    str(pathlib.Path(__file__).resolve().parents[1] / ".keys"), p, seed
)
dsk = pbs_jnp.DeviceServerKey.from_host(sk)


@jax.jit
def run(lin, tv):
    if p.grouping > 1:
        acc = pbs_jnp.blind_rotate_multibit(dsk, lin, tv)
    else:
        acc = pbs_jnp.blind_rotate(dsk, lin, tv)
    big = ops.sample_extract(jnp, acc, p.k, p.N)
    small = pbs_jnp.keyswitch(dsk, big)
    return big, small


tv = jnp.asarray(pbs_jnp.gates_test_poly(p))
rng = np.random.default_rng(seed)

sq_pbs = sq_out = sq_ks = 0.0
total = 0
t0 = time.time()
for _ in range((SAMPLES + G - 1) // G):
    b1 = rng.integers(0, 2, G).astype(bool)
    b2 = rng.integers(0, 2, G).astype(bool)
    lin = (
        lwe.encrypt(ck, lwe.encode_bool(b1))
        + lwe.encrypt(ck, lwe.encode_bool(b2))
    ).astype(np.uint32)
    lin[:, p.n] += np.uint32((-(1 << 29)) % (1 << 32))
    big, small = run(jnp.asarray(lin), tv)
    exp = np.where(b1 & b2, 1 << 29, (-(1 << 29)) % (1 << 32)).astype(np.int64)

    def err_of(ph):
        return (((ph.astype(np.int64) - exp) + (1 << 31)) % (1 << 32)) - (
            1 << 31
        )

    e_pbs = err_of(lwe.decrypt_phase(ck, np.asarray(big), big=True))
    e_out = err_of(lwe.decrypt_phase(ck, np.asarray(small)))
    e_ks = e_out - e_pbs  # exact per-sample keyswitch noise realization
    sq_pbs += float((e_pbs.astype(np.float64) ** 2).sum())
    sq_out += float((e_out.astype(np.float64) ** 2).sum())
    sq_ks += float((e_ks.astype(np.float64) ** 2).sum())
    total += G
    print(
        f"[{total}/{SAMPLES}] pbs_std_ratio="
        f"{math.sqrt(sq_pbs/total)/math.sqrt(p.var_pbs_out()):.4f} "
        f"ks_std_ratio={math.sqrt(sq_ks/total)/math.sqrt(p.var_ks()):.4f} "
        f"out_std_ratio={math.sqrt(sq_out/total)/math.sqrt(p.var_pbs_out()+p.var_ks()):.4f} "
        f"({time.time()-t0:.0f}s)",
        flush=True,
    )

res = {
    "params": p.name,
    "samples": total,
    "pbs_std_model": round(math.sqrt(p.var_pbs_out()), 1),
    "pbs_std_measured": round(math.sqrt(sq_pbs / total), 1),
    "ks_std_model": round(math.sqrt(p.var_ks()), 1),
    "ks_std_measured": round(math.sqrt(sq_ks / total), 1),
    "out_std_model": round(math.sqrt(p.var_pbs_out() + p.var_ks()), 1),
    "out_std_measured": round(math.sqrt(sq_out / total), 1),
}
res["pbs_var_ratio"] = round((res["pbs_std_measured"] / res["pbs_std_model"]) ** 2, 4)
res["ks_var_ratio"] = round((res["ks_std_measured"] / res["ks_std_model"]) ** 2, 4)
print("RESULT " + json.dumps(res), flush=True)
