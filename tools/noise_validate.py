"""Empirical PBS noise validation at a production set.

Measures the post-bootstrap phase-error distribution over SAMPLES
(default 2^20) gate bootstraps at PSET (default GATES_128_K3, the
deployment set) and pins it against the analytical model behind every
pbs_failure_log2 claim in SECURITY.md:

  - measured phase-error std vs sqrt(var_pbs_out + var_ks)  (the model)
  - worst observed |error| vs the gates decision margin q/8
  - decision-failure count (expected 0 below ~2^25 samples at the
    GATES_128_K3 modelled rate of 2^-37 per bootstrap)

The pipeline is the production gate path: fresh encrypt -> AND linear
combo -> jitted pbs_jnp.bootstrap (blind rotate + sample extract +
keyswitch) on JAX's default device -> host decrypt_phase. The noise
statistics are exact integer results, the same on every device. Keys are
kept in <repo>/.keys (fhe/keys.py load_or_generate).

Env: PSET, SAMPLES, G (batch per pass, default 2048), SEED.
Output: one RESULT json line for SECURITY.md.
"""
import json
import math
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from helm_tpu.compile_cache import enable_compile_cache

enable_compile_cache()
import numpy as np

import jax
import jax.numpy as jnp

from helm_tpu import params as P
from helm_tpu.fhe import lwe, pbs_jnp
from helm_tpu.fhe.keys import load_or_generate

p = getattr(P, os.environ.get("PSET", "GATES_128_K3"))
SAMPLES = int(os.environ.get("SAMPLES", str(1 << 20)))
G = int(os.environ.get("G", "2048"))
seed = int(os.environ.get("SEED", "7"))

ck, sk = load_or_generate(
    str(pathlib.Path(__file__).resolve().parents[1] / ".keys"), p, seed
)
dsk = pbs_jnp.DeviceServerKey.from_host(sk)
bootstrap = jax.jit(pbs_jnp.bootstrap)

tv = jnp.asarray(pbs_jnp.gates_test_poly(p))
rng = np.random.default_rng(seed)

model = math.sqrt(p.var_pbs_out() + p.var_ks())
margin = float(P.Q) / 8.0  # gates decision margin (pbs_failure_log2)

n_batches = (SAMPLES + G - 1) // G
errs_sq = 0.0
worst = 0
fails = 0
total = 0
hist_sigmas = np.zeros(12, dtype=np.int64)  # |err| in [s, s+1) model sigmas
t_start = time.time()
for bi in range(n_batches):
    b1 = rng.integers(0, 2, G).astype(bool)
    b2 = rng.integers(0, 2, G).astype(bool)
    lin = (
        lwe.encrypt(ck, lwe.encode_bool(b1))
        + lwe.encrypt(ck, lwe.encode_bool(b2))
    ).astype(np.uint32)
    lin[:, p.n] += np.uint32((-(1 << 29)) % (1 << 32))
    out = np.asarray(bootstrap(dsk, jnp.asarray(lin), tv))
    ph = lwe.decrypt_phase(ck, out).astype(np.int64)
    exp = np.where(b1 & b2, 1 << 29, (-(1 << 29)) % (1 << 32)).astype(
        np.int64
    )
    err = ((ph - exp + (1 << 31)) % (1 << 32)) - (1 << 31)
    errs_sq += float((err.astype(np.float64) ** 2).sum())
    worst = max(worst, int(np.abs(err).max()))
    fails += int((np.abs(err) >= margin).sum())
    s = np.minimum(
        (np.abs(err).astype(np.float64) / model).astype(np.int64), 11
    )
    hist_sigmas += np.bincount(s, minlength=12)
    total += G
    if bi % 32 == 0 or bi == n_batches - 1:
        el = time.time() - t_start
        print(
            f"[{bi+1}/{n_batches}] {total} samples, "
            f"std_ratio={math.sqrt(errs_sq/total)/model:.4f}, "
            f"worst={worst/model:.2f} sigma, fails={fails} "
            f"({total/el:.0f} bs/s incl host)",
            flush=True,
        )

measured = math.sqrt(errs_sq / total)
res = {
    "params": p.name,
    "samples": total,
    "model_std": round(model, 1),
    "measured_std": round(measured, 1),
    "std_ratio": round(measured / model, 4),
    "worst_abs_err_sigma": round(worst / model, 2),
    "margin_sigma": round(margin / model, 2),
    "decision_failures": fails,
    "model_failure_log2": round(p.pbs_failure_log2(), 1),
    "hist_abs_err_sigma": hist_sigmas.tolist(),
}
print("RESULT " + json.dumps(res), flush=True)
