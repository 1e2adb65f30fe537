"""Multi-chip gate sharding.

The reference parallelizes a level across rayon threads on one host
(circuit.rs:531); the scaling axis here is the PBS batch: gates of each
level are sharded across a 1-D device mesh ("gates" axis), keys replicated,
and XLA's SPMD partitioner inserts the (small) collectives when sharded
bootstrap outputs scatter back into the replicated wire state. Between the
GPUs of one host that exchange runs over NVLink, all to all, so the mesh
needs no topology shaping; multi-host runs use the same program under
jax.distributed.

Tested on a virtual 8-device CPU mesh (tests/test_sharding.py), by
__graft_entry__.dryrun_multichip, and on four H100s by
`python chip_smoke.py --four-cards`.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_gate_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"requested {n} devices, only {len(devs)} available")
    return Mesh(np.array(devs[:n]), axis_names=("gates",))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """PBS batches: shard the leading (gate/slot) axis, replicate the rest."""
    return NamedSharding(mesh, P("gates"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_engine(engine, n_devices: int | None = None) -> Mesh:
    """Turn on gate sharding for a Boolean/Arith engine."""
    mesh = make_gate_mesh(n_devices)
    engine.set_sharding(batch_sharding(mesh), replicated(mesh))
    return mesh


def gather_host(wires, repl_shard) -> np.ndarray:
    """Materialize device wire state host-side. Under multi-process
    (multi-host) meshes evaluation can leave `wires` sharded across
    non-addressable devices; re-replicate first (an all-gather) so every
    controller sees every wire."""
    if (
        isinstance(wires, jax.Array)
        and not wires.is_fully_addressable
        and repl_shard is not None
    ):
        wires = jax.device_put(wires, repl_shard)
    return np.asarray(wires)
