"""Multi-host bring-up.

The reference is single-host shared-memory only (rayon; SURVEY.md §2
"parallelism strategies"). Here the same SPMD program that shards gate
batches across one host's GPUs (parallel/mesh.py) runs across hosts: one
JAX process per host, `jax.distributed.initialize` with an explicit
coordinator, and the mesh simply spans all global devices — XLA routes the
per-level collectives (replicated-key broadcast, sharded-batch gather at
wire scatter) over the interconnect within a host and the network across
hosts.

Usage (per host):

    from helm_tpu.parallel import distributed, mesh
    distributed.init_multihost(coordinator="10.0.0.1:8476",
                               num_processes=4, process_id=RANK)
    m = mesh.make_gate_mesh()           # spans ALL hosts' devices
    engine.set_sharding(mesh.batch_sharding(m), mesh.replicated(m))

or via the CLI: `--multihost coordinator:port,num_processes,process_id`
together with `--mesh N` (N = global device count).

Inputs are encrypted on every host identically (same client key + seed)
and `jax.device_put` with a replicated/sharded NamedSharding distributes
the global arrays; decryption gathers outputs to host 0.
"""

from __future__ import annotations

import jax


def init_multihost(
    coordinator: str, num_processes: int, process_id: int
) -> None:
    """Initialize this process's slice of the multi-host runtime.

    coordinator: "host:port" of process 0, reachable from every host.
    Safe to call once per process, before any other JAX call.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def parse_multihost_flag(spec: str) -> tuple[str, int, int]:
    """Parse the CLI's `--multihost coordinator:port,nprocs,pid` value."""
    parts = spec.split(",")
    if len(parts) != 3:
        raise ValueError(
            "--multihost expects coordinator:port,num_processes,process_id"
        )
    return parts[0], int(parts[1]), int(parts[2])
