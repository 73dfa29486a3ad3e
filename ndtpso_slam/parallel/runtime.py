"""Multi-host distributed runtime: process init, hierarchical hosts x cards mesh.

The reference has no distributed backend — inter-node communication is ROS1
TCP pub/sub plus one `omp critical` global-best merge
(`/root/reference/src/ndtpso_slam_node.cpp:80,118`,
`/root/reference/lib/ndtpso_slam/core.cpp:97-104`; SURVEY.md §2).  This module
is the JAX replacement (BASELINE config 5): `jax.distributed` process
initialization, a hierarchical `Mesh` whose outer axis crosses hosts and
whose inner axis stays within a host's cards, and solver/collective entry
points laid out so the hot collectives — per-iteration global-best exchange,
map-statistics psum — stay within a host, with only the periodic cross-host
merges leaving it.

Process bootstrap is explicit: nothing is auto-detected, so the same binary
runs single-process, or as a multi-process job (exercised on the CPU by
tests/test_distributed_runtime.py through real gloo collectives) when given

    NDTPSO_COORDINATOR=host:port   coordinator address (process 0's)
    NDTPSO_NUM_PROCESSES=N         world size
    NDTPSO_PROCESS_ID=i            this process's rank
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

HOST_AXIS = "hosts"
CARD_AXIS = "cards"
SOLVE_AXES: Tuple[str, str] = (HOST_AXIS, CARD_AXIS)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize `jax.distributed` for multi-host runs.

    Argument > environment (``NDTPSO_*``).
    Call BEFORE any other JAX API touches the backend.  Returns True if a
    multi-process runtime was initialized, False for the single-process
    fallback (nothing configured — the normal local/dev path).
    Idempotent: a second call on an initialized runtime is a no-op.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "NDTPSO_COORDINATOR"
    )
    env_n = os.environ.get("NDTPSO_NUM_PROCESSES")
    env_i = os.environ.get("NDTPSO_PROCESS_ID")
    if num_processes is None and env_n is not None:
        num_processes = int(env_n)
    if process_id is None and env_i is not None:
        process_id = int(env_i)

    # Idempotency check WITHOUT touching the backend: jax.process_count()
    # would instantiate the PJRT client, after which distributed init is
    # too late.
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return True  # already initialized
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_hier_mesh(
    n_hosts: Optional[int] = None, cards_per_host: Optional[int] = None
):
    """Hierarchical ``(hosts, cards)`` mesh: outer axis crosses hosts, inner
    axis stays within one host.

    With a real multi-process runtime the host axis follows process
    boundaries (devices grouped by ``process_index``, so shards on the inner
    axis are host-local and collectives over :data:`CARD_AXIS` never leave a
    host).  Single-process callers (tests, dryrun) pass explicit
    ``n_hosts``/``cards_per_host`` to emulate the hierarchy on virtual
    devices.
    """
    import jax
    from jax.sharding import Mesh

    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    if cards_per_host is None:
        if len(devs) % n_hosts != 0:
            raise ValueError(
                f"{len(devs)} devices do not divide over {n_hosts} hosts"
            )
        cards_per_host = len(devs) // n_hosts
    need = n_hosts * cards_per_host
    if need > len(devs):
        raise ValueError(
            f"mesh {n_hosts}x{cards_per_host} needs {need} devices, "
            f"have {len(devs)}"
        )
    arr = np.array(devs[:need]).reshape(n_hosts, cards_per_host)
    return Mesh(arr, SOLVE_AXES)


def make_hier_solver(
    mesh, map_cfg, pso_cfg, cost_mode: str = "fast", shared_map: bool = False
):
    """Jitted solve-batch sharded over BOTH mesh axes (dp over hosts x cards).

    Independent solves need no collectives at all — XLA partitions the batch
    over every device in the hierarchy; throughput scales with total cards
    and nothing crosses hosts during a solve.
    """
    from ndtpso_slam.parallel import mesh as mesh_mod

    return mesh_mod.make_sharded_solver(
        mesh, map_cfg, pso_cfg, cost_mode=cost_mode, shared_map=shared_map,
        axes=SOLVE_AXES,
    )


def shard_global(mesh, spec, local_batch):
    """Assemble a global array from each process's local batch shard.

    ``local_batch``'s leading axis is this process's slice of the global
    batch; the result is a global jax.Array sharded per ``spec`` over
    ``mesh``.  Works identically single-process (where local == global).
    """
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)

    def put(x):
        return jax.make_array_from_process_local_data(sharding, np.asarray(x))

    return jax.tree_util.tree_map(put, local_batch)


def replicate_global(mesh, value):
    """A fully-replicated global array of ``value`` over the mesh (every
    process passes the same host value — e.g. a shared map snapshot)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        return jax.make_array_from_callback(
            np.asarray(x).shape,
            NamedSharding(mesh, P()),
            lambda idx: np.asarray(x)[idx],
        )

    return jax.tree_util.tree_map(put, value)
