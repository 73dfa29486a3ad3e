"""Device-mesh scaling of scan-match solves.

The reference's only cross-instance parallelism is deployment-level: one ROS
node per LiDAR, zero shared state (`launch/lidar_front.launch`,
`launch/lidar_back.launch`; SURVEY.md §2).  Here the same capability is a
sharded batch axis: B independent solves (scan pairs, robots, relocalization
hypotheses) are vmapped on-chip and sharded across a `jax.sharding.Mesh`
with `shard_map` — data parallelism over the cards' interconnect instead
of ROS TCP.

Everything is pure SPMD: no collectives are needed for independent solves;
multi-swarm exchange and map merges (the collective cases) live in
`multi_swarm.py` and `distributed.py`.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ndtpso_slam.config import MapConfig, PSOConfig
from ndtpso_slam.models import cost as cost_mod
from ndtpso_slam.models.ndt_map import MapSnapshot
from ndtpso_slam.models.pso import pso_solve

SOLVE_AXIS = "solves"


def make_mesh(n_devices: Optional[int] = None, axis: str = SOLVE_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


STENCIL_RADIUS = cost_mod.DEFAULT_STENCIL_RADIUS

# Every batched cost/solver mode `_solve_batch_impl` dispatches on; an
# unknown string is rejected up front rather than running another path.
COST_MODES = frozenset(
    {"exact", "fast", "fast_local", "fast_matmul", "local_exact", "rollout"}
)


def _solve_one(key, guess, deviation, snap, points, valid, map_cfg, pso_cfg,
               cost_mode, optimizer="pso"):
    if cost_mode == "fast":
        cost_fn = lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points(bind, snap, points, valid, map_cfg)
        )
    elif cost_mode == "fast_local":
        nbr = cost_mod.bind_neighborhood(
            guess, snap, points, valid, map_cfg, radius=STENCIL_RADIUS
        )
        cost_fn = lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points_local(bind, nbr, points, map_cfg)
        )
    elif cost_mode == "fast_matmul":
        # One-hot matmul binder (bit-identical to `fast`'s gather,
        # cost.py:bind_points_matmul).
        tbl = cost_mod.snapshot_table(snap)
        cost_fn = lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points_matmul(bind, tbl, points, valid, map_cfg)
        )
    elif cost_mode == "local_exact":
        nbr = cost_mod.bind_neighborhood(
            guess, snap, points, valid, map_cfg, radius=STENCIL_RADIUS
        )
        cost_fn = lambda poses, bind: cost_mod.stencil_exact_cost(
            poses, nbr, points, map_cfg
        )
    else:
        cost_fn = lambda poses, bind: cost_mod.ndt_cost(
            poses, snap, points, valid, map_cfg
        )
    if optimizer == "glir":
        from ndtpso_slam.models.pso import glir_pso_solve

        return glir_pso_solve((key[0], key[1]), guess, deviation, cost_fn, pso_cfg)
    return pso_solve((key[0], key[1]), guess, deviation, cost_fn, pso_cfg)


def _solve_batch_impl(
    keys, guesses, deviations, snaps, points, valid, map_cfg, pso_cfg,
    cost_mode, shared_map=False, optimizer="pso", early_exit=0,
):
    if cost_mode not in COST_MODES:
        raise ValueError(
            f"unknown cost_mode {cost_mode!r}; expected one of {sorted(COST_MODES)}"
        )
    if optimizer not in ("pso", "glir"):
        raise ValueError(f"unknown optimizer {optimizer!r}; expected 'pso' | 'glir'")
    if optimizer == "glir" and cost_mode == "rollout":
        raise ValueError(
            "optimizer='glir' runs through the per-solve XLA cost modes only "
            "(the rollout kernel implements the deployed PSO update rule)"
        )
    snap_ax = None if shared_map else 0
    if cost_mode == "rollout":
        from ndtpso_slam.models.pso import PsoResult
        from ndtpso_slam.ops.pallas_rollout import (
            pack_rollout_inputs,
            pso_rollout,
        )

        nbrs = jax.vmap(
            lambda g, s, p, v: cost_mod.bind_neighborhood(
                g, s, p, v, map_cfg, radius=STENCIL_RADIUS
            ),
            in_axes=(0, snap_ax, 0, 0),
        )(guesses, snaps, points, valid)
        sten, pts = jax.vmap(pack_rollout_inputs)(nbrs, points)
        pose, cost = pso_rollout(
            keys, guesses, deviations, sten, pts, pso_cfg, map_cfg,
            radius=STENCIL_RADIUS, early_exit=early_exit,
        )
        return PsoResult(pose=pose.astype(guesses.dtype), cost=cost)
    return jax.vmap(
        lambda k, g, d, s, p, v: _solve_one(
            k, g, d, s, p, v, map_cfg, pso_cfg, cost_mode, optimizer
        ),
        in_axes=(0, 0, 0, snap_ax, 0, 0),
    )(keys, guesses, deviations, snaps, points, valid)


@partial(jax.jit, static_argnames=("map_cfg", "pso_cfg", "cost_mode", "optimizer",
                                   "early_exit"))
def solve_batch(
    keys: jnp.ndarray,  # [B, 2] uint32
    guesses: jnp.ndarray,  # [B, 3]
    deviations: jnp.ndarray,  # [B, 3]
    snaps: MapSnapshot,  # stacked [B, C, ...]
    points: jnp.ndarray,  # [B, N, 2]
    valid: jnp.ndarray,  # [B, N]
    map_cfg: MapConfig,
    pso_cfg: PSOConfig,
    cost_mode: str = "fast",
    optimizer: str = "pso",
    early_exit: int = 0,
):
    """B independent scan-match solves.

    ``cost_mode='rollout'`` runs every solve through the whole-solve kernel
    (ops/pallas_rollout.py), one program per solve; ``early_exit=K`` stops a
    solve whose global best stalled K iterations (rollout only).  The XLA
    cost modes are vmapped ``pso_solve`` calls.  ``optimizer='glir'`` swaps
    in the GLIR-PSO update rule (core.h:21-23).
    """
    return _solve_batch_impl(
        keys, guesses, deviations, snaps, points, valid, map_cfg, pso_cfg,
        cost_mode, optimizer=optimizer, early_exit=early_exit,
    )


def make_sharded_solver(
    mesh: Mesh,
    map_cfg: MapConfig,
    pso_cfg: PSOConfig,
    cost_mode: str = "fast",
    shared_map: bool = False,
    axes=SOLVE_AXIS,
    early_exit: int = 0,
):
    """Build a jitted sharded solve-batch function over the mesh's solve axes.

    The returned function has signature
    ``(keys, guesses, deviations, snaps, points, valid) -> PsoResult`` with
    every per-solve array sharded over ``axes`` — the flat
    :data:`SOLVE_AXIS` by default, or a tuple like ``('hosts', 'cards')``
    for the hierarchical hosts x cards mesh (parallel/runtime.py).  With
    ``shared_map=True`` all solves read one replicated map snapshot
    (multi-robot against a common map); otherwise each solve carries its own
    stacked snapshot, sharded with the batch.  Build it ONCE and reuse: each
    call of a freshly-built solver recompiles.
    """
    snap_spec = (
        MapSnapshot(mean=P(), inv_cov=P(), built=P())
        if shared_map
        else MapSnapshot(mean=P(axes), inv_cov=P(axes), built=P(axes))
    )

    def local(keys, guesses, deviations, snaps, points, valid):
        return _solve_batch_impl(
            keys, guesses, deviations, snaps, points, valid,
            map_cfg, pso_cfg, cost_mode, shared_map=shared_map,
            early_exit=early_exit,
        )

    shmapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axes),
            P(axes),
            P(axes),
            snap_spec,
            P(axes),
            P(axes),
        ),
        out_specs=P(axes),
        # pallas_call outputs don't carry varying-across-mesh annotations;
        # solves are embarrassingly parallel so the vma check adds nothing.
        check_vma=False,
    )
    return jax.jit(shmapped)


def solve_batch_sharded(
    mesh: Mesh,
    keys,
    guesses,
    deviations,
    snaps: MapSnapshot,
    points,
    valid,
    map_cfg: MapConfig,
    pso_cfg: PSOConfig,
    cost_mode: str = "fast",
    shared_map: bool = False,
):
    """One-shot convenience wrapper around :func:`make_sharded_solver`."""
    solver = make_sharded_solver(
        mesh, map_cfg, pso_cfg, cost_mode=cost_mode, shared_map=shared_map
    )
    return solver(keys, guesses, deviations, snaps, points, valid)
