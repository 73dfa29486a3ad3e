"""Multi-swarm PSO with cross-swarm (and cross-device) global-best exchange.

The reference's only "collective" is the `omp critical` global-best merge
inside one swarm (`core.cpp:97-104`).  The generalization here
(BASELINE config 4: 16 swarms x 4096 particles for relocalization against a
global map) runs K swarms with a leading vmap axis and periodically merges
their global bests: an argmin over the swarm axis locally, plus an
`all_gather` over the mesh axis when swarms are sharded across devices —
the device-collective replacement for both the OMP reduction and ROS
pub/sub.

Between exchanges each swarm explores independently around its own best
(island-model PSO); ``exchange_every=1`` makes all swarms chase one best,
``exchange_every>=iterations`` makes them fully independent with a single
final merge.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ndtpso_slam.config import MapConfig, PSOConfig, ZERO_DEVIATION
from ndtpso_slam.models import cost as cost_mod
from ndtpso_slam.models.pso import CostFn, PsoResult, _select_min
from ndtpso_slam.ops import rng


def _global_merge(gbest, gbest_cost, axis_name):
    """Best (pose, cost) across the swarm axis [K] and optionally one or
    more mesh axes (pass a tuple to merge over several, e.g.
    ``('hosts', 'cards')``). Returns broadcastable [3], [].

    Uses the gather-free one-hot reduction (`models/pso.py:_select_min`)
    rather than ``argmin`` + indexing.
    """
    best_cost, best_pose = _select_min(gbest_cost, gbest)
    if axis_name is not None:
        all_costs = jax.lax.all_gather(best_cost, axis_name, tiled=False)  # [D]
        all_poses = jax.lax.all_gather(best_pose, axis_name, tiled=False)  # [D, 3]
        if all_costs.ndim > 1:  # tuple axis names gather one dim per axis
            all_costs = all_costs.reshape(-1)
            all_poses = all_poses.reshape(-1, all_poses.shape[-1])
        best_cost, best_pose = _select_min(all_costs, all_poses)
    return best_pose, best_cost


def multi_swarm_solve(
    keys: jnp.ndarray,  # [K, 2] uint32, one key per swarm
    guesses: jnp.ndarray,  # [K, 3] per-swarm initial guesses (hypotheses)
    deviation: jnp.ndarray,  # [3] shared search radius
    cost_fn: CostFn,
    cfg: PSOConfig,
    exchange_every: int = 1,
    axis_name: Optional[str] = None,
    host_axis_name: Optional[str] = None,
    host_exchange_every: Optional[int] = None,
) -> PsoResult:
    """K-swarm PSO against one shared cost (map). Returns the single best.

    Inside `shard_map`, pass ``axis_name`` to merge across devices too.

    Hierarchical (multi-host) exchange: with ``host_axis_name`` set, the
    every-``exchange_every`` merge stays within a host (swarm axis +
    ``axis_name``) and only every ``host_exchange_every`` iterations does
    the merge additionally cross hosts over ``host_axis_name`` — so the
    expensive cross-host collective runs at a fraction of the in-host
    exchange rate.  The final merge always covers every axis, so the
    returned best is globally exact regardless of cadence.
    """
    dtype = guesses.dtype
    k, p = guesses.shape[0], cfg.population
    zero_dev = jnp.asarray(ZERO_DEVIATION, dtype)
    deviation = jnp.asarray(deviation, dtype)

    g_ctr, p_ctr = rng.pso_init_pairs(p)
    u_g = jax.vmap(lambda key: rng.uniform_pairs((key[0], key[1]), g_ctr, dtype)[0])(keys)
    g_pos = guesses + (2.0 * u_g - 1.0) * zero_dev  # [K, 3]
    u_p = jax.vmap(lambda key: rng.uniform_pairs((key[0], key[1]), p_ctr, dtype)[0])(keys)
    pos = guesses[:, None, :] + (2.0 * u_p - 1.0) * deviation  # [K, P, 3]

    # Each swarm binds the frozen-correspondence cost at its OWN incumbent:
    # swarms explore different basins (relocalization hypotheses), and a
    # quadratic re-linearized around another swarm's pose scores garbage
    # outside its trust region.  The exact cost ignores the bind argument.
    per_swarm_cost = jax.vmap(cost_fn)  # poses [K,P,3], binds [K,3] -> [K,P]
    g_cost = per_swarm_cost(g_pos[:, None, :], guesses)[:, 0]  # [K]
    cost = per_swarm_cost(pos, guesses)  # [K, P]
    binit, bpos = _select_min(cost, pos)  # [K], [K, 3]
    improved = binit < g_cost
    gbest = jnp.where(improved[:, None], bpos, g_pos)
    gbest_cost = jnp.where(improved, binit, g_cost)

    c1 = jnp.asarray(cfg.c1, dtype)
    c2 = jnp.asarray(cfg.c2, dtype)

    if host_axis_name is not None:
        card_axes = axis_name
        base = (
            tuple(axis_name)
            if isinstance(axis_name, (tuple, list))
            else (() if axis_name is None else (axis_name,))
        )
        all_axes: Optional[Tuple[str, ...]] = base + (host_axis_name,)
        host_every = host_exchange_every or exchange_every
    else:
        card_axes = axis_name
        all_axes = axis_name
        host_every = None

    def body(i, carry):
        pos, vel, pbest, pbest_cost, gbest, gbest_cost, w = carry
        r = jax.vmap(
            lambda key: rng.uniform_pairs((key[0], key[1]), rng.pso_iter_pairs(i, p), dtype)
        )(keys)
        r1, r2 = r  # [K, P, 3] each
        vel = (
            w * vel
            + c1 * r1 * (pbest - pos)
            + c2 * r2 * (gbest[:, None, :] - pos)
        )
        pos = pos + vel
        cost = per_swarm_cost(pos, gbest)  # bind at each swarm's own best
        better = cost < pbest_cost
        pbest = jnp.where(better[..., None], pos, pbest)
        pbest_cost = jnp.where(better, cost, pbest_cost)
        bc, bp = _select_min(pbest_cost, pbest)  # [K], [K, 3]
        gimp = bc < gbest_cost
        gbest = jnp.where(gimp[:, None], bp, gbest)
        gbest_cost = jnp.where(gimp, bc, gbest_cost)

        def exchange_over(axes):
            def exchange(args):
                gbest, gbest_cost = args
                best_pose, best_cost = _global_merge(gbest, gbest_cost, axes)
                # Every swarm adopts the merged best as its own gbest
                # (island merge); pbest memories stay local for diversity.
                return (
                    jnp.broadcast_to(best_pose, gbest.shape),
                    jnp.broadcast_to(best_cost, gbest_cost.shape),
                )

            return exchange

        if host_every is not None:
            # Two-tier cadence: the host-crossing merge subsumes the in-host
            # one, so on a host iteration only the full merge runs.
            host_turn = (i + 1) % host_every == 0
            gbest, gbest_cost = jax.lax.cond(
                host_turn,
                exchange_over(all_axes),
                lambda args: jax.lax.cond(
                    (i + 1) % exchange_every == 0,
                    exchange_over(card_axes),
                    lambda a: a,
                    args,
                ),
                (gbest, gbest_cost),
            )
        else:
            gbest, gbest_cost = jax.lax.cond(
                (i + 1) % exchange_every == 0,
                exchange_over(card_axes),
                lambda args: args,
                (gbest, gbest_cost),
            )
        w = w * jnp.asarray(cfg.w_damping, dtype)
        return pos, vel, pbest, pbest_cost, gbest, gbest_cost, w

    init = (
        pos,
        jnp.zeros_like(pos),
        pos,
        cost,
        gbest,
        gbest_cost,
        jnp.asarray(cfg.w, dtype),
    )
    *_, gbest, gbest_cost, _ = jax.lax.fori_loop(0, cfg.iterations, body, init)
    best_pose, best_cost = _global_merge(gbest, gbest_cost, all_axes)
    return PsoResult(pose=best_pose, cost=best_cost)


def multi_swarm_rollout(
    keys: jnp.ndarray,  # [K, 2] uint32, one key per swarm
    guesses: jnp.ndarray,  # [K, 3] per-swarm hypotheses
    deviation: jnp.ndarray,  # [3] shared search radius
    snap,  # MapSnapshot of the shared global map
    points: jnp.ndarray,  # [N, 2] query scan
    valid: jnp.ndarray,  # [N] bool
    cfg: PSOConfig,
    map_cfg: MapConfig,
    axis_name: Optional[str] = None,
    early_exit: int = 0,
) -> PsoResult:
    """Island-model multi-swarm through the whole-solve rollout kernel.

    `multi_swarm_solve` runs the K-swarm loop in XLA with a periodic
    cross-swarm global-best exchange; this variant instead runs the K swarms
    as one B=K batch of the whole-solve rollout kernel
    (ops/pallas_rollout.py) — every swarm's entire PSO loop runs in one
    program — and merges ONCE at the end.  For
    relocalization (BASELINE config 4: spread hypotheses against one global
    map) the islands-with-final-merge topology is exactly what you want:
    exchange would pull every swarm into the current best basin, which is a
    diversity loss, not a gain (cf. models/slam.py:_relocalize, which keeps
    all hypotheses alive to the exact stage for the same reason).

    Each swarm binds its stencil at its OWN hypothesis (the per-swarm
    analogue of the frozen-correspondence binding in `multi_swarm_solve`),
    so per-swarm rollout costs are not mutually comparable; the final merge
    therefore re-scores every swarm's winning pose with the exact gather
    cost (K poses, one gather — negligible) and picks on the true NDT
    objective.  Inside `shard_map`, pass ``axis_name`` to merge across
    devices too.  Returns the single best (pose [3], exact cost []).
    """
    k = guesses.shape[0]
    radius = cost_mod.DEFAULT_STENCIL_RADIUS
    orig_dtype = guesses.dtype
    guesses = guesses.astype(jnp.float32)
    nbr = jax.vmap(
        lambda g: cost_mod.bind_neighborhood(
            g, snap, points, valid, map_cfg, radius=radius
        )
    )(guesses)
    from ndtpso_slam.ops.pallas_rollout import (
        pack_rollout_inputs, pso_rollout,
    )

    sten, pts = jax.vmap(lambda n: pack_rollout_inputs(n, points))(nbr)
    devs = jnp.broadcast_to(jnp.asarray(deviation, jnp.float32), (k, 3))
    poses, _ = pso_rollout(
        keys, guesses, devs, sten, pts, cfg, map_cfg,
        radius=radius, early_exit=early_exit,
    )
    exact = cost_mod.ndt_cost(poses, snap, points, valid, map_cfg)  # [K]
    best_cost, best_pose = _select_min(exact, poses)
    if axis_name is not None:
        all_costs = jax.lax.all_gather(best_cost, axis_name, tiled=False)
        all_poses = jax.lax.all_gather(best_pose, axis_name, tiled=False)
        best_cost, best_pose = _select_min(all_costs, all_poses)
    # Preserve the caller's dtype (as multi_swarm_solve does) so switching
    # between the two multi-swarm paths never silently changes precision.
    return PsoResult(
        pose=best_pose.astype(orig_dtype), cost=best_cost.astype(orig_dtype)
    )
