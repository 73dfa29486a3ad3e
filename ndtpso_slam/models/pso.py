"""Particle-swarm SE(2) pose optimization, fully batched.

Batched counterpart of `pso_optimization` (`core.cpp:50-116`).  The
reference parallelizes particles with an OpenMP ``parallel for`` and merges the
global best in an ``omp critical`` section (`core.cpp:81-104`); here the
population is a dense ``[P, 3]`` array, the per-iteration loop is a
``lax.fori_loop``, and the global-best merge is an ``argmin`` reduction — the
deterministic, race-free equivalent of the critical section.

One deliberate, documented semantic change: the reference updates the global
best *inside* the particle loop, so (depending on OMP scheduling) later
particles in the same iteration may chase a mid-iteration best.  The batched
rule is synchronous: every particle sees the global best from the end of the
previous iteration.  Both are standard PSO variants; the C++ golden reference
in ``native/golden`` implements the synchronous rule with the same Threefry
stream, so parity against it is tight rather than statistical.

Randomness follows the frozen protocol in :mod:`ndtpso_slam.ops.rng`
(draw shapes and order match `core.cpp:14,84`: one U(0,1)² pair per particle
per dimension per iteration, 3 + P·3 single draws at init).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ndtpso_slam.config import PSOConfig, ZERO_DEVIATION
from ndtpso_slam.ops import rng

# cost_fn(poses [P,3], bind_pose [3]) -> costs [P].  The bind pose (current
# global best) only matters for the frozen-correspondence fast cost; the exact
# cost ignores it.
CostFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


class PsoResult(NamedTuple):
    pose: jnp.ndarray  # [3] best pose found
    cost: jnp.ndarray  # [] its cost (under the final binding)


def _select_min(cost: jnp.ndarray, pos: jnp.ndarray):
    """(min cost, pos row at the first argmin) along the last/particle axis,
    with no dynamic gathers.

    ``argmin`` + ``take_along_axis`` lower to data-dependent gathers; the
    one-hot select here is pure elementwise compare/reduce work and bit-identical
    (first-minimal-index tie-break, value selected exactly — the masked sum
    adds only zeros to it).

    cost: [..., P]; pos: [..., P, K].  Returns ([...], [..., K]).
    """
    p = cost.shape[-1]
    iota = jnp.arange(p, dtype=jnp.int32)
    m = jnp.min(cost, axis=-1, keepdims=True)
    first = jnp.min(jnp.where(cost == m, iota, p), axis=-1, keepdims=True)
    onehot = (iota == first).astype(pos.dtype)
    return m[..., 0], jnp.sum(onehot[..., None] * pos, axis=-2)


def pso_solve(
    key: Tuple[jnp.ndarray, jnp.ndarray],
    guess: jnp.ndarray,
    deviation: jnp.ndarray,
    cost_fn: CostFn,
    cfg: PSOConfig,
) -> PsoResult:
    """Run one PSO scan-match solve.

    Args:
      key: (k0, k1) uint32 Threefry key words for this solve.
      guess: [3] initial pose (x, y, theta).
      deviation: [3] uniform init radius per dimension (`Particle` ctor,
        `core.cpp:13-23`).
      cost_fn: batched cost.
      cfg: swarm hyper-parameters.
    """
    dtype = guess.dtype
    p = cfg.population
    zero_dev = jnp.asarray(ZERO_DEVIATION, dtype)

    # Global-best seed: the guess jittered by a near-zero deviation
    # (`core.cpp:53-58`).
    g_ctr, p_ctr = rng.pso_init_pairs(p)
    u_g, _ = rng.uniform_pairs(key, g_ctr, dtype)
    g_pos = guess + (2.0 * u_g - 1.0) * zero_dev
    g_cost = cost_fn(g_pos[None, :], guess)[0]

    # Population init: uniform in guess ± deviation (`core.cpp:60-69`).
    u_p, _ = rng.uniform_pairs(key, p_ctr, dtype)
    pos = guess + (2.0 * u_p - 1.0) * jnp.asarray(deviation, dtype)
    cost = cost_fn(pos, guess)
    bc, bp = _select_min(cost, pos)
    improved = bc < g_cost
    gbest = jnp.where(improved, bp, g_pos)
    gbest_cost = jnp.where(improved, bc, g_cost)

    c1 = jnp.asarray(cfg.c1, dtype)
    c2 = jnp.asarray(cfg.c2, dtype)

    def body(i, carry):
        pos, vel, pbest, pbest_cost, gbest, gbest_cost, w = carry
        r1, r2 = rng.uniform_pairs(key, rng.pso_iter_pairs(i, p), dtype)
        # Velocity/position update (`core.cpp:84-89`).
        vel = w * vel + c1 * r1 * (pbest - pos) + c2 * r2 * (gbest - pos)
        pos = pos + vel
        cost = cost_fn(pos, gbest)
        # pbest then gbest reductions (`core.cpp:94-105`).
        better = cost < pbest_cost
        pbest = jnp.where(better[:, None], pos, pbest)
        pbest_cost = jnp.where(better, cost, pbest_cost)
        bc, bp = _select_min(pbest_cost, pbest)
        gimp = bc < gbest_cost
        gbest = jnp.where(gimp, bp, gbest)
        gbest_cost = jnp.where(gimp, bc, gbest_cost)
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
    return PsoResult(pose=gbest, cost=gbest_cost)


def glir_pso_solve(
    key: Tuple[jnp.ndarray, jnp.ndarray],
    guess: jnp.ndarray,
    deviation: jnp.ndarray,
    cost_fn: CostFn,
    cfg: PSOConfig,
) -> PsoResult:
    """Batched GLIR-PSO (adaptive inertia / coefficients) alternative solver.

    The reference ships an explicitly UNTESTED serial GLIR-PSO
    (`core.cpp:118-186`) whose adaptive inertia divides a running pbest sum by
    the *particle index* (`core.cpp:146`) — a latent bug in dead code.  This
    slot keeps the interface and the GLIR idea (inertia and coefficients
    adapted from the gbest/pbest cost ratios, ratio-weighted attractors,
    `core.cpp:146-153`) with the running average taken over *iterations*, and
    the same synchronous batched update rule as :func:`pso_solve`.

    One more documented divergence: the swarm runs in GUESS-RELATIVE
    coordinates.  The upstream per-dimension ratio attractor
    (`ratio·pbest`, `core.cpp:150-152`) is gauge-dependent — in world
    coordinates its multiplicative noise scales with |pose|, so a robot
    15 m from the origin gets metre-scale attractor bias and the SLAM loop
    measurably diverges (~5 m by scan 2 on the session fixture); evaluated
    relative to the guess (the solve's natural gauge, identical when
    guess = 0) the same heuristic tracks.  Draw streams and the update
    rule are unchanged.
    """
    dtype = guess.dtype
    p = cfg.population
    zero_dev = jnp.asarray(ZERO_DEVIATION, dtype)
    shift = guess
    rel_cost = lambda poses, bind: cost_fn(poses + shift, bind + shift)
    zero3 = jnp.zeros_like(guess)

    g_ctr, p_ctr = rng.pso_init_pairs(p)
    u_g, _ = rng.uniform_pairs(key, g_ctr, dtype)
    g_pos = (2.0 * u_g - 1.0) * zero_dev
    g_cost = rel_cost(g_pos[None, :], zero3)[0]

    u_p, _ = rng.uniform_pairs(key, p_ctr, dtype)
    pos = (2.0 * u_p - 1.0) * jnp.asarray(deviation, dtype)
    cost = rel_cost(pos, zero3)
    bc, bp = _select_min(cost, pos)
    improved = bc < g_cost
    gbest = jnp.where(improved, bp, g_pos)
    gbest_cost = jnp.where(improved, bc, g_cost)

    eps = jnp.asarray(1e-12, dtype)

    def body(i, carry):
        pos, vel, pbest, pbest_cost, pbest_sum, gbest, gbest_cost = carry
        r1, r2 = rng.uniform_pairs(key, rng.pso_iter_pairs(i, p), dtype)
        it = (i + 1).astype(dtype)
        pbest_avg = pbest_sum / it
        omega = 1.1 - gbest_cost / jnp.where(
            jnp.abs(pbest_avg) > eps, pbest_avg, eps
        )  # [P]
        cc = 1.0 + gbest_cost / jnp.where(
            jnp.abs(pbest_cost) > eps, pbest_cost, eps
        )  # c1 == c2, `core.cpp:147`
        ratio = pbest / jnp.where(jnp.abs(gbest) > eps, gbest, eps)  # [P,3]
        inv_ratio = jnp.where(jnp.abs(ratio) > eps, 1.0 / ratio, 0.0)
        vel = (
            omega[:, None] * vel
            + cc[:, None] * r1 * (ratio * pbest - pos)
            + cc[:, None] * r2 * (inv_ratio * gbest - pos)
        )
        pos = pos + vel
        cost = rel_cost(pos, gbest)
        better = cost < pbest_cost
        pbest = jnp.where(better[:, None], pos, pbest)
        pbest_cost = jnp.where(better, cost, pbest_cost)
        pbest_sum = pbest_sum + pbest_cost
        bc, bp = _select_min(pbest_cost, pbest)
        gimp = bc < gbest_cost
        gbest = jnp.where(gimp, bp, gbest)
        gbest_cost = jnp.where(gimp, bc, gbest_cost)
        return pos, vel, pbest, pbest_cost, pbest_sum, gbest, gbest_cost

    init = (pos, jnp.zeros_like(pos), pos, cost, cost, gbest, gbest_cost)
    *_, gbest, gbest_cost = jax.lax.fori_loop(0, cfg.iterations, body, init)
    return PsoResult(pose=gbest + shift, cost=gbest_cost)


def pso_solve_batch(
    keys: jnp.ndarray,  # [B, 2] uint32, one key per solve
    guesses: jnp.ndarray,  # [B, 3]
    deviations: jnp.ndarray,  # [B, 3]
    cost_fn,  # (poses [B, P, 3], binds [B, 3]) -> [B, P]
    cfg: PSOConfig,
) -> PsoResult:
    """B independent solves with an explicit batch axis.

    Semantically identical to ``vmap(pso_solve)`` (same per-solve Threefry
    streams, same update rule) but the cost callback sees the whole
    ``[B, P, 3]`` pose block at once, so a batched cost can see every
    solve's particles in one call instead of being vmapped per solve.
    Returns a
    :class:`PsoResult` with leading batch axis B.
    """
    dtype = guesses.dtype
    b, _ = guesses.shape
    p = cfg.population
    zero_dev = jnp.asarray(ZERO_DEVIATION, dtype)

    g_ctr, p_ctr = rng.pso_init_pairs(p)
    u_g = jax.vmap(lambda k: rng.uniform_pairs((k[0], k[1]), g_ctr, dtype)[0])(keys)
    g_pos = guesses + (2.0 * u_g - 1.0) * zero_dev  # [B, 3]
    g_cost = cost_fn(g_pos[:, None, :], guesses)[:, 0]  # [B]

    u_p = jax.vmap(lambda k: rng.uniform_pairs((k[0], k[1]), p_ctr, dtype)[0])(keys)
    pos = guesses[:, None, :] + (2.0 * u_p - 1.0) * deviations[:, None, :]
    cost = cost_fn(pos, guesses)  # [B, P]
    bc, bp = _select_min(cost, pos)
    improved = bc < g_cost
    gbest = jnp.where(improved[:, None], bp, g_pos)
    gbest_cost = jnp.where(improved, bc, g_cost)

    c1 = jnp.asarray(cfg.c1, dtype)
    c2 = jnp.asarray(cfg.c2, dtype)

    def body(i, carry):
        pos, vel, pbest, pbest_cost, gbest, gbest_cost, w = carry
        r1, r2 = jax.vmap(
            lambda k: rng.uniform_pairs((k[0], k[1]), rng.pso_iter_pairs(i, p), dtype)
        )(keys)
        vel = (
            w * vel
            + c1 * r1 * (pbest - pos)
            + c2 * r2 * (gbest[:, None, :] - pos)
        )
        pos = pos + vel
        cost = cost_fn(pos, gbest)
        better = cost < pbest_cost
        pbest = jnp.where(better[..., None], pos, pbest)
        pbest_cost = jnp.where(better, cost, pbest_cost)
        bc, bp = _select_min(pbest_cost, pbest)
        gimp = bc < gbest_cost
        gbest = jnp.where(gimp[:, None], bp, gbest)
        gbest_cost = jnp.where(gimp, bc, gbest_cost)
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
    return PsoResult(pose=gbest, cost=gbest_cost)
