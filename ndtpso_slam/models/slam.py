"""The scan-synchronous SLAM pipeline: align -> update -> build (-> raster).

Functional counterpart of the per-scan callback `NDTPSONode::scan_matcher_`
(`ndtpso_slam_node.cpp:177-244`) plus `NDTFrame::align`
(`ndtframe.cpp:251-266`):

* the adaptive particle deviation — twice the last inter-scan motion after the
  two cold-start scans (`ndtframe.cpp:253`);
* the first-scan special case — no align, pose := previous pose
  (`ndtpso_slam_node.cpp:188-195`);
* map update with the aligned pose every scan (`ndtpso_slam_node.cpp:198`);
* the reference's *lazy* map build (triggered inside the next solve's cost
  call, `core.cpp:27-28`, racy under OpenMP) becomes an *explicit* build phase
  right after the update — the state seen by the next align is identical, the
  order is deterministic.

`slam_step` is one jittable function; a whole recorded scan log runs as a
`lax.scan` over it (`run_offline`), which is the `scan.launch` workload as a
single XLA program.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from ndtpso_slam.utils.pytree import PyTreeNode

from ndtpso_slam.config import SlamConfig
from ndtpso_slam.models import cost as cost_mod
from ndtpso_slam.models import ndt_map, occupancy
from ndtpso_slam.models.pso import PsoResult, pso_solve
from ndtpso_slam.models.scan import Scan
from ndtpso_slam.ops import rng


class AlignState(PyTreeNode):
    """Per-map alignment bookkeeping (`NDTFrame` members s_iter, s_pose_diff,
    s_prev_pose)."""

    prev_pose: jnp.ndarray  # [3]
    pose_diff: jnp.ndarray  # [3]
    iter: jnp.ndarray  # [] int32


class SlamState(PyTreeNode):
    map: ndt_map.NdtMapState
    align: AlignState
    og: Optional[occupancy.OccupancyGrid]
    pose: jnp.ndarray  # [3] current estimate
    step: jnp.ndarray  # [] int32
    # Match fitness of the last scan: mean exact NDT score per valid beam,
    # in [0, 1].  Drives tracking-loss detection (cfg.recovery).
    fitness: jnp.ndarray  # [] dtype
    recoveries: jnp.ndarray  # [] int32 cumulative accepted relocalizations
    # Cell ids touched by the previous scan (sentinel num_cells elsewhere).
    # A build that rotates a cell's ring must be followed by a rebuild of
    # that cell (stale-slot eviction, see ndt_map.build_touched); rotation
    # only fires on touched builds, so last scan's ids cover it.
    prev_ids: jnp.ndarray  # [N] int32


def init_slam(cfg: SlamConfig, initial_pose=(0.0, 0.0, 0.0)) -> SlamState:
    dtype = cfg.dtype
    pose = jnp.asarray(initial_pose, dtype)
    return SlamState(
        map=ndt_map.init_map(cfg.map, dtype),
        align=AlignState(
            prev_pose=pose, pose_diff=jnp.zeros(3, dtype), iter=jnp.asarray(0, jnp.int32)
        ),
        og=occupancy.init_og(cfg.map, cfg.og) if cfg.og.enabled else None,
        pose=pose,
        step=jnp.asarray(0, jnp.int32),
        fitness=jnp.asarray(0.0, dtype),
        recoveries=jnp.asarray(0, jnp.int32),
        prev_ids=jnp.full((cfg.scan.max_beams,), cfg.map.num_cells, jnp.int32),
    )


SLAM_COST_MODES = ("exact", "fast", "fast_local", "local_exact", "rollout")


def make_cost_fn(
    snap: ndt_map.MapSnapshot, scan: Scan, cfg: SlamConfig, guess=None
):
    """Batched cost closure for the solver, per the configured cost mode."""
    if cfg.cost_mode == "exact":
        return lambda poses, bind: cost_mod.ndt_cost(
            poses, snap, scan.points, scan.valid, cfg.map
        )
    if cfg.cost_mode == "fast":
        return lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points(bind, snap, scan.points, scan.valid, cfg.map)
        )
    if cfg.cost_mode == "fast_local":
        # Gather-free hot loop: pre-gather each point's cell stencil once at
        # the initial guess, rebind per iteration by offset arithmetic
        # (models/cost.py:bind_points_local).  Valid while the swarm stays
        # within ±radius cells of the guess — the scan-to-scan regime.
        nbr = cost_mod.bind_neighborhood(
            guess, snap, scan.points, scan.valid, cfg.map,
            radius=cost_mod.DEFAULT_STENCIL_RADIUS,
        )
        return lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points_local(bind, nbr, scan.points, cfg.map)
        )
    if cfg.cost_mode == "local_exact":
        # Per-particle stencil rebind: exact correspondences, zero gathers in
        # the loop — the accurate choice at the reference's 0.5 m cell side,
        # where frozen-at-incumbent bindings lose tracking (cost.py:
        # stencil_exact_cost).
        nbr = cost_mod.bind_neighborhood(
            guess, snap, scan.points, scan.valid, cfg.map,
            radius=cost_mod.DEFAULT_STENCIL_RADIUS,
        )
        return lambda poses, bind: cost_mod.stencil_exact_cost(
            poses, nbr, scan.points, cfg.map
        )
    raise ValueError(
        f"unknown cost_mode: {cfg.cost_mode}; expected one of {SLAM_COST_MODES}"
    )


def _align_rollout(key, guess, deviation, snap, scan, cfg: SlamConfig) -> PsoResult:
    """One B=1 solve through the whole-solve rollout kernel
    (ops/pallas_rollout.py): frozen-at-gbest stencil binding, the same cost
    as `fast_local`."""
    from ndtpso_slam.ops.pallas_rollout import (
        pack_rollout_inputs,
        pso_rollout,
    )

    nbr = cost_mod.bind_neighborhood(
        guess, snap, scan.points, scan.valid, cfg.map,
        radius=cost_mod.DEFAULT_STENCIL_RADIUS,
    )
    keys = jnp.stack(
        [jnp.asarray(key[0], jnp.uint32), jnp.asarray(key[1], jnp.uint32)]
    )[None]
    sten, pts = pack_rollout_inputs(nbr, scan.points)
    pose, c = pso_rollout(
        keys, guess[None].astype(jnp.float32),
        jnp.asarray(deviation, jnp.float32)[None],
        sten[None], pts[None], cfg.pso, cfg.map,
        radius=cost_mod.DEFAULT_STENCIL_RADIUS,
        early_exit=cfg.solver_early_exit,
    )
    return PsoResult(pose=pose[0].astype(guess.dtype), cost=c[0])


def align(
    key,
    astate: AlignState,
    snap: ndt_map.MapSnapshot,
    scan: Scan,
    guess: jnp.ndarray,
    cfg: SlamConfig,
) -> Tuple[AlignState, PsoResult]:
    """`NDTFrame::align` (`ndtframe.cpp:251-266`): adaptive deviation + PSO."""
    dtype = guess.dtype
    first_dev = jnp.asarray(cfg.first_deviation, dtype)
    adaptive = jnp.abs(astate.pose_diff * jnp.asarray(cfg.deviation_scale, dtype))
    deviation = jnp.where(astate.iter < 2, first_dev, adaptive)
    if cfg.cost_mode == "rollout":
        if cfg.optimizer != "pso":
            raise ValueError(
                "the rollout cost mode implements the deployed PSO update rule "
                f"only; optimizer={cfg.optimizer!r} needs an XLA cost mode"
            )
        result = _align_rollout(key, guess, deviation, snap, scan, cfg)
    else:
        if cfg.optimizer == "pso":
            solver = pso_solve
        elif cfg.optimizer == "glir":
            from ndtpso_slam.models.pso import glir_pso_solve as solver
        else:
            raise ValueError(
                f"unknown optimizer {cfg.optimizer!r}; expected 'pso' | 'glir'"
            )
        result = solver(
            key, guess, deviation, make_cost_fn(snap, scan, cfg, guess), cfg.pso
        )
    if cfg.cost_mode != "exact":
        # Fast modes report the cost under the final frozen binding; re-score
        # the winning pose with the exact gather cost (one pose, one gather —
        # negligible) so the per-scan cost is always the true NDT objective.
        exact = cost_mod.ndt_cost(
            result.pose[None, :], snap, scan.points, scan.valid, cfg.map
        )[0]
        result = PsoResult(pose=result.pose, cost=exact)
    new_astate = AlignState(
        prev_pose=result.pose,
        pose_diff=result.pose - astate.prev_pose,
        iter=astate.iter + 1,
    )
    return new_astate, result


def _reloc_grid(last_pose, rc, dtype) -> jnp.ndarray:
    """Dense pose grid over ±spread around the last trusted pose, [G, 3]."""
    nx, ny, nt = rc.grid
    sx, sy, st = rc.spread
    lin = lambda n, s: jnp.linspace(-s, s, n, dtype=dtype)
    gx, gy, gt = jnp.meshgrid(lin(nx, sx), lin(ny, sy), lin(nt, st),
                              indexing="ij")
    return last_pose + jnp.stack(
        [gx.reshape(-1), gy.reshape(-1), gt.reshape(-1)], axis=-1
    )


def _nms_top_k(grid, costs, k, radius):
    """Greedy non-max-suppressed top-K over the pose grid.

    Plain top-K clusters all K picks inside the single best-scoring basin
    (often a rotation-symmetric false match); suppressing a ±radius
    neighborhood around each pick forces the hypotheses to be K *distinct*
    basins.  Returns [K, 3] poses, best first."""
    two_pi = jnp.asarray(2.0 * jnp.pi, grid.dtype)

    def body(costs, _):
        from ndtpso_slam.models.pso import _select_min

        _, bp = _select_min(costs, grid)
        d = jnp.abs(grid - bp)
        dth = jnp.minimum(d[:, 2], two_pi - d[:, 2])
        near = (d[:, 0] <= radius[0]) & (d[:, 1] <= radius[1]) & (dth <= radius[2])
        return jnp.where(near, jnp.inf, costs), bp

    _, hyps = jax.lax.scan(body, costs, None, length=k)
    return hyps


def _relocalize(key, snap, scan, last_pose, failed_pose, cfg: SlamConfig):
    """Three-stage relocalization around the last trusted pose.

    Stage 1 brute-force scores a dense (nx·ny·nθ) pose grid — a massively
    batched eval is exactly what the chip is good at (chunked with `lax.map`
    to bound the [g, N] intermediate) — against a covariance-inflated
    snapshot: the map's Gaussians are centimetres thin across surfaces, so
    the exact basin is invisible to any feasible grid spacing
    (coarse-to-fine NDT).  Non-max suppression turns the score field into K
    *distinct* basin hypotheses (plus the last pose and the failed align, so
    recovery can never do worse than either).

    Stage 2 refines every hypothesis with an independent PSO swarm on a
    lightly inflated cost; stage 3 polishes each with the exact cost and
    picks the winner by exact cost — so rotation-symmetric false basins,
    which score well only when smoothed, lose to the true one.
    Returns (pose [3], exact cost [])."""
    from ndtpso_slam.models.pso import _select_min

    rc = cfg.recovery
    dtype = last_pose.dtype
    k = rc.k_hypotheses

    # --- stage 1: coarse grid sweep + NMS hypothesis extraction.
    grid = _reloc_grid(last_pose, rc, dtype)
    g = grid.shape[0]
    # Chunk cap bounds the [chunk, N] scoring intermediate (~12 MB at 8192
    # x 384); fewer, larger chunks = fewer serial lax.map steps.
    chunk = next(c for c in range(min(8192, g), 0, -1) if g % c == 0)
    coarse_snap = ndt_map.smooth_snapshot(snap, rc.grid_sigma)
    # Stage-1 beam subsampling (rc.grid_beam_stride): the sweep is gather-
    # row-bound (G x N rows); the inflated-cost basin ranking it produces
    # is insensitive to beam thinning, and every later stage uses all
    # beams.  Static stride keeps shapes compile-time.  0 = auto: thin to
    # stride 2 at deployment map sizes, stay exhaustive on small maps
    # (config.py:RecoveryConfig).
    from ndtpso_slam.config import RECOVERY_AUTO_STRIDE_MIN_CELLS

    stride = int(rc.grid_beam_stride)
    if stride <= 0:
        stride = 2 if cfg.map.num_cells >= RECOVERY_AUTO_STRIDE_MIN_CELLS else 1
    s_points = scan.points[::stride]
    s_valid = scan.valid[::stride]
    coarse = lambda poses: cost_mod.ndt_cost(
        poses, coarse_snap, s_points, s_valid, cfg.map
    )
    score = lambda poses: cost_mod.ndt_cost(
        poses, snap, scan.points, scan.valid, cfg.map
    )
    costs = jax.lax.map(coarse, grid.reshape(g // chunk, chunk, 3)).reshape(-1)
    nx, ny, nt = rc.grid
    sx, sy, st = rc.spread
    spacing = jnp.asarray(
        [2.0 * sx / max(nx - 1, 1), 2.0 * sy / max(ny - 1, 1),
         2.0 * st / max(nt - 1, 1)],
        dtype,
    )
    hypo = _nms_top_k(grid, costs, k, 1.5 * spacing)
    hypo = hypo.at[0].set(last_pose).at[1].set(failed_pose)

    # --- stage 2: per-hypothesis independent PSO on the lightly inflated
    # cost (fresh keys, decoupled from the solve's pair-counter space).
    # Cost formulation: the one-hot matmul binder rebound at each swarm's
    # incumbent best (cost_mod.bind_points_matmul + bound_cost) — the same
    # recipe as the multiswarm relocalization bench path; it is
    # bit-identical to the gather binding (ROADMAP S8 re-decides it against
    # a plain gather on the GPU).  (A stencil-exact formulation is NOT usable here: under the
    # ±π/±0.3 rad relocalization search, far points rotate metres away from
    # any anchor-gathered stencil.)  At deployment map sizes the binder
    # reads a rc.patch_cells² window around the last trusted pose instead
    # of the full [C] table — O(N·C) with C capped at the window, identical
    # selections inside it (cost.py:bind_points_matmul_window).
    from ndtpso_slam.ops.geometry import cell_coords

    w_cells = cfg.map.cells_per_side
    ps = rc.patch_cells if 0 < rc.patch_cells < w_cells else 0
    if ps:
        cx, cy, _ = cell_coords(
            last_pose[:2], size_m=cfg.map.size_m, cell_side_m=cfg.map.cell_side_m
        )
        ox = jnp.clip(cx - ps // 2, 0, w_cells - ps)
        oy = jnp.clip(cy - ps // 2, 0, w_cells - ps)

        def window(tbl):
            return jax.lax.dynamic_slice(
                tbl.reshape(w_cells, w_cells, 6), (oy, ox, 0), (ps, ps, 6)
            ).reshape(ps * ps, 6)

        def make_bind_fn(tbl):
            patch = window(tbl)
            return lambda bind: cost_mod.bind_points_matmul_window(
                bind, patch, (ox, oy), ps, scan.points, scan.valid, cfg.map
            )
    else:
        def make_bind_fn(tbl):
            return lambda bind: cost_mod.bind_points_matmul(
                bind, tbl, scan.points, scan.valid, cfg.map
            )

    rk = rng.threefry2x32(
        key, jnp.asarray(0x5EC0, jnp.uint32), jnp.asarray(0xFA11, jnp.uint32)
    )
    k0, k1 = rng.threefry2x32(
        rk, jnp.arange(k, dtype=jnp.uint32), jnp.full((k,), 0x5117, jnp.uint32)
    )
    refine_snap = (
        ndt_map.smooth_snapshot(snap, rc.refine_sigma)
        if rc.refine_sigma > 0 else snap
    )
    refine_bind = make_bind_fn(cost_mod.snapshot_table(refine_snap))
    dev = jnp.asarray(rc.deviation, dtype)
    refine_fn = lambda poses, bind: cost_mod.bound_cost(poses, refine_bind(bind))
    refined = jax.vmap(
        lambda kk, h: pso_solve((kk[0], kk[1]), h, dev, refine_fn, rc.pso).pose
    )(jnp.stack([k0, k1], -1), hypo)

    # --- stage 3: polish of every hypothesis on the un-inflated map (same
    # binder, exact table), then the winner picked by a true exact-cost
    # re-score of the K final poses (one batched gather eval — the accept
    # decision in slam_step compares against the align's exact cost, so the
    # winning number must stay the exact objective).  Collapsing to one
    # winner *before* the polish would let a smoothed false basin beat the
    # true one; keeping all K alive to here is what disambiguates them.
    p0, p1 = rng.threefry2x32(
        rk, jnp.arange(k, dtype=jnp.uint32) + jnp.asarray(0x907, jnp.uint32),
        jnp.full((k,), 0x13, jnp.uint32),
    )
    pdev = jnp.asarray((0.1, 0.1, 0.05), dtype)
    polish_bind = make_bind_fn(cost_mod.snapshot_table(snap))
    polish_fn = lambda poses, bind: cost_mod.bound_cost(poses, polish_bind(bind))
    polished = jax.vmap(
        lambda kk, h: pso_solve((kk[0], kk[1]), h, pdev, polish_fn, rc.pso).pose
    )(jnp.stack([p0, p1], -1), refined)
    final_costs = score(polished)
    best_cost, best_pose = _select_min(final_costs, polished)
    return best_pose.astype(dtype), best_cost.astype(dtype)


@partial(jax.jit, static_argnames=("cfg",))
def slam_step(
    state: SlamState, scan: Scan, key, cfg: SlamConfig
) -> Tuple[SlamState, jnp.ndarray, jnp.ndarray]:
    """One scan-synchronous SLAM step.  Returns (state', pose, cost)."""
    first = state.step == 0
    dtype = state.pose.dtype
    snap = ndt_map.snapshot(state.map, cfg.map)
    new_astate, result = align(key, state.align, snap, scan, state.pose, cfg)
    # First scan: keep the prior pose and do not advance align bookkeeping
    # (`ndtpso_slam_node.cpp:188-195`; align is still computed for shape
    # uniformity, its result is discarded).
    pose = jnp.where(first, state.pose, result.pose)
    astate = jax.tree_util.tree_map(
        lambda old, new: jnp.where(first, old, new), state.align, new_astate
    )
    # Match fitness: result.cost is the exact NDT objective (align re-scores
    # fast modes), -cost / n_valid is the mean per-beam score in [0, 1].
    n_valid = jnp.sum(scan.valid)
    cost = result.cost.astype(dtype)
    fitness = -cost / jnp.maximum(n_valid, 1).astype(dtype)
    ingest_valid = scan.valid
    recoveries = state.recoveries

    if cfg.recovery.enabled:
        rc = cfg.recovery
        # Sensor dropout: too few valid beams to match against — constant-
        # velocity dead reckoning, and do NOT pollute the map with the scan.
        degraded = (~first) & (n_valid < rc.min_valid_beams)
        dead_pose = state.pose + state.align.pose_diff
        # Tracking loss: healthy align budget spent but the exact score is
        # poor.  Only meaningful after the cold-start scans.
        lost = (
            (~first)
            & (~degraded)
            & (state.align.iter >= 2)
            & (fitness < jnp.asarray(rc.fitness_threshold, dtype))
        )

        def recover(_):
            rpose, rcost = _relocalize(key, snap, scan, state.pose, pose, cfg)
            # Accept bar: strictly better than the failed align AND inside
            # the SANE fitness band [accept_fitness, 1].  The floor rejects
            # merely-less-terrible poses (an unrecoverable kidnap outside
            # the search spread stays rejected and observable instead of
            # zeroing pose_diff / ingesting at a wrong pose); the ceiling
            # rejects the indefinite-inverse score blow-up (mean per-beam
            # score cannot legitimately exceed exp(0) = 1 — see
            # RecoveryConfig.accept_fitness).  NaN fails every comparison,
            # so pathological costs can never accept.
            rfit = -rcost / jnp.maximum(n_valid, 1).astype(dtype)
            accept = (
                (rcost < cost)
                & (rfit >= jnp.asarray(rc.accept_fitness, dtype))
                & (rfit <= jnp.asarray(1.0, dtype))
            )
            return (
                jnp.where(accept, rpose, pose),
                jnp.where(accept, rcost, cost),
                accept,
            )

        def no_recover(_):
            return pose, cost, jnp.asarray(False)

        pose_r, cost_r, accepted = jax.lax.cond(lost, recover, no_recover, None)
        pose = jnp.where(degraded, dead_pose, pose_r)
        cost = jnp.where(degraded, cost, cost_r)
        fitness = -cost / jnp.maximum(n_valid, 1).astype(dtype)
        # Align bookkeeping: a recovery jump is not robot motion (pose_diff
        # := 0 so the next deviation doesn't explode); a dead-reckoned step
        # keeps the previous velocity estimate.
        pose_diff = jnp.where(
            degraded,
            state.align.pose_diff,
            jnp.where(accepted, jnp.zeros_like(pose), astate.pose_diff),
        )
        astate = AlignState(
            prev_pose=jnp.where(first, astate.prev_pose, pose),
            pose_diff=jnp.where(first, astate.pose_diff, pose_diff),
            iter=astate.iter,
        )
        ingest_valid = scan.valid & ~degraded
        recoveries = recoveries + accepted.astype(jnp.int32)

    from ndtpso_slam.ops.geometry import cell_index, transform_points

    wpts = transform_points(scan.points, pose)
    idx, inb = cell_index(
        wpts, size_m=cfg.map.size_m, cell_side_m=cfg.map.cell_side_m,
        cells_per_side=cfg.map.cells_per_side,
    )
    ids = jnp.where(ingest_valid & inb, idx, cfg.map.num_cells)
    new_map = ndt_map.add_points(state.map, cfg.map, wpts, ingest_valid)
    # Sparse build: a scan can only change the cells it binned into (plus
    # last scan's cells, for post-rotation slot eviction), and slam_step
    # maintains the build-after-every-ingest invariant, so this is
    # bit-identical to the dense ndt_map.build (and O(N) rows instead of the
    # 6 full [C]-row ring-buffer passes at the reference's 360k-cell
    # default scale).
    new_map = ndt_map.build_touched(
        new_map, cfg.map, jnp.concatenate([ids, state.prev_ids])
    )
    og = state.og
    if og is not None:
        # Incremental raster: only parent cells touched by this scan can
        # have changed Gaussians, so refreshing their sub-blocks reproduces
        # the dense og_update exactly (see occupancy.og_update_incremental).
        og = occupancy.og_update_incremental(og, new_map, cfg.map, cfg.og, ids)
    new_state = SlamState(
        map=new_map, align=astate, og=og, pose=pose, step=state.step + 1,
        fitness=fitness, recoveries=recoveries, prev_ids=ids,
    )
    return new_state, pose, cost


@partial(jax.jit, static_argnames=("cfg",))
def run_offline(
    state: SlamState, scans: Scan, base_key, cfg: SlamConfig
) -> Tuple[SlamState, jnp.ndarray, jnp.ndarray]:
    """SLAM over a recorded scan log as one `lax.scan`.

    scans: Scan with leading time axis [T, ...].  base_key: (k0, k1) uint32.
    Returns (final_state, poses [T, 3], costs [T]).
    """

    def step(carry, scan_t):
        state, i = carry
        key = rng.threefry2x32(base_key, jnp.asarray(i, jnp.uint32), jnp.asarray(0, jnp.uint32))
        state, pose, c = slam_step(state, scan_t, key, cfg)
        return (state, i + 1), (pose, c)

    (state, _), (poses, costs) = jax.lax.scan(step, (state, 0), scans)
    return state, poses, costs


def init_slam_batch(cfg: SlamConfig, initial_poses) -> SlamState:
    """B independent session states stacked on a leading robot axis.

    initial_poses: [B, 3] array-like.  Counterpart of deploying one node per
    LiDAR (`launch/lidar_front.launch:2,11-14` / `lidar_back.launch`) — each
    robot/sensor owns a private map and pose history.
    """
    poses = jnp.asarray(initial_poses, cfg.dtype)
    return jax.vmap(lambda p: init_slam(cfg, (p[0], p[1], p[2])))(poses)


@partial(jax.jit, static_argnames=("cfg",))
def run_offline_batch(
    states: SlamState, scans: Scan, base_keys, cfg: SlamConfig
) -> Tuple[SlamState, jnp.ndarray, jnp.ndarray]:
    """B independent SLAM sessions as ONE vmapped `lax.scan` program.

    The reference scales to multiple LiDARs by launching one OS process per
    sensor with remapped topics (`launch/lidar_front.launch`,
    `launch/lidar_back.launch` — SURVEY §2 parallelism item 2); here the
    whole fleet is a leading batch axis, so B mapping sessions share one XLA
    program and the chip pipelines their solves.  No state is shared between
    robots, exactly as between the reference's node instances.

    states: stacked session states ([B] leading axis, `init_slam_batch`);
    scans: Scan with [B, T, ...] axes; base_keys: [B, 2] uint32.
    Returns (final_states, poses [B, T, 3], costs [B, T]).
    """
    return jax.vmap(
        lambda st, sc, k: run_offline(st, sc, k, cfg)
    )(states, scans, jnp.asarray(base_keys, jnp.uint32))
