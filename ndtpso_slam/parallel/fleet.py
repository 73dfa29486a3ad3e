"""Flat-fleet SLAM: B sessions with the robot axis folded into the CELL axis.

`run_offline_batch` (models/slam.py) vmaps whole sessions — semantically
perfect, but XLA lowers a *batched* scatter inside a `lax.scan` carry to a
copy of the whole operand per step (isolated in
`experiments/batched_scatter_ab.py`; donation does not help), so the fleet
pays ~full-map-state bytes of HBM traffic per scan per robot.  The sparse
ring (`MapConfig.ring_rows`) shrank those bytes 11-45x; this module removes
the copy itself.

The trick: a batched scatter over ``[B, C]`` with per-robot indices is
exactly an UNBATCHED scatter over the flattened ``[B*C]`` array with
``flat_id = b*C + id`` — and unbatched scatters on a scan carry are what
XLA updates in place (the solo `run_offline` path, which has no copy wall).
So the fleet step here runs the *solves* vmapped (pure reads — vmap costs
nothing) and the *map update/build* as single flat scatters over the
``[B*C]`` cell axis and the ``[B*R]`` ring axis.  Per-robot arithmetic is
bit-identical to `ndt_map.add_points`/`build_touched` (same `_build_rows`
row math, same scatter sets with disjoint per-robot id ranges), so fleet
trajectories reproduce solo runs exactly — asserted in
`tests/test_parallel.py`.

Scope: the performance path for the reference's one-process-per-LiDAR
deployment DP (`launch/lidar_front.launch:2,11-14`) at fleet scale.
The rollout cost mode runs as ONE kernel call with B = robots
(`_align_rollout_fleet` — one program per robot's solve, so batching robots
means packing per-robot stencils, not vmapping the kernel).
Recovery: the in-step `lax.cond` branch degenerates to both-branches under
batching, so fleet recovery is *host-escalated* — the step quarantines a
lost robot's scan out of its map and `relocalize_fleet_robot` runs the solo
3-stage relocalization on that robot's state slice between polls
(`SlamSessionPool` does this automatically).  The occupancy raster keeps
using `run_offline_batch` (or raster per robot offline from the exported
map state).

Reference semantics preserved: `ndtcell.cpp:21-68` ingestion/build,
`ndtframe.cpp:187-198` update, per-node state isolation of the multi-LiDAR
launch files.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ndtpso_slam.config import MapConfig, SlamConfig
from ndtpso_slam.models import ndt_map
from ndtpso_slam.models.ndt_map import NdtMapState, _build_rows, _CellRows
from ndtpso_slam.models.scan import Scan
from ndtpso_slam.models.slam import AlignState, SlamState, align
from ndtpso_slam.ops import rng
from ndtpso_slam.ops.geometry import cell_index, transform_points


def _flat(x: jnp.ndarray) -> jnp.ndarray:
    """[B, M, ...] -> [B*M, ...] (a bitcast; XLA aliases through it)."""
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _unflat(x: jnp.ndarray, b: int) -> jnp.ndarray:
    return x.reshape((b, x.shape[0] // b) + x.shape[1:])


def fleet_add_points(
    ms: NdtMapState, cfg: MapConfig, wpts: jnp.ndarray, valid: jnp.ndarray
) -> NdtMapState:
    """`ndt_map.add_points` for a stacked [B, ...] map state as ONE flat
    scatter per field.  wpts: [B, N, 2]; valid: [B, N]."""
    b, n = valid.shape
    c = cfg.num_cells
    idx, inb = cell_index(
        wpts, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )  # [B, N]
    mask = valid & inb
    off = jnp.arange(b, dtype=idx.dtype)[:, None] * c
    fid = jnp.where(mask, idx + off, b * c).reshape(-1)  # [B*N] flat sentinel
    dtype = ms.cur_sum.dtype
    centred = (
        wpts - ndt_map.cell_centers(cfg, dtype)[jnp.where(mask, idx, 0)]
    ).astype(dtype)
    px, py = centred[..., 0], centred[..., 1]
    m2 = jnp.stack([px * px, px * py, py * py], axis=-1)
    mflat = mask.reshape(-1)
    cen = jnp.where(mflat[:, None], centred.reshape(-1, 2), 0)
    m2f = jnp.where(mflat[:, None], m2.reshape(-1, 3), 0)
    one = mflat.astype(jnp.int32)
    return ms.replace(
        cur_sum=_unflat(_flat(ms.cur_sum).at[fid].add(cen, mode="drop"), b),
        cur_count=_unflat(_flat(ms.cur_count).at[fid].add(one, mode="drop"), b),
        cur_m2=_unflat(_flat(ms.cur_m2).at[fid].add(m2f, mode="drop"), b),
        created=_unflat(_flat(ms.created).at[fid].set(True, mode="drop"), b),
        built=_unflat(_flat(ms.built).at[fid].set(False, mode="drop"), b),
    )


def fleet_build_touched(
    ms: NdtMapState, cfg: MapConfig, ids: jnp.ndarray
) -> NdtMapState:
    """`ndt_map.build_touched` for a stacked [B, ...] map state as flat
    gathers/scatters.  ids: [B, M] robot-local cell ids (sentinel >= C
    dropped).  Bit-identical per robot to the unbatched build (same
    `_build_rows` math on the same rows)."""
    b, m = ids.shape
    c = cfg.num_cells
    off = jnp.arange(b, dtype=ids.dtype)[:, None] * c
    sentinel = ids >= c
    fid = jnp.where(sentinel, b * c, ids + off)  # [B, M]
    safe = jnp.where(sentinel, 0, ids + off)
    fidf = fid.reshape(-1)
    safef = safe.reshape(-1)
    slot = _flat(ms.slot_idx)[safef]  # [B*M]

    extra = {}
    if cfg.ring_rows > 0:
        r_cap = cfg.ring_rows
        # First-touch ring-row assignment, per robot: mark via one flat
        # scatter, then the order cumsum runs along the robot-local cell
        # axis so each robot numbers its own new cells (ndt_map's
        # assignment, vectorized over B with no batched scatter).
        mark = (
            jnp.zeros((b * c + 1,), bool)
            .at[fidf].set(True, mode="promise_in_bounds")[: b * c]
            .reshape(b, c)
        )
        newmask = mark & (ms.ring_map == -1)  # [B, C]
        order = jnp.cumsum(newmask.astype(jnp.int32), axis=1)
        assigned = ms.ring_used[:, None] + order - 1
        ok = newmask & (assigned < r_cap)
        ring_map = jnp.where(
            ok, assigned, jnp.where(newmask, -2, ms.ring_map)
        )
        n_new = jnp.sum(ok.astype(jnp.int32), axis=1)  # [B]
        rrow = _flat(ring_map)[safef]  # [B*M] robot-local ring row
        has_row = rrow >= 0
        frow = rrow + (safef // c) * r_cap  # flat [B*R] row
        sidxf = jnp.where(has_row, fidf, b * c)
        ring_idx = jnp.where(has_row & ~sentinel.reshape(-1), frow, b * r_cap)
        ring_safe = jnp.where(has_row, frow, 0)
        extra = dict(
            ring_map=ring_map,
            ring_used=ms.ring_used + n_new,
            ring_overflow=ms.ring_overflow
            + jnp.sum((newmask & ~ok).astype(jnp.int32), axis=1),
        )
    else:
        sidxf = fidf
        ring_idx = fidf
        ring_safe = safef

    # Ring rows move WHOLE (1D row ids) and the open slot is edited by a
    # one-hot inside the row: XLA's scatter/gather with a per-row COLUMN
    # index (2D indices into [rows, S, k]) drops to a slow lowering once
    # the operand passes ~0.5M rows, far slower than the 1D row form for
    # the same update.  Whole rows cost only
    # [B*M, S, 6] ≈ 7 MB/step of traffic.  Duplicate ids compute identical
    # rows from identical inputs, so whole-row .set stays order-independent.
    s_slots = cfg.window_slots
    g = lambda arr: _flat(arr)[safef]
    rs_sum = _flat(ms.slot_sum)[ring_safe]  # [B*M, S, 2]
    rs_cnt = _flat(ms.slot_count)[ring_safe]  # [B*M, S]
    rs_cov = _flat(ms.slot_cov)[ring_safe]  # [B*M, S, 3]
    oh = (
        jax.lax.broadcasted_iota(jnp.int32, (slot.shape[0], s_slots), 1)
        == slot[:, None]
    )  # [B*M, S] one-hot of the open slot
    rows = _CellRows(
        mean_c=g(ms.mean_c),
        inv_cov=g(ms.inv_cov),
        built=g(ms.built),
        g_sum=g(ms.g_sum),
        g_count=g(ms.g_count),
        g_cov=g(ms.g_cov),
        old_sum=jnp.sum(jnp.where(oh[..., None], rs_sum, 0), axis=1),
        old_count=jnp.sum(jnp.where(oh, rs_cnt, 0), axis=1),
        old_cov=jnp.sum(jnp.where(oh[..., None], rs_cov, 0), axis=1),
        slot_idx=slot,
        rot_count=g(ms.rot_count),
        cur_sum=g(ms.cur_sum),
        cur_count=g(ms.cur_count),
        cur_m2=g(ms.cur_m2),
    )
    new = _build_rows(cfg, rows)
    put = lambda arr, val: _unflat(
        _flat(arr).at[sidxf].set(val, mode="drop"), b
    )
    return ms.replace(
        mean_c=put(ms.mean_c, new.mean_c),
        inv_cov=put(ms.inv_cov, new.inv_cov),
        built=put(ms.built, new.built),
        g_sum=put(ms.g_sum, new.g_sum),
        g_count=put(ms.g_count, new.g_count),
        g_cov=put(ms.g_cov, new.g_cov),
        slot_sum=_unflat(
            _flat(ms.slot_sum).at[ring_idx].set(
                jnp.where(oh[..., None], new.old_sum[:, None, :], rs_sum),
                mode="drop",
            ),
            b,
        ),
        slot_count=_unflat(
            _flat(ms.slot_count).at[ring_idx].set(
                jnp.where(oh, new.old_count[:, None], rs_cnt), mode="drop"
            ),
            b,
        ),
        slot_cov=_unflat(
            _flat(ms.slot_cov).at[ring_idx].set(
                jnp.where(oh[..., None], new.old_cov[:, None, :], rs_cov),
                mode="drop",
            ),
            b,
        ),
        slot_idx=put(ms.slot_idx, new.slot_idx),
        rot_count=put(ms.rot_count, new.rot_count),
        cur_sum=put(ms.cur_sum, new.cur_sum),
        cur_count=put(ms.cur_count, new.cur_count),
        cur_m2=put(ms.cur_m2, new.cur_m2),
        **extra,
    )


def _align_rollout_fleet(
    keys: jnp.ndarray,  # [B, 2] uint32
    astates: AlignState,  # [B]-stacked
    snaps,  # MapSnapshot stacked [B, C, ...]
    scan_t: Scan,  # [B, N, ...]
    guesses: jnp.ndarray,  # [B, 3]
    cfg: SlamConfig,
):
    """Batched `align` for the rollout cost mode: ONE kernel call with
    B = robots (one program per robot's solve), instead of a per-robot vmap
    of the B=1 call.  Mirrors `models.slam.align` exactly — adaptive
    deviation (`ndtframe.cpp:253`), the kernel dispatch of `_align_rollout`,
    and the exact-cost re-score — so a fleet robot's solve equals its solo
    `run_offline` (the kernel's programs are independent).  This is what
    runs the reference's multi-LiDAR deployment
    (`launch/lidar_front.launch:2,11-14`) on the whole-solve kernel."""
    from ndtpso_slam.models import cost as cost_mod
    from ndtpso_slam.models.pso import PsoResult
    from ndtpso_slam.ops.pallas_rollout import (
        pack_rollout_inputs,
        pso_rollout,
    )

    if cfg.optimizer != "pso":
        raise ValueError(
            "the rollout cost mode implements the deployed PSO update rule "
            f"only; optimizer={cfg.optimizer!r} needs an XLA cost mode"
        )
    dtype = guesses.dtype
    radius = cost_mod.DEFAULT_STENCIL_RADIUS
    first_dev = jnp.asarray(cfg.first_deviation, dtype)
    adaptive = jnp.abs(
        astates.pose_diff * jnp.asarray(cfg.deviation_scale, dtype)
    )
    deviation = jnp.where((astates.iter < 2)[:, None], first_dev[None], adaptive)
    nbrs = jax.vmap(
        lambda g, s, p, v: cost_mod.bind_neighborhood(
            g, s, p, v, cfg.map, radius=radius
        )
    )(guesses, snaps, scan_t.points, scan_t.valid)
    sten, pts = jax.vmap(pack_rollout_inputs)(nbrs, scan_t.points)
    pose, _ = pso_rollout(
        keys, guesses.astype(jnp.float32), deviation.astype(jnp.float32),
        sten, pts, cfg.pso, cfg.map, radius=radius,
        early_exit=cfg.solver_early_exit,
    )
    pose = pose.astype(dtype)
    # Exact-cost re-score of the winning poses (align's fast-mode contract:
    # the per-scan cost is always the true NDT objective) — one batched
    # single-pose gather eval per robot.
    exact = jax.vmap(
        lambda p, sn, pt, v: cost_mod.ndt_cost(p[None], sn, pt, v, cfg.map)[0]
    )(pose, snaps, scan_t.points, scan_t.valid)
    new_astates = AlignState(
        prev_pose=pose,
        pose_diff=pose - astates.prev_pose,
        iter=astates.iter + 1,
    )
    return new_astates, PsoResult(pose=pose, cost=exact)


def _fleet_step(
    states: SlamState, scan_t: Scan, keys: jnp.ndarray, cfg: SlamConfig,
    active: jnp.ndarray | None = None,
) -> Tuple[SlamState, jnp.ndarray, jnp.ndarray]:
    """One fleet step: vmapped solves, flat map update.  Mirrors
    `slam_step` (align/first-scan/fitness bookkeeping) minus recovery/OG.

    ``active`` ([B] bool, None = all) masks sessions OUT of the step
    bitwise: an inactive session's solve result is discarded, its scalar
    state is kept by `where`, and its map rows are simply never written
    (its scatter ids collapse to the drop sentinel) — which is what keeps
    the streaming pool's donated buffers update-in-place instead of
    select-copying whole map states per poll."""
    b = keys.shape[0]
    dtype = states.pose.dtype
    first = states.step == 0  # [B]
    if active is None:
        active = jnp.ones((b,), bool)
    snaps = jax.vmap(lambda m: ndt_map.snapshot(m, cfg.map))(states.map)
    if cfg.cost_mode == "rollout":
        # One kernel call with B = robots rather than a vmapped B=1 call.
        new_astates, results = _align_rollout_fleet(
            keys, states.align, snaps, scan_t, states.pose, cfg
        )
    else:
        new_astates, results = jax.vmap(
            lambda k, a, sn, sc, g: align((k[0], k[1]), a, sn, sc, g, cfg)
        )(keys, states.align, snaps, scan_t, states.pose)
    keep = first | ~active  # [B] sessions whose pose/bookkeeping stay put
    pose = jnp.where(keep[:, None], states.pose, results.pose)
    astate = jax.tree_util.tree_map(
        lambda old, new: jnp.where(
            keep.reshape((b,) + (1,) * (new.ndim - 1)), old, new
        ),
        states.align,
        new_astates,
    )
    n_valid = jnp.sum(scan_t.valid, axis=1)
    cost = jnp.where(active, results.cost.astype(dtype), 0)
    fitness = jnp.where(
        active,
        -cost / jnp.maximum(n_valid, 1).astype(dtype),
        states.fitness,
    )

    lost = jnp.zeros_like(active)
    if cfg.recovery.enabled:
        # Fleet recovery is two-tier (module docstring): the maskable parts
        # of slam_step's recovery run HERE, fully batched — dropout
        # dead-reckoning and quarantine (a lost robot's scan must not
        # corrupt its map) — while the expensive relocalization sweep is
        # host-escalated per lost robot (`relocalize_fleet_robot`): a
        # batched `lax.cond` would execute the 18k-pose sweep for every
        # robot on every step.
        rc = cfg.recovery
        degraded = (~first) & active & (n_valid < rc.min_valid_beams)
        lost = (
            (~first)
            & active
            & (~degraded)
            & (states.align.iter >= 2)
            & (fitness < jnp.asarray(rc.fitness_threshold, dtype))
        )
        dead_pose = states.pose + states.align.pose_diff
        pose = jnp.where(degraded[:, None], dead_pose, pose)
        # Dead-reckoned steps keep the previous velocity estimate; lost
        # robots keep the failed align's bookkeeping (the host-side
        # relocalization rewrites it on accept).
        astate = AlignState(
            prev_pose=jnp.where(
                (first | ~active)[:, None], astate.prev_pose, pose
            ),
            pose_diff=jnp.where(
                degraded[:, None], states.align.pose_diff, astate.pose_diff
            ),
            iter=astate.iter,
        )
        # fitness is what the host polls for lost detection, so a degraded
        # (sensor-dropout) robot keeps its previous fitness — it must not
        # look lost to the escalation loop.
        fitness = jnp.where(degraded, states.fitness, fitness)

    # `consumed` robots advanced their clock this step; `active` (possibly
    # shrunk by quarantine) gates map ingestion only.
    consumed = active
    if cfg.recovery.enabled:
        active = active & ~degraded & ~lost  # quarantine map ingestion

    wpts = jax.vmap(transform_points)(scan_t.points, pose)
    idx, inb = cell_index(
        wpts, size_m=cfg.map.size_m, cell_side_m=cfg.map.cell_side_m,
        cells_per_side=cfg.map.cells_per_side,
    )
    ingest = scan_t.valid & active[:, None]
    ids = jnp.where(ingest & inb, idx, cfg.map.num_cells)
    # prev rebuild is keyed on `consumed`, not the quarantine-shrunk mask:
    # a quarantined robot ingests nothing, but cells its LAST build rotated
    # still need their stale-slot-eviction rebuild (slam_step's degraded
    # path does the same — a pure rebuild, no new data).
    prev = jnp.where(consumed[:, None], states.prev_ids, cfg.map.num_cells)
    new_map = fleet_add_points(states.map, cfg.map, wpts, ingest)
    new_map = fleet_build_touched(
        new_map, cfg.map, jnp.concatenate([ids, prev], axis=1)
    )
    new_states = SlamState(
        map=new_map, align=astate, og=None, pose=pose,
        step=states.step + consumed.astype(states.step.dtype),
        fitness=fitness,
        recoveries=states.recoveries,
        # Quarantined robots consumed a scan but touched no cells: ids is
        # all-sentinel for them (ingest is masked), matching slam_step's
        # degraded-path prev_ids.
        prev_ids=jnp.where(consumed[:, None], ids, states.prev_ids),
    )
    return new_states, pose, cost, lost


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def fleet_pool_step(
    states: SlamState, scans: Scan, base_keys: jnp.ndarray,
    active: jnp.ndarray, cfg: SlamConfig,
) -> Tuple[SlamState, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Streaming-pool step through the flat-fleet update (the
    `SlamSessionPool` fast path).  Same contract as `sessions.pool_step`
    plus a trailing ``lost`` [B] bool (always all-False with recovery off);
    donation + unbatched flat scatters update the pool's map state in
    place across polls (the vmapped pool_step's donation could not avoid
    the batched-scatter lowering's copies).  With ``cfg.recovery.enabled`` the step dead-reckons dropouts
    and quarantines lost robots' scans; the caller escalates robots
    flagged ``lost`` to :func:`relocalize_fleet_robot`."""
    _check_fleet_cfg(cfg, allow_recovery=True)
    keys = jax.vmap(
        lambda bk, st: jnp.stack(
            rng.threefry2x32(
                (bk[0], bk[1]), st.astype(jnp.uint32),
                jnp.asarray(0, jnp.uint32),
            )
        )
    )(jnp.asarray(base_keys, jnp.uint32), states.step)
    return _fleet_step(states, scans, keys, cfg, active)


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def relocalize_fleet_robot(
    states: SlamState,  # stacked [B] fleet state (donated)
    idx: jnp.ndarray,  # [] int32 robot index
    scan: Scan,  # [N, ...] the scan the step quarantined for this robot
    key: jnp.ndarray,  # [2] uint32
    cfg: SlamConfig,
) -> Tuple[SlamState, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Host-escalated relocalization of ONE lost robot in a fleet.

    A kidnapped robot in a fleet must relocalize without dragging the other
    B-1 robots through the 3-stage sweep (`models/slam.py:_relocalize`) —
    a batched `lax.cond` executes both branches for every robot.  So the
    fleet step only *flags* lost robots (and quarantines their scans), and
    the host calls this between polls: it slices the robot's map out of the
    stacked state, runs the identical solo relocalization, and — only if
    the relocalized pose beats the failed align's exact cost, the same
    accept bar as `slam_step` — adopts the pose and ingests the quarantined
    scan at the corrected pose via the flat one-robot-masked map update.
    On reject everything stays quarantined (pose kept, scan dropped).

    Returns ``(states', pose [3], cost [], accepted [])``.  All per-robot
    writes are dynamic-slice updates / sentinel-masked flat scatters, so
    donation keeps the fleet state in place; the other robots' rows are
    untouched bitwise.  Capability counterpart of `slam_step`'s recovery
    branch (`models/slam.py:268-399`); the reference has no recovery at all
    (SURVEY §5 'failure detection: none').
    """
    from ndtpso_slam.models.slam import _relocalize

    b = states.fitness.shape[0]
    dtype = states.pose.dtype
    idx = jnp.asarray(idx, jnp.int32)
    map_i = jax.tree_util.tree_map(lambda x: x[idx], states.map)
    snap = ndt_map.snapshot(map_i, cfg.map)
    last_pose = states.pose[idx]
    rpose, rcost = _relocalize(
        (key[0], key[1]), snap, scan, last_pose, last_pose, cfg
    )
    # The step stored fitness = -exact_cost / n_valid for THIS scan, so the
    # failed align's exact cost (slam_step's accept bar) reconstructs
    # exactly from the state.
    n_valid = jnp.sum(scan.valid)
    nv = jnp.maximum(n_valid, 1).astype(dtype)
    cur_cost = -states.fitness[idx] * nv
    # Same accept bar as slam_step's recovery: strictly better AND inside
    # the sane fitness band [accept_fitness, 1] — a merely-less-terrible
    # pose must not be adopted (acceptance ingests the quarantined scan;
    # a garbage accept would corrupt the map) and neither may an
    # indefinite-inverse score blow-up (RecoveryConfig.accept_fitness).
    # Rejected robots stay flagged lost on later polls.
    rfit = -rcost / nv
    accept = (
        (rcost < cur_cost)
        & (rfit >= jnp.asarray(cfg.recovery.accept_fitness, dtype))
        & (rfit <= jnp.asarray(1.0, dtype))
    )
    pose = jnp.where(accept, rpose, last_pose)
    cost = jnp.where(accept, rcost, cur_cost)

    # Ingest the quarantined scan at the corrected pose (accepted only):
    # the flat update with a one-robot row mask writes only robot idx's
    # cells, in place.
    rowmask = (jnp.arange(b) == idx) & accept  # [B]
    wpts_i = transform_points(scan.points, pose)  # [N, 2]
    cidx, inb = cell_index(
        wpts_i, size_m=cfg.map.size_m, cell_side_m=cfg.map.cell_side_m,
        cells_per_side=cfg.map.cells_per_side,
    )
    ids_i = jnp.where(scan.valid & inb, cidx, cfg.map.num_cells)  # [N]
    wpts_b = jnp.broadcast_to(wpts_i[None], (b,) + wpts_i.shape)
    valid_b = scan.valid[None, :] & rowmask[:, None]
    ids_b = jnp.where(rowmask[:, None], ids_i[None], cfg.map.num_cells)
    new_map = fleet_add_points(states.map, cfg.map, wpts_b, valid_b)
    new_map = fleet_build_touched(new_map, cfg.map, ids_b)

    zero3 = jnp.zeros((3,), dtype)
    new_states = SlamState(
        map=new_map,
        align=AlignState(
            # A recovery jump is not robot motion: pose_diff := 0 so the
            # next deviation doesn't explode (slam_step's bookkeeping).
            prev_pose=states.align.prev_pose.at[idx].set(pose),
            pose_diff=states.align.pose_diff.at[idx].set(
                jnp.where(accept, zero3, states.align.pose_diff[idx])
            ),
            iter=states.align.iter,
        ),
        og=states.og,
        pose=states.pose.at[idx].set(pose),
        step=states.step,
        fitness=states.fitness.at[idx].set(
            jnp.where(accept, -cost / nv, states.fitness[idx])
        ),
        recoveries=states.recoveries.at[idx].add(accept.astype(jnp.int32)),
        prev_ids=states.prev_ids.at[idx].set(
            jnp.where(accept, ids_i, states.prev_ids[idx])
        ),
    )
    return new_states, pose, cost, accept


def _check_fleet_cfg(cfg: SlamConfig, allow_recovery: bool = False) -> None:
    if cfg.recovery.enabled and not allow_recovery:
        raise ValueError(
            "offline flat-fleet runners cannot take the recovery branch "
            "mid-scan (the host escalation loop is not in lax.scan); use "
            "SlamSessionPool / fleet_pool_step + relocalize_fleet_robot "
            "for recovery-enabled fleets, or run_offline_batch"
        )
    if cfg.og.enabled:
        raise ValueError(
            "the flat-fleet path does not raster occupancy grids; use "
            "run_offline_batch (or raster per robot offline from the map "
            "state export)"
        )
    if cfg.cost_mode == "rollout" and cfg.optimizer != "pso":
        raise ValueError(
            "the rollout cost mode implements the deployed PSO update rule "
            f"only; optimizer={cfg.optimizer!r} needs an XLA cost mode"
        )


def _run_offline_fleet_impl(states, scans, base_keys, cfg):
    def step(carry, scan_t):
        states, i = carry
        keys = jax.vmap(
            lambda bk: jnp.stack(
                rng.threefry2x32(
                    (bk[0], bk[1]), jnp.asarray(i, jnp.uint32),
                    jnp.asarray(0, jnp.uint32),
                )
            )
        )(base_keys)
        states, pose, cost, _lost = _fleet_step(states, scan_t, keys, cfg)
        return (states, i + 1), (pose, cost)

    xs = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), scans)
    (states, _), (poses, costs) = jax.lax.scan(step, (states, 0), xs)
    return states, jnp.swapaxes(poses, 0, 1), jnp.swapaxes(costs, 0, 1)


@partial(jax.jit, static_argnames=("cfg",))
def run_offline_fleet(
    states: SlamState, scans: Scan, base_keys, cfg: SlamConfig
) -> Tuple[SlamState, jnp.ndarray, jnp.ndarray]:
    """B SLAM sessions over recorded logs, copy-wall-free.

    Same contract as `run_offline_batch` (states from `init_slam_batch`,
    scans [B, T, ...], base_keys [B, 2]; returns (states', poses [B, T, 3],
    costs [B, T])) and the same per-robot results — but the map update is
    one flat scatter per field instead of a batched scatter, so the scan
    carry updates in place.
    """
    _check_fleet_cfg(cfg)
    return _run_offline_fleet_impl(
        states, scans, jnp.asarray(base_keys, jnp.uint32), cfg
    )


def make_fleet_sharded(mesh, cfg: SlamConfig, axis="solves"):
    """Jitted fleet runner with the ROBOT axis sharded over a device mesh.

    The reference's deployment DP is one OS process per LiDAR on one
    machine (`launch/lidar_front.launch:2,11-14`); across cards the same
    shape is robots-over-devices: each device runs the flat-fleet
    loop for its B/n_devices sessions — maps are private, so there are NO
    collectives, and per-robot results equal the single-device fleet
    (asserted on the virtual CPU mesh in tests/test_parallel.py).

    Returns ``f(states, scans, base_keys) -> (states', poses, costs)``
    with every input/output sharded on the leading (robot) axis, which
    must divide the mesh axis size.  Build once and reuse (each fresh
    build recompiles).
    """
    _check_fleet_cfg(cfg)
    from jax.sharding import PartitionSpec

    spec = PartitionSpec(axis)
    local = lambda st, sc, bk: _run_offline_fleet_impl(st, sc, bk, cfg)
    shm = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec),
        check_vma=False,
    )
    return jax.jit(shm)


def run_offline_fleet_sharded(
    mesh, states: SlamState, scans: Scan, base_keys, cfg: SlamConfig,
    axis: str = "solves",
) -> Tuple[SlamState, jnp.ndarray, jnp.ndarray]:
    """One-shot convenience wrapper around :func:`make_fleet_sharded`."""
    runner = make_fleet_sharded(mesh, cfg, axis=axis)
    return runner(states, scans, jnp.asarray(base_keys, jnp.uint32))
