"""Dense, batched NDT grid map state and its ingestion/build transforms.

The reference models the map as ``vector<NDTCell>`` where each cell owns raw
point buffers and a 100-slot sliding window of partial sums
(`ndtcell.h:63-81`, `ndtcell.cpp:21-68`).  Pointer-chasing objects are the
opposite of accelerator-idiomatic, so here the whole map is a pytree of dense arrays
over the flattened cell grid ``[C, ...]``:

* ingestion (`NDTCell::addPoint`, `ndtcell.cpp:21-34`) becomes one masked
  scatter-add over ``[N]`` scan points;
* the lazy per-cell ``build()`` (`ndtcell.cpp:36-68`) becomes one dense masked
  update over ``[C]`` cells — the sliding-window ring buffer is indexed with a
  per-cell ``take/put_along_axis`` so each build touches exactly one slot per
  cell, O(C) traffic, not O(C*S);
* the raw per-slot point buffers are *eliminated*: the covariance contribution
  of the current slot around the (freshly updated) mean
  (`ndtcell.cpp:46-55`) is computed from the slot's running second moment via
  ``Σ(p-μ)(p-μ)' = M2 - μs' - sμ' + nμμ'`` — algebraically identical, no
  point storage.

Precision: every stored moment is *centred on its cell's centre*.  Raw second
moments of points 150 m from the origin are ~1e4 m² and float32 would lose the
~1e-2 m² cell variance entirely; centred, every stored quantity is O(cell
side) and float32 keeps ~7 digits of it.  ``mean`` is reconstructed as
``centre + centred_mean`` at build time.

The lazy-build dirty flag of the reference (rebuild inside the cost function,
`core.cpp:27-28`, racy under OpenMP) becomes an explicit functional phase:
callers run :func:`build` before solving.  Same math, deterministic order.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from ndtpso_slam.utils.pytree import PyTreeNode

from ndtpso_slam.config import MapConfig
from ndtpso_slam.ops import gaussian
from ndtpso_slam.ops.geometry import cell_index, transform_points


class MapSnapshot(PyTreeNode):
    """What a scan-match solve consumes: built per-cell Gaussians."""

    mean: jnp.ndarray  # [C, 2] world-frame cell means
    inv_cov: jnp.ndarray  # [C, 3] packed symmetric inverse covariances
    built: jnp.ndarray  # [C] bool


class NdtMapState(PyTreeNode):
    """Full accumulator state of the sliding-window NDT map (one map).

    All first/second moments are centred on the owning cell's centre.
    """

    # Derived Gaussians (persist between builds: a cell whose window count
    # drops back to <=2 keeps its stale Gaussian exactly like the C++ keeps
    # `mean`/`s_inv_covar` untouched when the count>2 branch is skipped).
    mean_c: jnp.ndarray  # [C, 2] centred means
    inv_cov: jnp.ndarray  # [C, 3]
    built: jnp.ndarray  # [C] bool
    created: jnp.ndarray  # [C] bool
    # Window-global accumulators (`s_global_*`, ndtcell.h:65-67)
    g_sum: jnp.ndarray  # [C, 2]
    g_count: jnp.ndarray  # [C] int32
    g_cov: jnp.ndarray  # [C, 3]
    # Ring buffer of per-slot partials (`s_partial_*`).  Dense mode
    # (cfg.ring_rows == 0): one row per cell, [C, S, ...].  Sparse mode
    # (ring_rows = R > 0): [R, S, ...] rows assigned to cells on first
    # build via `ring_map` — the reference only ever allocates window state
    # for touched cells (its map is a sparse structure), and ring bytes are
    # both the fleet's HBM ceiling and, under XLA's copy-on-scatter carry
    # lowering, its throughput ceiling (see MapConfig.ring_rows).
    slot_sum: jnp.ndarray  # [C|R, S, 2]
    slot_count: jnp.ndarray  # [C|R, S] int32
    slot_cov: jnp.ndarray  # [C|R, S, 3]
    slot_idx: jnp.ndarray  # [C] int32 current window slot
    # Sparse-mode indirection: cell -> ring row (-1 never seen, -2
    # permanently overflowed); shape [0] in dense mode.  ring_used counts
    # assigned rows; ring_overflow counts DISTINCT cells whose first build
    # found no free row (those cells never build) — R + ring_overflow rows
    # would have sufficed for the run.
    ring_map: jnp.ndarray  # [C] int32 (sparse) | [0] (dense)
    ring_used: jnp.ndarray  # [] int32
    ring_overflow: jnp.ndarray  # [] int32
    # Cumulative ring rotations per cell (observability: slot_idx alone is
    # mod-S, so whether the window ever WRAPPED — i.e. old slots were
    # evicted, `ndtcell.cpp:61-65` going all the way around — is invisible
    # from the final state without this monotone counter).
    rot_count: jnp.ndarray  # [C] int32
    # Current (open) slot accumulators (`s_current_*` + second moment)
    cur_sum: jnp.ndarray  # [C, 2]
    cur_count: jnp.ndarray  # [C] int32
    cur_m2: jnp.ndarray  # [C, 3]


def init_map(cfg: MapConfig, dtype=jnp.float32) -> NdtMapState:
    """Fresh all-zero map (NDTFrame ctor, `ndtframe.cpp:19-66`)."""
    c = cfg.num_cells
    s = cfg.window_slots
    r = cfg.ring_rows if cfg.ring_rows > 0 else c
    sparse = cfg.ring_rows > 0
    f = lambda *shape: jnp.zeros(shape, dtype)
    return NdtMapState(
        mean_c=f(c, 2),
        inv_cov=f(c, 3),
        built=jnp.zeros((c,), bool),
        created=jnp.zeros((c,), bool),
        g_sum=f(c, 2),
        g_count=jnp.zeros((c,), jnp.int32),
        g_cov=f(c, 3),
        slot_sum=f(r, s, 2),
        slot_count=jnp.zeros((r, s), jnp.int32),
        slot_cov=f(r, s, 3),
        slot_idx=jnp.zeros((c,), jnp.int32),
        ring_map=jnp.full((c if sparse else 0,), -1, jnp.int32),
        ring_used=jnp.asarray(0, jnp.int32),
        ring_overflow=jnp.asarray(0, jnp.int32),
        rot_count=jnp.zeros((c,), jnp.int32),
        cur_sum=f(c, 2),
        cur_count=jnp.zeros((c,), jnp.int32),
        cur_m2=f(c, 3),
    )


def cell_centers(cfg: MapConfig, dtype=jnp.float32) -> jnp.ndarray:
    """World coordinates of each cell's centre, [C, 2]."""
    w = cfg.cells_per_side
    i = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    ix = (i % w).astype(dtype)
    iy = (i // w).astype(dtype)
    half = jnp.asarray(cfg.half_size_m, dtype)
    side = jnp.asarray(cfg.cell_side_m, dtype)
    return jnp.stack([(ix + 0.5) * side - half, (iy + 0.5) * side - half], axis=-1)


def add_points(
    state: NdtMapState, cfg: MapConfig, points: jnp.ndarray, valid: jnp.ndarray
) -> NdtMapState:
    """Scatter a batch of world-frame points into their cells.

    Replicates `NDTFrame::addPoint` -> `NDTCell::addPoint`
    (`ndtframe.cpp:215-225`, `ndtcell.cpp:21-34`): out-of-frame points are
    dropped, touched cells are marked created and un-built.

    points: [N, 2]; valid: [N] bool.
    """
    idx, inb = cell_index(
        points,
        size_m=cfg.size_m,
        cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )
    mask = valid & inb
    # Out-of-range sentinel + mode='drop' => masked scatter.
    sidx = jnp.where(mask, idx, cfg.num_cells)
    dtype = state.cur_sum.dtype
    centred = (points - cell_centers(cfg, dtype)[idx]).astype(dtype)
    px, py = centred[..., 0], centred[..., 1]
    m2 = jnp.stack([px * px, px * py, py * py], axis=-1)
    one = mask.astype(jnp.int32)
    return state.replace(
        cur_sum=state.cur_sum.at[sidx].add(
            jnp.where(mask[..., None], centred, 0), mode="drop"
        ),
        cur_count=state.cur_count.at[sidx].add(one, mode="drop"),
        cur_m2=state.cur_m2.at[sidx].add(jnp.where(mask[..., None], m2, 0), mode="drop"),
        created=state.created.at[sidx].set(True, mode="drop"),
        built=state.built.at[sidx].set(False, mode="drop"),
    )


def update(
    state: NdtMapState, cfg: MapConfig, pose: jnp.ndarray, points: jnp.ndarray,
    valid: jnp.ndarray,
) -> NdtMapState:
    """Transform a scan by ``pose`` and ingest it (`NDTFrame::update`,
    `ndtframe.cpp:187-198`)."""
    return add_points(state, cfg, transform_points(points, pose), valid)


def _take_slot(arr: jnp.ndarray, slot_idx: jnp.ndarray) -> jnp.ndarray:
    """Per-cell gather of the current window slot: [C,S,...] -> [C,...]."""
    return arr[jnp.arange(arr.shape[0]), slot_idx]


def _put_slot(arr: jnp.ndarray, slot_idx: jnp.ndarray, val: jnp.ndarray) -> jnp.ndarray:
    """Per-cell scatter into the current window slot."""
    return arr.at[jnp.arange(arr.shape[0]), slot_idx].set(val)


def build(state: NdtMapState, cfg: MapConfig) -> NdtMapState:
    """Dense sliding-window build of every cell (`NDTCell::build`,
    `ndtcell.cpp:36-68`, driven by `NDTFrame::build`, `ndtframe.cpp:68-117`).

    Per cell, in reference order:
      1. WINDOW_ADD of the open slot's sum/count into the window globals;
      2. if the window count exceeds 2: recompute the mean, recompute the open
         slot's covariance contribution around the *new* mean, WINDOW_ADD it,
         refresh the regularized inverse covariance, mark built;
      3. if the open slot's count exceeds the slot capacity: rotate the ring
         (advance slot index mod S, zero the open accumulators).
    All branches are masks; the whole thing is one fused elementwise pass.
    """
    if cfg.ring_rows > 0:
        raise ValueError(
            "the dense build() needs one ring row per cell; sparse maps "
            "(MapConfig.ring_rows > 0) must build through build_touched "
            "(the slam_step path)"
        )
    dtype = state.cur_sum.dtype
    # --- 1. WINDOW_ADD sums/counts (ndtcell.cpp:38-41, macro ndtcell.h:13-15)
    old_sum = _take_slot(state.slot_sum, state.slot_idx)
    old_count = _take_slot(state.slot_count, state.slot_idx)
    g_sum = state.g_sum + state.cur_sum - old_sum
    g_count = state.g_count + state.cur_count - old_count
    slot_sum = _put_slot(state.slot_sum, state.slot_idx, state.cur_sum)
    slot_count = _put_slot(state.slot_count, state.slot_idx, state.cur_count)

    # --- 2. Gaussian refresh where count > 2 (ndtcell.cpp:43-59)
    has_stats = g_count > 2
    n_w = jnp.maximum(g_count, 1).astype(dtype)  # safe denominator
    mean_c_new = g_sum / n_w[:, None]
    # Covariance contribution of the open slot around the new mean, from the
    # slot's running moments (replaces the raw-point loop, ndtcell.cpp:49-52).
    n_cur = state.cur_count.astype(dtype)
    sx, sy = state.cur_sum[:, 0], state.cur_sum[:, 1]
    mx, my = mean_c_new[:, 0], mean_c_new[:, 1]
    cov_cur = jnp.stack(
        [
            state.cur_m2[:, 0] - 2.0 * mx * sx + n_cur * mx * mx,
            state.cur_m2[:, 1] - mx * sy - my * sx + n_cur * mx * my,
            state.cur_m2[:, 2] - 2.0 * my * sy + n_cur * my * my,
        ],
        axis=-1,
    )
    old_cov = _take_slot(state.slot_cov, state.slot_idx)
    g_cov_new = state.g_cov + cov_cur - old_cov
    # The covariance WINDOW_ADD only happens inside the count>2 branch
    # (ndtcell.cpp:43-55): mask both the global and the slot write.
    g_cov = jnp.where(has_stats[:, None], g_cov_new, state.g_cov)
    slot_cov = _put_slot(
        state.slot_cov,
        state.slot_idx,
        jnp.where(has_stats[:, None], cov_cur, old_cov),
    )
    covar = g_cov_new / n_w[:, None]
    inv_cov_new = gaussian.regularized_inverse(covar)
    mean_c = jnp.where(has_stats[:, None], mean_c_new, state.mean_c)
    inv_cov = jnp.where(has_stats[:, None], inv_cov_new, state.inv_cov)
    built = state.built | has_stats

    # --- 3. Ring rotation where the open slot is full (ndtcell.cpp:61-65)
    rotate = state.cur_count > cfg.slot_capacity
    slot_idx = jnp.where(
        rotate, (state.slot_idx + 1) % cfg.window_slots, state.slot_idx
    )
    zero2 = jnp.zeros_like(state.cur_sum)
    zero3 = jnp.zeros_like(state.cur_m2)
    return state.replace(
        mean_c=mean_c,
        inv_cov=inv_cov,
        built=built,
        g_sum=g_sum,
        g_count=g_count,
        g_cov=g_cov,
        slot_sum=slot_sum,
        slot_count=slot_count,
        slot_cov=slot_cov,
        slot_idx=slot_idx,
        rot_count=state.rot_count + rotate.astype(jnp.int32),
        cur_sum=jnp.where(rotate[:, None], zero2, state.cur_sum),
        cur_count=jnp.where(rotate, 0, state.cur_count),
        cur_m2=jnp.where(rotate[:, None], zero3, state.cur_m2),
    )


def _build_rows(cfg: MapConfig, rows: "_CellRows") -> "_CellRows":
    """The per-cell build math of :func:`build`, on a gathered row batch."""
    dtype = rows.cur_sum.dtype
    g_sum = rows.g_sum + rows.cur_sum - rows.old_sum
    g_count = rows.g_count + rows.cur_count - rows.old_count
    has_stats = g_count > 2
    n_w = jnp.maximum(g_count, 1).astype(dtype)
    mean_c_new = g_sum / n_w[:, None]
    n_cur = rows.cur_count.astype(dtype)
    sx, sy = rows.cur_sum[:, 0], rows.cur_sum[:, 1]
    mx, my = mean_c_new[:, 0], mean_c_new[:, 1]
    cov_cur = jnp.stack(
        [
            rows.cur_m2[:, 0] - 2.0 * mx * sx + n_cur * mx * mx,
            rows.cur_m2[:, 1] - mx * sy - my * sx + n_cur * mx * my,
            rows.cur_m2[:, 2] - 2.0 * my * sy + n_cur * my * my,
        ],
        axis=-1,
    )
    g_cov_new = rows.g_cov + cov_cur - rows.old_cov
    g_cov = jnp.where(has_stats[:, None], g_cov_new, rows.g_cov)
    slot_cov = jnp.where(has_stats[:, None], cov_cur, rows.old_cov)
    covar = g_cov_new / n_w[:, None]
    inv_cov_new = gaussian.regularized_inverse(covar)
    mean_c = jnp.where(has_stats[:, None], mean_c_new, rows.mean_c)
    inv_cov = jnp.where(has_stats[:, None], inv_cov_new, rows.inv_cov)
    built = rows.built | has_stats
    rotate = rows.cur_count > cfg.slot_capacity
    slot_idx = jnp.where(
        rotate, (rows.slot_idx + 1) % cfg.window_slots, rows.slot_idx
    )
    rot_count = rows.rot_count + rotate.astype(jnp.int32)
    return _CellRows(
        mean_c=mean_c,
        inv_cov=inv_cov,
        built=built,
        g_sum=g_sum,
        g_count=g_count,
        g_cov=g_cov,
        old_sum=rows.cur_sum,  # new slot contents
        old_count=rows.cur_count,
        old_cov=slot_cov,
        slot_idx=slot_idx,
        rot_count=rot_count,
        cur_sum=jnp.where(rotate[:, None], jnp.zeros_like(rows.cur_sum), rows.cur_sum),
        cur_count=jnp.where(rotate, 0, rows.cur_count),
        cur_m2=jnp.where(rotate[:, None], jnp.zeros_like(rows.cur_m2), rows.cur_m2),
    )


class _CellRows(PyTreeNode):
    """A gathered batch of per-cell state rows (build scratch)."""

    mean_c: jnp.ndarray
    inv_cov: jnp.ndarray
    built: jnp.ndarray
    g_sum: jnp.ndarray
    g_count: jnp.ndarray
    g_cov: jnp.ndarray
    old_sum: jnp.ndarray  # current window slot's stored partials
    old_count: jnp.ndarray
    old_cov: jnp.ndarray
    slot_idx: jnp.ndarray
    rot_count: jnp.ndarray
    cur_sum: jnp.ndarray
    cur_count: jnp.ndarray
    cur_m2: jnp.ndarray


def build_touched(
    state: NdtMapState, cfg: MapConfig, ids: jnp.ndarray
) -> NdtMapState:
    """Sparse build: refresh only the cells in ``ids``.

    The dense :func:`build` moves 6 full [C]-row gather/scatter passes over
    the ring buffer every call — at the reference's default scale (C=360k
    cells, 100 slots) that is most of a SLAM step's memory traffic.  But a
    scan of N beams can only change the N cells it binned into: every other
    cell's WINDOW_ADD replaces its slot with the identical value it already
    holds (its open accumulators are untouched since its own last build) and
    its rotation test cannot newly fire (a rotation zeroes the open slot, so
    it only triggers on the build immediately after an ingestion).  So
    rebuilding exactly the touched rows is BIT-IDENTICAL to the dense pass
    **provided a build ran after every prior ingestion** — which `slam_step`
    guarantees (`tests/test_map.py` asserts the equivalence, rotations
    included).

    ids: [N] int32 flat cell ids; entries >= cfg.num_cells are dropped
    (the same sentinel convention as :func:`add_points`).  Duplicates are
    fine: duplicate rows compute identical values and scatter `.set` writes
    of identical values are order-independent.

    One carry-over is required for exactness: a cell whose build ROTATED the
    ring must be rebuilt on the NEXT build too (the reference evicts the
    now-current slot's stale partials one build after rotation,
    `ndtcell.cpp:38-41` running with zeroed current accumulators).  Rotation
    only fires on touched builds, so callers pass the UNION of this scan's
    ids and the previous scan's ids (`slam_step` threads `prev_ids` through
    `SlamState` for exactly this).
    """
    sentinel = ids >= cfg.num_cells
    safe = jnp.where(sentinel, 0, ids)
    sidx = jnp.where(sentinel, cfg.num_cells, ids)
    slot = state.slot_idx[safe]

    extra = {}
    if cfg.ring_rows > 0:
        # Sparse ring: assign rows to first-build cells.  One O(C)
        # elementwise pass (mark/cumsum over the int32 [C] indirection —
        # ~1.4 MB at deployment scale) replaces any O(C·S) ring traffic.
        r_cap = cfg.ring_rows
        mark = (
            jnp.zeros((cfg.num_cells + 1,), bool)
            .at[sidx].set(True, mode="promise_in_bounds")[: cfg.num_cells]
        )
        # -1 = never seen; -2 = permanently overflowed (marked below so each
        # dropped cell counts ONCE — ring_overflow is then the number of
        # distinct cells R was short by, directly usable for sizing R).
        newmask = mark & (state.ring_map == -1)
        order = jnp.cumsum(newmask.astype(jnp.int32))
        assigned = state.ring_used + order - 1
        ok = newmask & (assigned < r_cap)
        ring_map = jnp.where(
            ok, assigned, jnp.where(newmask, -2, state.ring_map)
        )
        n_new = jnp.sum(ok.astype(jnp.int32))
        rrow = ring_map[safe]  # [N]; -1 = overflow, never builds
        has_row = rrow >= 0
        # Overflow cells are excluded from EVERY write (their window
        # arithmetic never starts); ring writes address [R] rows directly.
        sidx = jnp.where(has_row, sidx, cfg.num_cells)
        ring_idx = jnp.where(has_row & ~sentinel, rrow, r_cap)
        ring_safe = jnp.where(has_row, rrow, 0)
        extra = dict(
            ring_map=ring_map,
            ring_used=state.ring_used + n_new,
            ring_overflow=state.ring_overflow
            + jnp.sum((newmask & ~ok).astype(jnp.int32)),
        )
    else:
        ring_idx = sidx
        ring_safe = safe

    rows = _CellRows(
        mean_c=state.mean_c[safe],
        inv_cov=state.inv_cov[safe],
        built=state.built[safe],
        g_sum=state.g_sum[safe],
        g_count=state.g_count[safe],
        g_cov=state.g_cov[safe],
        old_sum=state.slot_sum[ring_safe, slot],
        old_count=state.slot_count[ring_safe, slot],
        old_cov=state.slot_cov[ring_safe, slot],
        slot_idx=slot,
        rot_count=state.rot_count[safe],
        cur_sum=state.cur_sum[safe],
        cur_count=state.cur_count[safe],
        cur_m2=state.cur_m2[safe],
    )
    new = _build_rows(cfg, rows)
    return state.replace(
        mean_c=state.mean_c.at[sidx].set(new.mean_c, mode="drop"),
        inv_cov=state.inv_cov.at[sidx].set(new.inv_cov, mode="drop"),
        built=state.built.at[sidx].set(new.built, mode="drop"),
        g_sum=state.g_sum.at[sidx].set(new.g_sum, mode="drop"),
        g_count=state.g_count.at[sidx].set(new.g_count, mode="drop"),
        g_cov=state.g_cov.at[sidx].set(new.g_cov, mode="drop"),
        # The slot write targets the PRE-rotation slot (matching the dense
        # pass, which puts before advancing the ring).
        slot_sum=state.slot_sum.at[ring_idx, slot].set(new.old_sum, mode="drop"),
        slot_count=state.slot_count.at[ring_idx, slot].set(new.old_count, mode="drop"),
        slot_cov=state.slot_cov.at[ring_idx, slot].set(new.old_cov, mode="drop"),
        slot_idx=state.slot_idx.at[sidx].set(new.slot_idx, mode="drop"),
        rot_count=state.rot_count.at[sidx].set(new.rot_count, mode="drop"),
        cur_sum=state.cur_sum.at[sidx].set(new.cur_sum, mode="drop"),
        cur_count=state.cur_count.at[sidx].set(new.cur_count, mode="drop"),
        cur_m2=state.cur_m2.at[sidx].set(new.cur_m2, mode="drop"),
        **extra,
    )


def snapshot(state: NdtMapState, cfg: MapConfig) -> MapSnapshot:
    """World-frame Gaussians for solving (decouples the heavy window state
    from what the hot loop reads)."""
    centers = cell_centers(cfg, state.mean_c.dtype)
    return MapSnapshot(
        mean=centers + state.mean_c, inv_cov=state.inv_cov, built=state.built
    )


def smooth_snapshot(snap: MapSnapshot, sigma: float) -> MapSnapshot:
    """Covariance-inflated snapshot for coarse-to-fine matching.

    Map Gaussians are razor-thin across surfaces (the eigenvalue
    regularization `ndtcell.cpp:93-111` floors λmin at 0.001·λmax, ~1 cm for
    wall cells), so the exact cost basin is centimetres wide — fine for
    scan-to-scan tracking, hopeless for a coarse relocalization sweep.
    Adding σ²·I to every cell covariance (Σ' = Σ + σ²I, recomputed from the
    packed inverse in closed 2x2 form) widens each basin to ≳σ without moving
    its optimum, the standard coarse-to-fine NDT trick.
    """
    a, b, c = snap.inv_cov[..., 0], snap.inv_cov[..., 1], snap.inv_cov[..., 2]
    det = a * c - b * b  # det of Λ = 1/det(Σ)
    ok = det > 1e-20
    safe = jnp.where(ok, det, 1.0)
    s2 = jnp.asarray(sigma * sigma, snap.inv_cov.dtype)
    ca = c / safe + s2  # Σ' entries (Σ = adj(Λ)/det(Λ) for 2x2 symmetric)
    cb = -b / safe
    cc = a / safe + s2
    d2 = ca * cc - cb * cb
    icov = jnp.stack([cc / d2, -cb / d2, ca / d2], axis=-1)
    return MapSnapshot(mean=snap.mean, inv_cov=icov, built=snap.built & ok)


def reset(state: NdtMapState) -> NdtMapState:
    """Full zero reset.

    The reference's `NDTCell::reset` (`ndtcell.cpp:80-91`) zeroes the window
    but leaves `built`/`created` and the stale Gaussian in place — an API that
    is never exercised by the node (`ndtpso_slam_node.cpp:227-230` reallocates
    instead).  We diverge deliberately: reset means a fresh map.
    """
    zeroed = jax.tree_util.tree_map(lambda x: jnp.zeros_like(x), state)
    # Sparse indirection resets to UNASSIGNED (-1), not row 0.
    return zeroed.replace(ring_map=jnp.full_like(state.ring_map, -1))
