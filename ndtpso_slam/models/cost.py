"""NDT registration cost: exact gather form and matmul frozen-correspondence form.

The reference cost (`cost_function`, `core.cpp:26-48`) transforms every scan
point by a candidate pose, floor-bins it into the reference map, and subtracts
the cell's unnormalized Gaussian score.  Two formulations live here:

* :func:`ndt_cost` — *exact* semantics: per-pose transform + bin + gather +
  score.  Vectorized over arbitrary leading pose batch dims.  This is the
  parity path against the C++ reference and the truth oracle for the fast
  path.

* :func:`bind_points` / :func:`bound_cost` — the *fast* path.  Once per PSO
  iteration the scan is bound to map cells at a single binding pose (the
  current global best); the per-particle cost then becomes a quadratic form
  in ``u = [cos(dθ)-1, sin(dθ), dt_x, dt_y, 1]`` relative to the binding
  pose:

      d = R(dθ)·g + (R(dθ)-I)·(t₀-μ) + dt   with  g = R₀p + t₀ - μ
      d' Λ d = u' (Bᵀ Λ B) u = ⟨φ(u), w⟩,   φ(u) = 15 monomials of u

  so scoring P particles against N points is one ``[P,15] @ [15,N]`` matmul
  followed by ``exp`` and a masked row-sum — no per-particle gathers at
  all.  The ``cos(dθ)-1`` parameterization keeps every B-column O(sensor
  range · dθ) instead of O(range), so float32 loses nothing to cancellation.

  Freezing correspondences for one iteration is the classic NDT/ICP move (the
  cost landscape is re-linearized around the incumbent); near convergence the
  binding is self-consistent and the optimum agrees with the exact cost — the
  parity suite checks this statistically.  `pso_solve` itself reports the
  cost under the final frozen binding; the SLAM loop (`models/slam.py:align`)
  re-scores the returned pose with :func:`ndt_cost` so downstream consumers
  of the per-scan cost always see the exact value.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ndtpso_slam.utils.pytree import PyTreeNode, field

from ndtpso_slam.config import MapConfig
from ndtpso_slam.models.ndt_map import MapSnapshot
from ndtpso_slam.ops import gaussian
from ndtpso_slam.ops.geometry import cell_coords, cell_index, transform_points


def ndt_cost(
    pose: jnp.ndarray,
    snap: MapSnapshot,
    points: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: MapConfig,
) -> jnp.ndarray:
    """Exact reference cost (`core.cpp:26-48`).

    pose: [..., 3]; points: [N, 2]; valid: [N].  Returns [...].
    """
    q = transform_points(points, pose)  # [..., N, 2]
    idx, inb = cell_index(
        q, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )
    mean = snap.mean[idx]  # [..., N, 2]
    icov = snap.inv_cov[idx]
    built = snap.built[idx]
    score = gaussian.ndt_score(q - mean, icov, built & inb & valid)
    return -jnp.sum(score, axis=-1)


class BoundScan(PyTreeNode):
    """Scan bound to map cells at a binding pose: per-point quadratic-form
    coefficients ``w`` s.t. d'Λd = φ(u)·w, plus the score mask."""

    bind_pose: jnp.ndarray  # [3]
    w: jnp.ndarray  # [N, 15]
    mask: jnp.ndarray  # [N] float (valid & in-bounds & built at binding)


# Full float32 for every contraction here: the one-hot selections must
# return the selected row bit-for-bit, and the quadratic forms score
# Gaussians ~1 cm thin at map coordinates of ~100 m.  A GPU runs a default-
# precision float32 dot in TF32 (~11 significant bits).
_EXACT = jax.lax.Precision.HIGHEST

# Index pairs (a<=b) of the 15 monomials u_a u_b for u in R^5.
_IJ = [(a, b) for a in range(5) for b in range(a, 5)]

# Default ±cells covered by the stencil ('fast_local'/'rollout') binding.
DEFAULT_STENCIL_RADIUS = 2


def bind_points(
    bind_pose: jnp.ndarray,
    snap: MapSnapshot,
    points: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: MapConfig,
) -> BoundScan:
    """Bind each scan point to its map cell at ``bind_pose`` and precompute
    quadratic-form coefficients.  O(N) gathers, once per iteration."""
    q0 = transform_points(points, bind_pose)  # [N, 2] = R₀p + t₀
    idx, inb = cell_index(
        q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )
    mean = snap.mean[idx]
    icov = snap.inv_cov[idx]  # [N, 3] packed Λ
    mask = (snap.built[idx] & inb & valid).astype(points.dtype)
    return _quadform_bound(bind_pose, points, mean, icov, mask)


def _quadform_bound(
    bind_pose: jnp.ndarray,
    points: jnp.ndarray,
    mean: jnp.ndarray,  # [N, 2] per-point cell mean
    icov: jnp.ndarray,  # [N, 3] per-point packed Λ
    mask: jnp.ndarray,  # [N] float
) -> BoundScan:
    """Quadratic-form coefficient build shared by the gather and stencil
    binding paths (the math below `core.cpp:37-43`, re-parameterized)."""
    c0 = jnp.cos(bind_pose[2])
    s0 = jnp.sin(bind_pose[2])
    rx = points[:, 0] * c0 - points[:, 1] * s0  # R₀p
    ry = points[:, 0] * s0 + points[:, 1] * c0
    gx = rx + bind_pose[0] - mean[:, 0]  # g = R₀p + t₀ - μ  (residual, small)
    gy = ry + bind_pose[1] - mean[:, 1]

    # d = B u with u = [cosδ-1, sinδ, δtx, δty, 1]:
    #   d_x = (cosδ-1)·rx − sinδ·ry + δtx + gx
    #   d_y = (cosδ-1)·ry + sinδ·rx + δty + gy
    zeros = jnp.zeros_like(gx)
    ones = jnp.ones_like(gx)
    bx = jnp.stack([rx, -ry, ones, zeros, gx], axis=-1)  # [N, 5]
    by = jnp.stack([ry, rx, zeros, ones, gy], axis=-1)

    # M = BᵀΛB with Λ = [[la, lb], [lb, lc]] packed; w_ab = M_ab·(2-δ_ab).
    la, lb, lc = icov[:, 0], icov[:, 1], icov[:, 2]
    lbx = la[:, None] * bx + lb[:, None] * by  # Λ @ B rows, [N, 5]
    lby = lb[:, None] * bx + lc[:, None] * by
    w_cols = []
    for a, b in _IJ:
        m_ab = bx[:, a] * lbx[:, b] + by[:, a] * lby[:, b]
        w_cols.append(m_ab if a == b else 2.0 * m_ab)
    w = jnp.stack(w_cols, axis=-1)  # [N, 15]
    # Mask folded into w: a masked point contributes exp(-0)·0 via the mask
    # vector in bound_cost, but zeroing w too keeps exp() arguments finite
    # even where Λ was inf/nan from degenerate cells.
    w = jnp.where(mask[:, None] > 0, w, 0.0)
    return BoundScan(bind_pose=bind_pose, w=w, mask=mask)


def snapshot_table(snap: MapSnapshot, dtype=jnp.float32) -> jnp.ndarray:
    """Pack a snapshot into one [C, 6] table (mean, icov, built) — the
    gatherable/matmul-able form shared by the stencil and matmul binders."""
    return jnp.concatenate(
        [
            snap.mean.astype(dtype),
            snap.inv_cov.astype(dtype),
            snap.built.astype(dtype)[:, None],
        ],
        axis=-1,
    )


def bind_points_matmul(
    bind_pose: jnp.ndarray,
    tbl: jnp.ndarray,  # [C, 6] from snapshot_table
    points: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: MapConfig,
) -> BoundScan:
    """Gather-free binding for small maps: a one-hot [N, C] matmul replaces
    the per-row gather of :func:`bind_points`.

    A binding that re-runs every PSO iteration over K swarms pays K·iters
    [N]-row gathers (the multi-swarm relocalization profile).  Selecting
    each point's cell row as ``onehot([N, C]) @ tbl([C, 6])`` instead is one
    matmul — the iota compare fuses into the operand.  Exact: each one-hot
    row has a single nonzero, so the full-f32 accumulation (``HIGHEST``;
    TF32 would round the row) reproduces the gathered row bit-for-bit.  Work is O(N·C), the right trade only while C stays
    small (relocalization maps, ≤ ~16k cells); the SLAM map default
    (360k cells) should keep the stencil/gather paths.
    """
    q0 = transform_points(points, bind_pose)
    idx, inb = cell_index(
        q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )
    c = tbl.shape[0]
    onehot = (
        idx[:, None] == jnp.arange(c, dtype=idx.dtype)[None, :]
    ).astype(points.dtype)  # [N, C]
    g = jnp.dot(onehot, tbl, precision=_EXACT,
                preferred_element_type=points.dtype)  # [N, 6]
    mean, icov = g[:, 0:2], g[:, 2:5]
    mask = ((g[:, 5] > 0.5) & inb & valid).astype(points.dtype)
    return _quadform_bound(bind_pose, points, mean, icov, mask)


def bind_points_matmul_window(
    bind_pose: jnp.ndarray,
    patch_tbl: jnp.ndarray,  # [ps*ps, 6] dynamic-sliced window of snapshot_table
    origin: Tuple[jnp.ndarray, jnp.ndarray],  # (ox, oy) cell coords of patch corner
    ps: int,
    points: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: MapConfig,
) -> BoundScan:
    """:func:`bind_points_matmul` against a ``ps × ps`` cell *window* of the
    map instead of the full [C] table.

    The one-hot matmul binder's work is O(N·C); exactly right at
    relocalization-map sizes (≤ ~16k cells) but a 553 MB/rebind wall at the
    reference's 360k-cell deployment default.  A relocalization only ever
    looks near the last trusted pose (hypotheses within ``recovery.spread``,
    beams within sensor range), so the binder's world is a window: points
    are binned in GLOBAL grid coordinates and shifted by the window origin,
    so selected rows are bit-identical to the full-table binder; a point
    outside the window scores 0, the same no-information convention as
    leaving the map (`core.cpp:38-43`).

    ``patch_tbl`` comes from ``jax.lax.dynamic_slice`` of the [W, W, 6]
    table view; ``origin`` is its (column, row) cell corner.
    """
    ox, oy = origin
    q0 = transform_points(points, bind_pose)
    ix, iy, inb = cell_coords(
        q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m
    )
    lx = ix - ox
    ly = iy - oy
    in_patch = (lx >= 0) & (lx < ps) & (ly >= 0) & (ly < ps)
    li = jnp.where(in_patch, ly * ps + lx, ps * ps)  # sentinel -> zero row
    onehot = (
        li[:, None] == jnp.arange(ps * ps, dtype=li.dtype)[None, :]
    ).astype(points.dtype)  # [N, ps²] (fuses into the matmul operand)
    g = jnp.dot(onehot, patch_tbl, precision=_EXACT,
                preferred_element_type=points.dtype)
    mean, icov = g[:, 0:2], g[:, 2:5]
    mask = ((g[:, 5] > 0.5) & inb & valid & in_patch).astype(points.dtype)
    return _quadform_bound(bind_pose, points, mean, icov, mask)


class NeighborhoodBind(PyTreeNode):
    """Per-point stencil of map cells around an anchor pose.

    This pre-gathers, ONCE per solve, the (2r+1)² neighborhood of each
    point's anchor cell.  Per-iteration rebinding then selects within the
    stencil with pure elementwise compare/select arithmetic — zero gathers
    in the hot loop.

    Exact within range: as long as the binding pose keeps every point
    within ±r cells of its anchor cell, the selected statistics are
    bit-identical to :func:`bind_points`.  A point pushed outside its
    stencil scores 0 — the same "no information" behavior the reference
    gives points that leave the map or hit an unbuilt cell
    (`core.cpp:38-43`); the solve-level parity tests quantify this.
    """

    anchor_ix: jnp.ndarray  # [N] int32 column of the anchor cell
    anchor_iy: jnp.ndarray  # [N] int32 row
    mean: jnp.ndarray  # [N, K2, 2]
    icov: jnp.ndarray  # [N, K2, 3]
    built: jnp.ndarray  # [N, K2] bool (cell built AND neighbor inside grid)
    valid: jnp.ndarray  # [N] bool
    radius: int = field(static=True, default=2)


# Above this cell count the O(C) stencil-table roll gives way to the direct
# [N·K2]-row gather (row count independent of C).  The threshold sits just
# above the relocalization-map class (4096 cells), where the roll's table
# is ~100 KB.  It was set on the previous accelerator and is not yet
# re-measured on the GPU (ROADMAP D8).
GATHER_BIND_MIN_CELLS = 8192


def bind_neighborhood(
    anchor_pose: jnp.ndarray,
    snap: MapSnapshot,
    points: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: MapConfig,
    radius: int = 2,
    strategy: str = "auto",
) -> NeighborhoodBind:
    """Gather each point's (2r+1)² cell stencil at the anchor pose (the PSO
    initial guess).  One batched gather per solve, amortized over all
    iterations.

    Three strategies, identical results (`built` and every built lane's
    statistics are bit-equal; unbuilt lanes hold strategy-dependent finite
    garbage that every consumer masks):

    * ``'roll'`` — pre-roll the packed [C, 6] table by every stencil offset
      and gather N wide rows: one N-row gather, but O(C) table traffic —
      the right trade on small maps.
    * ``'gather'`` — gather the [N, K2] neighbor rows directly (clipped at
      the border; `in_grid` masks the clipped lanes): 25x the rows but no
      O(C) roll — the trade at the 360k-cell deployment scale.
    * ``'auto'`` (default) — 'gather' beyond ``GATHER_BIND_MIN_CELLS``
      (unless a stencil patch is configured), else 'roll'.

    With ``cfg.stencil_patch_cells`` set (> 0), the rolled stencil table is
    built over a ``patch × patch`` `dynamic_slice` of the grid centred on
    the anchor pose instead of the full [C] table: at the reference's
    deployment scale (360k cells) the full rolled table is 216 MB of HBM
    traffic per solve, while a scan only ever spans ``2·range_max/cell_side``
    cells (120 at the defaults) — a 128-cell patch is ~600 KB.  A point (or
    stencil neighbor) falling outside the patch scores 0, identical to the
    out-of-map convention, so results match the full-table path exactly
    whenever the patch covers the scan (`tests/test_cost.py`).
    """
    dtype = points.dtype
    w_cells = cfg.cells_per_side
    q0 = transform_points(points, anchor_pose)  # [N, 2]
    ix, iy, _ = cell_coords(q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m)
    side = 2 * radius + 1
    offs = np.arange(-radius, radius + 1, dtype=np.int32)
    di = np.tile(offs, side)  # [K2] column offsets, row-major stencil
    dj = np.repeat(offs, side)
    nix = ix[:, None] + jnp.asarray(di)[None, :]  # [N, K2]
    niy = iy[:, None] + jnp.asarray(dj)[None, :]
    in_grid = (nix >= 0) & (nix < w_cells) & (niy >= 0) & (niy < w_cells)
    # A point whose ANCHOR cell is outside the grid is out-of-map at the
    # anchor pose: its whole stencil is treated as unbuilt (score 0, the
    # out-of-map convention).  Without this the two strategies disagreed
    # at the frame border — the roll reads neighbors relative to the
    # CLIPPED anchor row (wrong cells), the gather reads true clipped
    # neighbors — and results depended on the strategy switch.
    anchor_in = (ix >= 0) & (ix < w_cells) & (iy >= 0) & (iy < w_cells)
    in_grid = in_grid & anchor_in[:, None]
    if strategy == "auto":
        strategy = (
            "gather"
            if cfg.num_cells > GATHER_BIND_MIN_CELLS
            and not (0 < cfg.stencil_patch_cells < w_cells)
            else "roll"
        )
    if strategy == "gather":
        tbl = snapshot_table(snap, dtype)  # [C, 6]
        flat = jnp.clip(niy, 0, w_cells - 1) * w_cells + jnp.clip(
            nix, 0, w_cells - 1
        )
        g = tbl[flat]  # [N, K2, 6]
        return NeighborhoodBind(
            anchor_ix=ix,
            anchor_iy=iy,
            mean=g[..., 0:2],
            icov=g[..., 2:5],
            built=(g[..., 5] > 0.5) & in_grid,
            valid=valid,
            radius=radius,
        )

    # Gathering [N, K2] separate 8-32 B rows is ~75x more rows than one
    # wide row per point.  Instead: pack (mean, icov, built) into one [C, 6] table, pre-roll it by
    # each stencil offset ([C, K2, 6], pure shifts), and gather N rows of
    # K2*6 floats — one wide gather per solve.  Rolls wrap across grid rows
    # and borders; every wrapped entry has ``in_grid`` False there, which
    # forces ``built`` False, so wrapped statistics are never read.
    tbl = snapshot_table(snap, dtype)  # [C, 6]
    ps = cfg.stencil_patch_cells
    if 0 < ps < w_cells:
        # Patch origin: anchor-pose cell minus half the patch, clamped so the
        # patch stays inside the grid.
        cx, cy, _ = cell_coords(
            anchor_pose[..., :2], size_m=cfg.size_m, cell_side_m=cfg.cell_side_m
        )
        ox = jnp.clip(cx - ps // 2, 0, w_cells - ps)
        oy = jnp.clip(cy - ps // 2, 0, w_cells - ps)
        patch = jax.lax.dynamic_slice(
            tbl.reshape(w_cells, w_cells, 6), (oy, ox, 0), (ps, ps, 6)
        ).reshape(ps * ps, 6)
        ix_l, iy_l = ix - ox, iy - oy
        in_patch = (
            (nix - ox >= 0) & (nix - ox < ps) & (niy - oy >= 0) & (niy - oy < ps)
        )
        in_grid = in_grid & in_patch
        tbl, w_roll = patch, ps
        bx, by = jnp.clip(ix_l, 0, ps - 1), jnp.clip(iy_l, 0, ps - 1)
    else:
        w_roll = w_cells
        bx, by = jnp.clip(ix, 0, w_cells - 1), jnp.clip(iy, 0, w_cells - 1)
    flat_off = dj * w_roll + di  # [K2] numpy, static
    rolled = jnp.stack(
        [jnp.roll(tbl, -int(o), axis=0) for o in flat_off], axis=1
    )  # [C or ps², K2, 6]
    g = rolled[bx + w_roll * by]  # [N, K2, 6] — single N-row gather
    return NeighborhoodBind(
        anchor_ix=ix,
        anchor_iy=iy,
        mean=g[..., 0:2],
        icov=g[..., 2:5],
        built=(g[..., 5] > 0.5) & in_grid,
        valid=valid,
        radius=radius,
    )


def bind_points_local(
    bind_pose: jnp.ndarray,
    nbr: NeighborhoodBind,
    points: jnp.ndarray,
    cfg: MapConfig,
) -> BoundScan:
    """Gather-free per-iteration rebinding against a pre-gathered stencil.

    Selects each point's cell at ``bind_pose`` from its stencil by offset
    arithmetic; bit-identical to :func:`bind_points` while offsets stay
    within ±radius (the one-hot select adds only zeros to the chosen
    entry)."""
    dtype = points.dtype
    r = nbr.radius
    side = 2 * r + 1
    k2 = side * side
    q0 = transform_points(points, bind_pose)
    jx, jy, inb = cell_coords(q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m)
    di = jx - nbr.anchor_ix  # [N]
    dj = jy - nbr.anchor_iy
    in_stencil = (jnp.abs(di) <= r) & (jnp.abs(dj) <= r)
    k = (dj + r) * side + (di + r)  # row-major, matches bind_neighborhood
    sel = (jnp.arange(k2, dtype=jnp.int32)[None, :] == k[:, None]) & in_stencil[
        :, None
    ]  # [N, K2]
    onehot = sel.astype(dtype)
    mean = jnp.sum(nbr.mean * onehot[..., None], axis=1)  # [N, 2]
    icov = jnp.sum(nbr.icov * onehot[..., None], axis=1)  # [N, 3]
    built = jnp.any(nbr.built & sel, axis=1)
    mask = (built & inb & nbr.valid).astype(dtype)
    return _quadform_bound(bind_pose, points, mean, icov, mask)


def stencil_exact_cost(
    poses: jnp.ndarray,  # [P, 3]
    nbr: NeighborhoodBind,
    points: jnp.ndarray,  # [N, 2]
    cfg: MapConfig,
) -> jnp.ndarray:  # [P]
    """Exact per-PARTICLE correspondence, gather-free: every particle re-bins
    every point against the pre-gathered stencil each evaluation.

    The frozen-correspondence costs (:func:`bind_points` /
    :func:`bind_points_local`) bind once per iteration at the incumbent
    pose; with small cells (the reference's 0.5 m default) and thin
    single-scan Gaussians, particles then get scored by extrapolating a
    stale cell's quadratic well past its borders — which breaks
    sequential-SLAM tracking at cell_side 0.5 m (bench.py's SLAM gate).  Here the one-hot stencil
    select runs per (particle, point), so the selected statistics — and the
    resulting cost — are IDENTICAL to :func:`ndt_cost` whenever the point
    stays within ±radius cells of its anchor (beyond it scores 0, the same
    no-information convention as leaving the map, `core.cpp:38-43`).

    Work is O(P·N·K2) elementwise compare/FMA with no dynamic gathers: the right
    trade for solve-loop populations (the reference's 30-50); the
    frozen-binding matmul forms stay the throughput path for the
    4096-particle batch workloads where deviations are small relative to
    the cell side.
    """
    dtype = points.dtype
    r = nbr.radius
    side = 2 * r + 1
    k2 = side * side
    q = transform_points(points, poses)  # [P, N, 2]
    jx, jy, inb = cell_coords(q, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m)
    di = jx - nbr.anchor_ix[None, :]  # [P, N]
    dj = jy - nbr.anchor_iy[None, :]
    in_st = (jnp.abs(di) <= r) & (jnp.abs(dj) <= r)
    k = (dj + r) * side + (di + r)  # [P, N] row-major, as bind_neighborhood
    sel = (
        jnp.arange(k2, dtype=jnp.int32)[None, None, :] == k[:, :, None]
    ) & in_st[:, :, None]  # [P, N, K2]
    onehot = sel.astype(dtype)
    mean = jnp.einsum("pnk,nkc->pnc", onehot, nbr.mean, precision=_EXACT)
    icov = jnp.einsum("pnk,nkc->pnc", onehot, nbr.icov, precision=_EXACT)
    built = jnp.any(sel & nbr.built[None, :, :], axis=-1)  # [P, N]
    score = gaussian.ndt_score(
        q - mean, icov, built & inb & nbr.valid[None, :]
    )
    return -jnp.sum(score, axis=-1)


def _phi(u: jnp.ndarray) -> jnp.ndarray:
    """Monomial features u_a·u_b (a<=b): [..., 5] -> [..., 15]."""
    return jnp.stack([u[..., a] * u[..., b] for a, b in _IJ], axis=-1)


def bound_cost(poses: jnp.ndarray, bound: BoundScan) -> jnp.ndarray:
    """Score pose batch against a bound scan: one matmul + exp + matvec.

    poses: [P, 3] absolute poses.  Returns [P] costs.
    """
    dtheta = poses[:, 2] - bound.bind_pose[2]
    u = jnp.stack(
        [
            jnp.cos(dtheta) - 1.0,
            jnp.sin(dtheta),
            poses[:, 0] - bound.bind_pose[0],
            poses[:, 1] - bound.bind_pose[1],
            jnp.ones_like(dtheta),
        ],
        axis=-1,
    )  # [P, 5]
    z = jnp.dot(_phi(u), bound.w.T, precision=_EXACT,
                preferred_element_type=poses.dtype)  # [P, N]
    # Clamp at 0: regularized inverses of near-degenerate cells can carry a
    # numerically negative eigenvalue; harmless in the exact cost (the point
    # is inside its cell, |z| tiny) but explosive when a far-flung particle
    # extrapolates the frozen quadratic.  Scores stay in (0, 1].
    score = jnp.exp(-0.5 * jnp.maximum(z, 0.0))
    return -jnp.dot(score, bound.mask, precision=_EXACT,
                    preferred_element_type=poses.dtype)


def pose_features(poses: jnp.ndarray, bind_pose: jnp.ndarray) -> jnp.ndarray:
    """phi(u) monomials for poses relative to a binding pose.

    poses: [..., P, 3]; bind_pose: [..., 3] -> [..., P, 15].
    """
    dtheta = poses[..., 2] - bind_pose[..., None, 2]
    u = jnp.stack(
        [
            jnp.cos(dtheta) - 1.0,
            jnp.sin(dtheta),
            poses[..., 0] - bind_pose[..., None, 0],
            poses[..., 1] - bind_pose[..., None, 1],
            jnp.ones_like(dtheta),
        ],
        axis=-1,
    )
    return _phi(u)
