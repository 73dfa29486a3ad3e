"""SE(2) / polar geometry primitives, batched and pure.

Vectorized counterparts of the reference's inline helpers
(`include/ndtpso_slam/core.h:28-47`): everything operates on arrays with
arbitrary leading batch dimensions instead of single Eigen vectors, so the same
function serves one point, one scan, or a fleet of particle-transformed scans
under ``vmap``.
"""

from __future__ import annotations

import jax.numpy as jnp


def transform_points(points: jnp.ndarray, pose: jnp.ndarray) -> jnp.ndarray:
    """Rigid SE(2) transform of 2-D points (reference `core.h:28-31`).

    Args:
      points: [..., N, 2] points.
      pose: [..., 3] pose (x, y, theta); its batch dims broadcast against the
        points' batch dims *excluding* the point axis N (the N axis is added
        here), e.g. points [N,2] x pose [P,3] -> [P,N,2].

    Returns:
      [..., N, 2] transformed points R(theta) @ p + t.
    """
    c = jnp.cos(pose[..., 2])[..., None]
    s = jnp.sin(pose[..., 2])[..., None]
    px, py = points[..., 0], points[..., 1]
    x = px * c - py * s + pose[..., 0][..., None]
    y = px * s + py * c + pose[..., 1][..., None]
    return jnp.stack([x, y], axis=-1)


def index_to_angle(idx: jnp.ndarray, step, min_angle) -> jnp.ndarray:
    """Beam index -> bearing angle (reference `core.h:40-42`)."""
    return idx * step + min_angle


def polar_to_point(r: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    """Polar -> cartesian (reference `laser_to_point`, `core.h:45-47`)."""
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def origin_at(points: jnp.ndarray, cell_side: float) -> jnp.ndarray:
    """Snap points to their cell origin (reference `core.h:33-36`, unused
    upstream but part of the public helper surface)."""
    return jnp.floor(points / cell_side) * cell_side


def cell_index(
    points: jnp.ndarray, *, size_m: float, cell_side_m: float, cells_per_side: int
):
    """Bin points into the origin-centred square grid.

    Replicates `NDTFrame::getCellIndex` (`ndtframe.cpp:240-249`): a point is
    in-bounds only strictly inside the frame borders, and the linear index is
    ``floor((x + w/2)/cell) + W * floor((y + h/2)/cell)``.

    Args:
      points: [..., 2].

    Returns:
      (index [...], in_bounds [...]) — int32 linear cell index (clipped to a
      valid range for safe gathering; mask with ``in_bounds``) and bool mask.
    """
    half = size_m / 2.0
    x, y = points[..., 0], points[..., 1]
    inb = (x > -half) & (x < half) & (y > -half) & (y < half)
    ix = jnp.floor((x + half) / cell_side_m).astype(jnp.int32)
    iy = jnp.floor((y + half) / cell_side_m).astype(jnp.int32)
    idx = ix + cells_per_side * iy
    idx = jnp.clip(idx, 0, cells_per_side * cells_per_side - 1)
    return idx, inb


def cell_coords(points: jnp.ndarray, *, size_m: float, cell_side_m: float):
    """2-D (column, row) cell coordinates + strict-border in-bounds mask.

    Same binning formula as :func:`cell_index` (`ndtframe.cpp:240-249`) but
    keeps the unclipped per-axis integer coordinates — the form the
    stencil/neighborhood binding needs.

    Returns (ix [...], iy [...], in_bounds [...]).
    """
    half = size_m / 2.0
    x, y = points[..., 0], points[..., 1]
    inb = (x > -half) & (x < half) & (y > -half) & (y < half)
    ix = jnp.floor((x + half) / cell_side_m).astype(jnp.int32)
    iy = jnp.floor((y + half) / cell_side_m).astype(jnp.int32)
    return ix, iy, inb


def wrap_angle(theta: jnp.ndarray) -> jnp.ndarray:
    """Wrap angles to (-pi, pi]."""
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


def se2_compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Compose two SE(2) poses: result = a ∘ b (apply b, then a)."""
    c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = a[..., 0] + b[..., 0] * c - b[..., 1] * s
    y = a[..., 1] + b[..., 0] * s + b[..., 1] * c
    return jnp.stack([x, y, a[..., 2] + b[..., 2]], axis=-1)


def se2_inverse(a: jnp.ndarray) -> jnp.ndarray:
    """Inverse of an SE(2) pose."""
    c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = -(a[..., 0] * c + a[..., 1] * s)
    y = a[..., 0] * s - a[..., 1] * c
    return jnp.stack([x, y, -a[..., 2]], axis=-1)
