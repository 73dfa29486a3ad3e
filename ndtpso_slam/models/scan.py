"""Laser-scan ingestion: fixed-shape padded point sets with validity masks.

Replicates `NDTFrame::loadLaser` (`ndtframe.cpp:144-185`): per-beam range
filtering, polar->cartesian conversion, and the optional latched sensor-mount
transform (`TRANSFORM_POINTS_AT_LOAD`, `config.h:9`).  Variable beam counts
become a static ``max_beams`` axis plus a mask — the shape never changes under
``jit``, and whole scan logs batch as ``[T, N, 2]``.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from ndtpso_slam.utils.pytree import PyTreeNode

from ndtpso_slam.config import MapConfig, ScanConfig
from ndtpso_slam.ops.geometry import index_to_angle, polar_to_point, transform_points


class Scan(PyTreeNode):
    points: jnp.ndarray  # [N, 2] cartesian points in the base frame
    valid: jnp.ndarray  # [N] bool


def _frontal_keep_mask(theta: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """`PREFER_FRONTAL_POINTS` beam decimation (`ndtframe.cpp:157-182`,
    compile-time OFF upstream, `config.h:11`).

    Reference semantics, exactly: walk the beams in order, accumulating
    ``Δθ += cos(θ)`` over VALID beams only (invalid beams leave the
    accumulator untouched); a beam is KEPT when the accumulated |Δθ|
    exceeds 0.5, which resets the accumulator.  Frontal beams
    (|cos θ| ≈ 1) pass every time; side-looking beams (|cos θ| ≈ 0) are
    decimated roughly 1-in-⌈0.5/|cos θ|⌉.  The running reset makes this a
    sequential threshold-accumulator, not a cumsum — one tiny [N]
    `lax.scan` at load time (load runs per scan on the host path; the hot
    loops never see it).  f32 accumulation mirrors the reference's
    ``float delta_theta``."""
    import jax

    c = jnp.cos(theta).astype(jnp.float32)

    def step(delta, inp):
        v, ci = inp
        d = delta + jnp.where(v, ci, 0.0)
        keep = v & (jnp.abs(d) > 0.5)
        return jnp.where(keep, 0.0, d), keep

    _, keep = jax.lax.scan(step, jnp.float32(0.0), (valid, c))
    return keep


def load_laser(
    ranges: jnp.ndarray,
    angle_min,
    angle_increment,
    range_max,
    cfg: ScanConfig,
    map_cfg: Optional[MapConfig] = None,
    mount: Optional[jnp.ndarray] = None,
    dtype=jnp.float32,
) -> Scan:
    """Convert raw ranges to a masked cartesian point set.

    Args:
      ranges: [N] beam ranges, padded with zeros (zero is always invalid,
        matching the ``> 0`` filter at `ndtframe.cpp:165`).
      angle_min / angle_increment / range_max: scan metadata
        (`sensor_msgs/LaserScan` fields used at `ndtpso_slam_node.cpp:186`).
      map_cfg: if given, points outside the frame borders are invalidated —
        the reference drops them at `NDTFrame::addPoint`
        (`ndtframe.cpp:220-223`), so they never reach the cost function.
      mount: optional [3] base<-scan transform applied at load
        (`ndtframe.cpp:174-177`).
    """
    ranges = jnp.asarray(ranges, dtype)
    n = ranges.shape[-1]
    assert n <= cfg.max_beams, f"scan has {n} beams > max_beams={cfg.max_beams}"
    if n < cfg.max_beams:
        ranges = jnp.pad(ranges, [(0, 0)] * (ranges.ndim - 1) + [(0, cfg.max_beams - n)])
    valid = (
        (ranges > 0.0) & (ranges < range_max) & (ranges > cfg.ignore_epsilon)
    )
    idx = jnp.arange(cfg.max_beams, dtype=dtype)
    theta = index_to_angle(idx, jnp.asarray(angle_increment, dtype), jnp.asarray(angle_min, dtype))
    if cfg.prefer_frontal_points:
        valid = valid & _frontal_keep_mask(theta, valid)
    points = polar_to_point(ranges, theta)
    if mount is not None:
        mount = jnp.asarray(mount, dtype)
        points = jnp.where(
            jnp.any(jnp.abs(mount) > 1e-6), transform_points(points, mount), points
        )
    if map_cfg is not None:
        half = map_cfg.half_size_m
        x, y = points[..., 0], points[..., 1]
        valid = valid & (x > -half) & (x < half) & (y > -half) & (y < half)
    return Scan(points=points, valid=valid)
