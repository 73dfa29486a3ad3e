"""Distributed map-statistics merges over the device mesh.

The reference has no distributed backend at all — inter-node communication is
ROS TCP pub/sub and each node owns a private map (SURVEY.md §2).  The
capability this enables: several devices ingest different scans (different
robots / different scan shards) into one *replicated* NDT map and merge
statistics with `psum` over the device mesh.

This is exact, not approximate: `add_points` only touches the *additive*
open-slot accumulators (`cur_sum`, `cur_count`, `cur_m2`) plus the boolean
`created`/`built` flags, so simultaneous multi-device updates commute —
psum of deltas + or/and of flags reproduces any serial ingestion order of the
same points up to float addition order.  The (order-dependent) window build
then runs identically on every device from the merged state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ndtpso_slam.config import MapConfig
from ndtpso_slam.models import ndt_map


def sharded_update(
    state: ndt_map.NdtMapState,
    cfg: MapConfig,
    pose: jnp.ndarray,
    points: jnp.ndarray,
    valid: jnp.ndarray,
    axis_name: str,
) -> ndt_map.NdtMapState:
    """Ingest a per-device shard of points into a replicated map.

    Call inside `shard_map` with ``points``/``valid`` sharded over
    ``axis_name`` (and ``pose`` either replicated or per-device for
    multi-robot).  Returns the merged, replicated map state.
    """
    local = ndt_map.update(state, cfg, pose, points, valid)
    return merge_deltas(state, local, axis_name)


def merge_deltas(
    before: ndt_map.NdtMapState, after: ndt_map.NdtMapState, axis_name: str
) -> ndt_map.NdtMapState:
    """All-reduce the ingestion delta ``after - before`` across devices."""
    d_sum = jax.lax.psum(after.cur_sum - before.cur_sum, axis_name)
    d_count = jax.lax.psum(after.cur_count - before.cur_count, axis_name)
    d_m2 = jax.lax.psum(after.cur_m2 - before.cur_m2, axis_name)
    touched = jax.lax.psum(
        (after.created != before.created).astype(jnp.int32)
        | (after.built != before.built).astype(jnp.int32)
        | (d_count > 0).astype(jnp.int32),
        axis_name,
    ) > 0
    return before.replace(
        cur_sum=before.cur_sum + d_sum,
        cur_count=before.cur_count + d_count,
        cur_m2=before.cur_m2 + d_m2,
        created=before.created | touched,
        built=before.built & ~touched,
    )
