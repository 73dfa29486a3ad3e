"""Occupancy raster: incremental touched-cell updates == dense full pass.

`og_update_incremental` (used by `slam_step`) must reproduce `og_update`
bit-for-bit over any ingestion sequence — a parent cell's Gaussian only
changes when points land in it, so refreshing touched blocks is exact.
"""

import numpy as np
import jax.numpy as jnp

from ndtpso_slam import config as cfgm
from ndtpso_slam.models import ndt_map, occupancy
from ndtpso_slam.ops.geometry import cell_index

MAP_CFG = cfgm.MapConfig(size_m=24.0, cell_side_m=1.0, window_slots=4,
                         slot_capacity=10)
OG_CFG = cfgm.OccupancyGridConfig(cell_size_m=0.25, enabled=True)


def test_incremental_og_matches_dense():
    rs = np.random.RandomState(7)
    state = ndt_map.init_map(MAP_CFG)
    og_dense = occupancy.init_og(MAP_CFG, OG_CFG)
    og_inc = occupancy.init_og(MAP_CFG, OG_CFG)

    for step in range(6):
        # Clustered points so cells accumulate enough for builds + rotations.
        centers = rs.uniform(-10, 10, (5, 2))
        pts = (centers[rs.randint(0, 5, 64)] + rs.normal(0, 0.4, (64, 2))
               ).astype(np.float32)
        valid = rs.rand(64) > 0.1
        state = ndt_map.add_points(state, MAP_CFG, pts, valid)
        state = ndt_map.build(state, MAP_CFG)

        og_dense = occupancy.og_update(og_dense, state, MAP_CFG, OG_CFG)
        idx, inb = cell_index(
            jnp.asarray(pts), size_m=MAP_CFG.size_m,
            cell_side_m=MAP_CFG.cell_side_m,
            cells_per_side=MAP_CFG.cells_per_side,
        )
        ids = jnp.where(jnp.asarray(valid) & inb, idx, MAP_CFG.num_cells)
        og_inc = occupancy.og_update_incremental(
            og_inc, state, MAP_CFG, OG_CFG, ids
        )

        np.testing.assert_array_equal(
            np.asarray(og_inc.og), np.asarray(og_dense.og),
            err_msg=f"raster diverged at step {step}",
        )
    for f in ("min_x", "max_x", "min_y", "max_y"):
        assert int(getattr(og_inc, f)) == int(getattr(og_dense, f)), f
    assert int(np.count_nonzero(np.asarray(og_inc.og))) > 0


def test_incremental_og_skips_unbuilt_and_out_of_range():
    state = ndt_map.init_map(MAP_CFG)
    og = occupancy.init_og(MAP_CFG, OG_CFG)
    # Two points in one cell: created but count <= 2 => not built.
    pts = np.float32([[1.2, 1.2], [1.3, 1.25]])
    state = ndt_map.add_points(state, MAP_CFG, pts, np.ones(2, bool))
    state = ndt_map.build(state, MAP_CFG)
    idx, _ = cell_index(
        jnp.asarray(pts), size_m=MAP_CFG.size_m,
        cell_side_m=MAP_CFG.cell_side_m, cells_per_side=MAP_CFG.cells_per_side,
    )
    ids = jnp.concatenate([idx, jnp.asarray([MAP_CFG.num_cells, -3], jnp.int32)])
    out = occupancy.og_update_incremental(og, state, MAP_CFG, OG_CFG, ids)
    assert int(np.count_nonzero(np.asarray(out.og))) == 0
    assert int(out.min_x) == int(og.min_x)  # bbox untouched
