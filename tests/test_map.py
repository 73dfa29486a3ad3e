"""NDT map sliding-window semantics vs the literal per-cell oracle.

Exercises multiple update->build cycles, slot rotation (count > capacity),
and full window wrap-around with a tiny window, asserting the engine's dense
second-moment formulation reproduces the reference's raw-point math.
"""

import numpy as np
import pytest

from ndtpso_slam.config import MapConfig
from ndtpso_slam.models import ndt_map
from oracle import OracleFrame

CFG = MapConfig(size_m=16.0, cell_side_m=1.0, window_slots=4, slot_capacity=5)


def _compare(state, frame, atol=2e-4):
    snap = ndt_map.snapshot(state, CFG)
    mean = np.asarray(snap.mean)
    icov = np.asarray(snap.inv_cov)
    built = np.asarray(snap.built)
    for idx in range(CFG.num_cells):
        ocell = frame.cells.get(idx)
        expect_built = ocell.built if ocell else False
        assert built[idx] == expect_built, f"cell {idx} built mismatch"
        if expect_built:
            np.testing.assert_allclose(
                mean[idx], ocell.mean, atol=atol, err_msg=f"cell {idx} mean"
            )
            ref_icov = np.array(
                [ocell.inv_cov[0, 0], ocell.inv_cov[0, 1], ocell.inv_cov[1, 1]]
            )
            scale = max(1.0, np.abs(ref_icov).max())
            np.testing.assert_allclose(
                icov[idx] / scale, ref_icov / scale, atol=5e-3,
                err_msg=f"cell {idx} inv_cov",
            )


def _random_rounds(seed, n_rounds, pts_per_round, spread):
    rs = np.random.RandomState(seed)
    state = ndt_map.init_map(CFG)
    frame = OracleFrame(CFG.size_m, CFG.cell_side_m, CFG.window_slots, CFG.slot_capacity)
    for _ in range(n_rounds):
        # cluster points in a few cells so counts exceed capacity and rotate
        centers = rs.uniform(-6, 6, (3, 2))
        pts = (
            centers[rs.randint(0, 3, pts_per_round)]
            + rs.normal(0, spread, (pts_per_round, 2))
        )
        valid = rs.rand(pts_per_round) > 0.1
        state = ndt_map.add_points(
            state, CFG, pts.astype(np.float32), valid
        )
        for p, v in zip(pts, valid):
            if v:
                frame.add_point(p)
        state = ndt_map.build(state, CFG)
        frame.build()
    return state, frame


def test_single_round_build():
    state, frame = _random_rounds(0, 1, 40, 0.3)
    _compare(state, frame)


def test_multi_round_with_rotation():
    # 5 pts/slot capacity, 20+ pts/cell/round => rotation every round.
    state, frame = _random_rounds(1, 6, 60, 0.25)
    ids = {i: c.idx for i, c in frame.cells.items() if c.created}
    assert any(v > 0 for v in ids.values()), "expected slot rotation to occur"
    _compare(state, frame)


def test_window_wraparound_forgetting():
    # Hammer ONE cell with > slot_capacity points every round for more
    # rounds than the window has slots: the ring must rotate every round and
    # WRAP — the oldest slots actually evicted — matching the oracle.
    rs = np.random.RandomState(2)
    state = ndt_map.init_map(CFG)
    frame = OracleFrame(
        CFG.size_m, CFG.cell_side_m, CFG.window_slots, CFG.slot_capacity
    )
    n_rounds = 2 * CFG.window_slots
    for r in range(n_rounds):
        # A drifting cluster inside one cell: >capacity points per round.
        pts = np.float32([3.3, 3.3]) + rs.normal(
            0.1 * r / n_rounds, 0.12, (CFG.slot_capacity + 3, 2)
        ).astype(np.float32)
        state = ndt_map.add_points(state, CFG, pts, np.ones(len(pts), bool))
        for p in pts:
            frame.add_point(p)
        state = ndt_map.build(state, CFG)
        frame.build()
    _compare(state, frame)
    # The monotone rotation counter must show the ring went all the way
    # around (rot_count >= window_slots ⇔ eviction happened) — slot_idx
    # alone is mod-S and cannot distinguish wrap from first fill.
    rot = np.asarray(state.rot_count)
    assert rot.max() >= CFG.window_slots, f"never wrapped: max rot {rot.max()}"
    # And it must agree with slot_idx mod S for every cell.
    np.testing.assert_array_equal(
        np.asarray(state.slot_idx), rot % CFG.window_slots
    )
    # Eviction really forgot points: the window total is bounded by S slots,
    # while the cell saw n_rounds * (capacity + 3) points in all.
    gc = np.asarray(state.g_count)
    assert gc.max() < n_rounds * (CFG.slot_capacity + 3)


def test_out_of_bounds_points_dropped():
    state = ndt_map.init_map(CFG)
    pts = np.array([[100.0, 0.0], [0.0, -100.0], [7.9, 7.9], [8.1, 0.0]], np.float32)
    state = ndt_map.add_points(state, CFG, pts, np.ones(4, bool))
    assert int(np.asarray(state.cur_count).sum()) == 1  # only (7.9, 7.9)


def test_built_flag_needs_three_points():
    state = ndt_map.init_map(CFG)
    pts = np.array([[0.2, 0.2], [0.3, 0.3]], np.float32)
    state = ndt_map.add_points(state, CFG, pts, np.ones(2, bool))
    state = ndt_map.build(state, CFG)
    assert not bool(np.asarray(state.built).any())  # count 2 <= 2
    state = ndt_map.add_points(
        state, CFG, np.array([[0.25, 0.35]], np.float32), np.ones(1, bool)
    )
    state = ndt_map.build(state, CFG)
    assert bool(np.asarray(state.built).any())  # count 3 > 2


def test_idempotent_rebuild():
    state, _ = _random_rounds(3, 2, 40, 0.3)
    again = ndt_map.build(state, CFG)
    for a, b in zip(
        (state.mean_c, state.inv_cov, state.g_sum, state.g_count),
        (again.mean_c, again.inv_cov, again.g_sum, again.g_count),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_update_transforms_points():
    state = ndt_map.init_map(CFG)
    frame = OracleFrame(CFG.size_m, CFG.cell_side_m, CFG.window_slots, CFG.slot_capacity)
    rs = np.random.RandomState(4)
    pts = rs.uniform(-2, 2, (30, 2))
    pose = np.array([1.0, -0.5, 0.6])
    state = ndt_map.update(
        state, CFG, pose.astype(np.float32), pts.astype(np.float32), np.ones(30, bool)
    )
    state = ndt_map.build(state, CFG)
    frame.update(pose, pts)
    frame.build()
    _compare(state, frame)


def test_sparse_build_touched_matches_dense():
    """build_touched over the scan's cell ids is bit-identical to the dense
    build across multiple ingest->build rounds, slot rotations included
    (the invariant slam_step maintains: a build after every ingestion)."""
    from ndtpso_slam.ops.geometry import cell_index

    rs = np.random.RandomState(7)
    dense = ndt_map.init_map(CFG)
    sparse = ndt_map.init_map(CFG)
    prev_ids = np.full(40, CFG.num_cells, np.int32)
    for rnd in range(12):
        centers = rs.uniform(-6, 6, (3, 2))
        pts = (
            centers[rs.randint(0, 3, 40)] + rs.normal(0, 0.3, (40, 2))
        ).astype(np.float32)
        # include out-of-frame points and invalid beams
        pts[:4] += 40.0
        valid = rs.rand(40) > 0.15
        idx, inb = cell_index(
            pts, size_m=CFG.size_m, cell_side_m=CFG.cell_side_m,
            cells_per_side=CFG.cells_per_side,
        )
        ids = np.where(np.asarray(valid & np.asarray(inb)), np.asarray(idx),
                       CFG.num_cells).astype(np.int32)
        dense = ndt_map.build(ndt_map.add_points(dense, CFG, pts, valid), CFG)
        # Union with last round's ids: the build after a rotation evicts the
        # stale slot even for untouched cells (see build_touched docstring).
        sparse = ndt_map.build_touched(
            ndt_map.add_points(sparse, CFG, pts, valid), CFG,
            np.concatenate([ids, prev_ids]),
        )
        prev_ids = ids
        for name in (
            "mean_c", "inv_cov", "built", "g_sum", "g_count", "g_cov",
            "slot_sum", "slot_count", "slot_cov", "slot_idx",
            "cur_sum", "cur_count", "cur_m2",
        ):
            np.testing.assert_array_equal(
                np.asarray(getattr(dense, name)),
                np.asarray(getattr(sparse, name)),
                err_msg=f"round {rnd}: {name} diverged",
            )
    # rotations must actually have happened for this to prove anything
    assert int(np.asarray(dense.slot_idx).max()) > 0


def _touched_rounds(cfg, n_rounds=12, seed=7):
    """Shared ingest->build_touched driver; returns the final state."""
    from ndtpso_slam.ops.geometry import cell_index

    rs = np.random.RandomState(seed)
    state = ndt_map.init_map(cfg)
    prev_ids = np.full(40, cfg.num_cells, np.int32)
    for _ in range(n_rounds):
        centers = rs.uniform(-6, 6, (3, 2))
        pts = (
            centers[rs.randint(0, 3, 40)] + rs.normal(0, 0.3, (40, 2))
        ).astype(np.float32)
        pts[:4] += 40.0
        valid = rs.rand(40) > 0.15
        idx, inb = cell_index(
            pts, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
            cells_per_side=cfg.cells_per_side,
        )
        ids = np.where(np.asarray(valid & np.asarray(inb)), np.asarray(idx),
                       cfg.num_cells).astype(np.int32)
        state = ndt_map.build_touched(
            ndt_map.add_points(state, cfg, pts, valid), cfg,
            np.concatenate([ids, prev_ids]),
        )
        prev_ids = ids
    return state


def test_sparse_ring_matches_dense_ring():
    """MapConfig.ring_rows > 0 stores window state in R assigned rows; the
    per-cell stats and every cell's ring contents must be bit-identical to
    the dense layout (ring rows compared through the indirection)."""
    import dataclasses

    scfg = dataclasses.replace(CFG, ring_rows=160)  # > cells this workload touches
    dense = _touched_rounds(CFG)
    sparse = _touched_rounds(scfg)
    for name in ("mean_c", "inv_cov", "built", "g_sum", "g_count", "g_cov",
                 "slot_idx", "rot_count", "cur_sum", "cur_count", "cur_m2"):
        np.testing.assert_array_equal(
            np.asarray(getattr(dense, name)), np.asarray(getattr(sparse, name)),
            err_msg=f"{name} diverged",
        )
    rmap = np.asarray(sparse.ring_map)
    used = int(sparse.ring_used)
    assert int(sparse.ring_overflow) == 0
    assert used == (rmap >= 0).sum() > 0
    # Every cell that owns window state in the dense layout has a ring row
    # whose contents match.
    touched = np.asarray(dense.slot_count).sum(axis=1) > 0
    assert (rmap[touched] >= 0).all()
    for arr in ("slot_sum", "slot_count", "slot_cov"):
        d = np.asarray(getattr(dense, arr))
        s = np.asarray(getattr(sparse, arr))
        np.testing.assert_array_equal(
            d[touched], s[rmap[touched]], err_msg=f"{arr} ring rows diverged"
        )


def test_sparse_ring_overflow_is_graceful_and_observable():
    """With fewer rows than touched cells, overflowed cells never build
    (no corruption of assigned cells) and the overflow counter reports it."""
    import dataclasses

    import jax.numpy as jnp

    scfg = dataclasses.replace(CFG, ring_rows=2)  # far too small on purpose
    dense = _touched_rounds(CFG)
    sparse = _touched_rounds(scfg)
    assert int(sparse.ring_overflow) > 0
    assert int(sparse.ring_used) == 2
    rmap = np.asarray(sparse.ring_map)
    has_row = rmap >= 0
    # Assigned cells bit-match the dense result...
    for name in ("mean_c", "g_sum", "g_count", "slot_idx"):
        np.testing.assert_array_equal(
            np.asarray(getattr(dense, name))[has_row],
            np.asarray(getattr(sparse, name))[has_row],
            err_msg=f"{name} diverged on assigned cells",
        )
    # ...and overflowed-but-touched cells never build.
    overflow_cells = (~has_row) & (np.asarray(dense.slot_count).sum(1) > 0)
    assert overflow_cells.any()
    assert not np.asarray(sparse.built)[overflow_cells].any()
    # The counter counts DISTINCT dropped cells (each marked -2 exactly
    # once), not per-scan attempts — so it directly sizes R: rebuilding the
    # same touched set again must not grow it.
    assert int(sparse.ring_overflow) == int((rmap == -2).sum())
    again = ndt_map.build_touched(
        sparse, scfg, jnp.arange(scfg.num_cells, dtype=jnp.int32)[
            np.asarray(dense.slot_count).sum(1) > 0
        ]
    )
    assert int(again.ring_overflow) == int(sparse.ring_overflow)


def test_sparse_ring_slam_trajectory_matches_dense():
    """A whole SLAM session on a sparse-ring map reproduces the dense-map
    trajectory bitwise (slam_step only ever builds through build_touched)."""
    import dataclasses

    import jax.numpy as jnp

    from ndtpso_slam import config as cfgm
    from ndtpso_slam.io import synthetic
    from ndtpso_slam.models import scan as scan_mod, slam

    base_map = cfgm.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=4)
    lg = synthetic.make_log(seed=5, n_scans=8, n_beams=120, world_size=40.0)
    poses = {}
    for name, mc in (
        ("dense", base_map),
        ("sparse", dataclasses.replace(base_map, ring_rows=512)),
    ):
        cfg = cfgm.SlamConfig(
            pso=cfgm.PSOConfig(iterations=8, population=40),
            map=mc,
            scan=cfgm.ScanConfig(max_beams=128),
            cost_mode="fast",
        )
        loaded = [
            scan_mod.load_laser(r, lg.angle_min, lg.angle_increment,
                                lg.range_max, cfg.scan, cfg.map)
            for r in lg.ranges
        ]
        scans = scan_mod.Scan(
            points=jnp.stack([s.points for s in loaded]),
            valid=jnp.stack([s.valid for s in loaded]),
        )
        st = slam.init_slam(cfg, initial_pose=tuple(lg.poses[0]))
        st, p, _ = slam.run_offline(st, scans, (np.uint32(3), np.uint32(9)), cfg)
        poses[name] = np.asarray(p)
        if name == "sparse":
            assert int(st.map.ring_overflow) == 0
            assert 0 < int(st.map.ring_used) <= 512
    np.testing.assert_array_equal(poses["dense"], poses["sparse"])


def test_dense_build_rejects_sparse_config():
    import dataclasses

    import pytest

    scfg = dataclasses.replace(CFG, ring_rows=8)
    state = ndt_map.init_map(scfg)
    with pytest.raises(ValueError, match="build_touched"):
        ndt_map.build(state, scfg)
