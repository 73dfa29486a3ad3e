"""Parity vs the native C++ golden reference (BASELINE gate).

The golden library shares the engine's Threefry protocol bit-for-bit, so
whole solves can be compared seed-by-seed: the BASELINE.json acceptance is
pose RMSE <= 1e-3 m / 1e-3 rad under identical particle count, iteration
budget, and cell size (config 1: 360-beam scan, 1 m cells, 50x50 budget).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ndtpso_slam import config as cfgm
from ndtpso_slam.io import synthetic
from ndtpso_slam.models import cost as cost_mod
from ndtpso_slam.models import ndt_map, scan as scan_mod, slam
from ndtpso_slam.models.pso import pso_solve
from ndtpso_slam.ops import rng
from ndtpso_slam.utils import native

MAP_CFG = cfgm.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=8, slot_capacity=50)
SCAN_CFG = cfgm.ScanConfig(max_beams=384)


def test_threefry_cpp_matches_jax():
    key = (np.uint32(123), np.uint32(456))
    c0 = np.arange(1000, dtype=np.uint32)
    c1 = np.arange(5000, 6000, dtype=np.uint32)
    o0, o1 = native.golden_threefry(key, c0, c1)
    j0, j1 = rng.threefry2x32(key, c0, c1)
    np.testing.assert_array_equal(o0, np.asarray(j0))
    np.testing.assert_array_equal(o1, np.asarray(j1))


def _world_scans(seed=0):
    rs = np.random.RandomState(seed)
    segs = synthetic.make_world(seed=seed, size=50.0, n_boxes=8)
    beams = 360
    ref_r = synthetic.raycast(segs, np.zeros(3), beams, -np.pi, 2 * np.pi / beams, 30.0)
    ref = scan_mod.load_laser(
        ref_r.astype(np.float32), -np.pi, 2 * np.pi / beams, 30.0, SCAN_CFG, MAP_CFG
    )
    true = rs.uniform([-0.25, -0.25, -0.04], [0.25, 0.25, 0.04])
    q_r = synthetic.raycast(segs, true, beams, -np.pi, 2 * np.pi / beams, 30.0)
    q = scan_mod.load_laser(
        q_r.astype(np.float32), -np.pi, 2 * np.pi / beams, 30.0, SCAN_CFG, MAP_CFG
    )
    return ref, q, true


def _build_both(ref, n_obs=3, seed=1):
    """Identical maps in the engine (dense f32) and golden (sparse f64)."""
    rs = np.random.RandomState(seed)
    state = ndt_map.init_map(MAP_CFG)
    gold = native.GoldenMap(
        MAP_CFG.size_m, MAP_CFG.cell_side_m, MAP_CFG.window_slots, MAP_CFG.slot_capacity
    )
    pts0 = np.asarray(ref.points, np.float64)
    valid = np.asarray(ref.valid)
    for _ in range(n_obs):
        pts = pts0 + rs.normal(0, 0.03, pts0.shape)
        state = ndt_map.add_points(state, MAP_CFG, pts.astype(np.float32), valid)
        state = ndt_map.build(state, MAP_CFG)
        gold.update(np.zeros(3), pts, valid)
        gold.build()
    return state, gold


def test_map_cells_match_golden():
    ref, _, _ = _world_scans()
    state, gold = _build_both(ref)
    snap = ndt_map.snapshot(state, MAP_CFG)
    built = np.asarray(snap.built)
    mean = np.asarray(snap.mean)
    icov = np.asarray(snap.inv_cov)
    n_checked = 0
    for idx in np.nonzero(built)[0]:
        cell = gold.cell(int(idx))
        assert cell is not None, f"engine built cell {idx} missing in golden"
        gmean, gicov = cell
        np.testing.assert_allclose(mean[idx], gmean, atol=1e-4)
        scale = max(1.0, np.abs(gicov).max())
        np.testing.assert_allclose(icov[idx] / scale, gicov / scale, atol=2e-3)
        n_checked += 1
    assert n_checked > 50


def test_cost_matches_golden():
    ref, q, _ = _world_scans()
    state, gold = _build_both(ref)
    snap = ndt_map.snapshot(state, MAP_CFG)
    rs = np.random.RandomState(2)
    for _ in range(10):
        pose = rs.uniform([-0.3, -0.3, -0.05], [0.3, 0.3, 0.05])
        ours = float(
            cost_mod.ndt_cost(
                jnp.asarray(pose, jnp.float32), snap, q.points, q.valid, MAP_CFG
            )
        )
        theirs = gold.cost(pose, np.asarray(q.points, np.float64), np.asarray(q.valid))
        np.testing.assert_allclose(ours, theirs, rtol=3e-3, atol=3e-3)


def test_pso_solve_parity_rmse_gate():
    """BASELINE config 1 parity: pose RMSE <= 1e-3 m / 1e-3 rad over seeds."""
    pso_cfg = cfgm.PSOConfig(iterations=50, population=50)
    diffs = []
    for seed in range(6):
        ref, q, true = _world_scans(seed)
        state, gold = _build_both(ref, seed=seed + 10)
        snap = ndt_map.snapshot(state, MAP_CFG)
        key = (np.uint32(seed), np.uint32(seed + 100))
        guess = jnp.zeros(3, jnp.float32)
        dev = jnp.asarray([0.4, 0.4, 0.08], jnp.float32)
        cost_fn = lambda poses, bind: cost_mod.ndt_cost(
            poses, snap, q.points, q.valid, MAP_CFG
        )
        res = pso_solve(key, guess, dev, cost_fn, pso_cfg)
        gpose, _ = gold.pso(
            np.asarray(q.points, np.float64), np.zeros(3), [0.4, 0.4, 0.08],
            key, iterations=50, population=50, valid=np.asarray(q.valid),
        )
        diffs.append(np.asarray(res.pose, np.float64) - gpose)
    diffs = np.array(diffs)
    rmse_xy = np.sqrt(np.mean(diffs[:, :2] ** 2))
    rmse_th = np.sqrt(np.mean(diffs[:, 2] ** 2))
    assert rmse_xy <= 1e-3, f"xy RMSE {rmse_xy:.2e} vs gate 1e-3"
    assert rmse_th <= 1e-3, f"theta RMSE {rmse_th:.2e} vs gate 1e-3"


def _slam_vs_golden(dtype):
    cfg = cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=30, population=50),
        map=MAP_CFG,
        scan=SCAN_CFG,
        og=cfgm.OccupancyGridConfig(enabled=False),
        cost_mode="exact",
        dtype=dtype,
    )
    log = synthetic.make_log(seed=6, n_scans=12, n_beams=360, world_size=40.0)
    loaded = [
        scan_mod.load_laser(
            r, log.angle_min, log.angle_increment, log.range_max, cfg.scan,
            cfg.map, dtype=dtype,
        )
        for r in log.ranges
    ]
    scans = scan_mod.Scan(
        points=jnp.stack([s.points for s in loaded]),
        valid=jnp.stack([s.valid for s in loaded]),
    )
    key = (np.uint32(9), np.uint32(17))
    state = slam.init_slam(cfg, initial_pose=tuple(log.poses[0]))
    _, poses, _ = slam.run_offline(state, scans, key, cfg)
    gold_poses = native.golden_slam_run(
        np.asarray(scans.points, np.float64), np.asarray(scans.valid),
        log.poses[0], MAP_CFG.size_m, MAP_CFG.cell_side_m,
        MAP_CFG.window_slots, MAP_CFG.slot_capacity, key,
        iterations=30, population=50,
    )
    return np.asarray(poses, np.float64), gold_poses, log


def test_slam_trajectory_parity_x64_bitwise():
    """In float64 the engine's lax.scan SLAM loop reproduces the C++ golden
    loop to the ulp — the semantics are identical, not merely close."""
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        poses, gold_poses, _ = _slam_vs_golden(jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(poses, gold_poses, rtol=0, atol=1e-12)


def test_slam_trajectory_accuracy_parity_f32():
    """In float32 PSO on a spiky single-scan map cost surface diverges
    pose-for-pose from the f64 golden (comparison flips), but must track the
    ground truth just as accurately — accuracy parity, not bit parity."""
    poses, gold_poses, log = _slam_vs_golden(jnp.float32)
    gt = log.poses
    err = lambda p: np.sqrt(np.mean((p[:, :2] - gt[:, :2]) ** 2))
    eng_rmse, gold_rmse = err(poses), err(gold_poses)
    assert eng_rmse < 1.5 * gold_rmse + 1e-3, (eng_rmse, gold_rmse)
    np.testing.assert_allclose(poses, gold_poses, atol=0.05)
