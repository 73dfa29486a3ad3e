"""End-to-end sequential SLAM on a synthetic world with exact ground truth.

Replaces the reference's manual rosbag+RViz validation (SURVEY.md §4) with a
raycast world: the engine must track the true trajectory within tight bounds.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from ndtpso_slam import config as cfgm
from ndtpso_slam.io import synthetic
from ndtpso_slam.models import scan as scan_mod
from ndtpso_slam.models import slam

KEY = (np.uint32(5), np.uint32(77))


def _small_cfg(cost_mode="exact"):
    return cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=30, population=50),
        map=cfgm.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=8, slot_capacity=50),
        scan=cfgm.ScanConfig(max_beams=360),
        og=cfgm.OccupancyGridConfig(enabled=False),
        cost_mode=cost_mode,
    )


def _load_scans(log, cfg):
    scans = [
        scan_mod.load_laser(
            r, log.angle_min, log.angle_increment, log.range_max, cfg.scan, cfg.map
        )
        for r in log.ranges
    ]
    return scan_mod.Scan(
        points=jnp.stack([s.points for s in scans]),
        valid=jnp.stack([s.valid for s in scans]),
    )


def _traj_errors(poses, gt):
    poses = np.asarray(poses, np.float64)
    dt = np.hypot(poses[:, 0] - gt[:, 0], poses[:, 1] - gt[:, 1])
    da = np.abs(np.arctan2(np.sin(poses[:, 2] - gt[:, 2]), np.cos(poses[:, 2] - gt[:, 2])))
    return dt, da


@pytest.mark.parametrize("cost_mode", ["exact", "fast", "fast_local", "local_exact"])
def test_slam_tracks_synthetic_trajectory(cost_mode):
    cfg = _small_cfg(cost_mode)
    log = synthetic.make_log(seed=3, n_scans=25, n_beams=360, world_size=40.0, dt=0.1)
    scans = _load_scans(log, cfg)
    state = slam.init_slam(cfg, initial_pose=tuple(log.poses[0]))
    state, poses, costs = slam.run_offline(state, scans, KEY, cfg)
    dt, da = _traj_errors(poses, log.poses)
    assert dt.max() < 0.15, f"translation error too large: {dt.max():.3f} m"
    assert da.max() < 0.05, f"rotation error too large: {da.max():.4f} rad"
    # Map was actually built and costs are meaningfully negative after step 0.
    assert bool(np.asarray(state.map.built).any())
    assert float(np.asarray(costs)[-1]) < -50.0


def test_slam_step_streaming_matches_offline():
    cfg = _small_cfg("exact")
    log = synthetic.make_log(seed=4, n_scans=6, n_beams=360, world_size=40.0)
    scans = _load_scans(log, cfg)
    state = slam.init_slam(cfg, initial_pose=tuple(log.poses[0]))
    _, poses_off, _ = slam.run_offline(state, scans, KEY, cfg)

    from ndtpso_slam.ops import rng

    state2 = slam.init_slam(cfg, initial_pose=tuple(log.poses[0]))
    poses_st = []
    for i in range(6):
        key = rng.threefry2x32(KEY, np.uint32(i), np.uint32(0))
        sc = scan_mod.Scan(points=scans.points[i], valid=scans.valid[i])
        state2, pose, _ = slam.slam_step(state2, sc, key, cfg)
        poses_st.append(np.asarray(pose))
    np.testing.assert_allclose(
        np.asarray(poses_off), np.stack(poses_st), rtol=0, atol=1e-6
    )


def test_batched_sessions_match_independent_runs():
    """B vmapped SLAM sessions (the dual-LiDAR front/back deployment as one
    XLA program, `launch/lidar_front.launch`) == B separate run_offline
    calls, bitwise: no state leaks between robots."""
    cfg = _small_cfg("fast")
    logs = [
        synthetic.make_log(seed=s, n_scans=5, n_beams=360, world_size=40.0)
        for s in (8, 9)
    ]
    scans = [_load_scans(lg, cfg) for lg in logs]
    keys = np.array([[11, 12], [13, 14]], np.uint32)

    sep = []
    for lg, sc, k in zip(logs, scans, keys):
        st = slam.init_slam(cfg, initial_pose=tuple(lg.poses[0]))
        _, poses, costs = slam.run_offline(st, sc, (k[0], k[1]), cfg)
        sep.append((np.asarray(poses), np.asarray(costs)))

    states = slam.init_slam_batch(
        cfg, np.stack([lg.poses[0] for lg in logs]).astype(np.float32)
    )
    batched_scans = scan_mod.Scan(
        points=jnp.stack([s.points for s in scans]),
        valid=jnp.stack([s.valid for s in scans]),
    )
    fstates, poses_b, costs_b = slam.run_offline_batch(
        states, batched_scans, keys, cfg
    )
    for b in range(2):
        np.testing.assert_array_equal(np.asarray(poses_b)[b], sep[b][0])
        np.testing.assert_array_equal(np.asarray(costs_b)[b], sep[b][1])
    assert fstates.map.built.shape[0] == 2


def test_first_scan_keeps_prior_pose():
    cfg = _small_cfg("exact")
    log = synthetic.make_log(seed=5, n_scans=2, n_beams=360, world_size=40.0)
    scans = _load_scans(log, cfg)
    init = tuple(log.poses[0])
    state = slam.init_slam(cfg, initial_pose=init)
    _, poses, _ = slam.run_offline(state, scans, KEY, cfg)
    np.testing.assert_allclose(np.asarray(poses)[0], np.asarray(init), atol=1e-7)


def _rollout_cfg(cost_mode="rollout"):
    """Shapes for the whole-solve rollout kernel, run in interpret mode on
    the CPU."""
    return cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=15, population=128),
        map=cfgm.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=4),
        scan=cfgm.ScanConfig(max_beams=384),
        og=cfgm.OccupancyGridConfig(enabled=False),
        cost_mode=cost_mode,
    )


def test_slam_with_rollout_matches_fast_local():
    """The sequential SLAM loop through the whole-solve rollout kernel:
    same Threefry stream + same stencil rebinding as
    fast_local, so trajectories agree to float tolerance and track truth."""
    log = synthetic.make_log(seed=6, n_scans=8, n_beams=360, world_size=40.0, dt=0.1)

    cfg_r = _rollout_cfg("rollout")
    scans = _load_scans(log, cfg_r)
    state = slam.init_slam(cfg_r, initial_pose=tuple(log.poses[0]))
    _, poses_r, costs_r = slam.run_offline(state, scans, KEY, cfg_r)

    cfg_f = _rollout_cfg("fast_local")
    state = slam.init_slam(cfg_f, initial_pose=tuple(log.poses[0]))
    _, poses_f, _ = slam.run_offline(state, scans, KEY, cfg_f)

    # Same frozen draw protocol; only matmul summation order differs, so the
    # trajectories may diverge by ULP-level tie-breaks but must stay tight.
    np.testing.assert_allclose(
        np.asarray(poses_r), np.asarray(poses_f), rtol=0, atol=2e-2
    )
    dt, da = _traj_errors(poses_r, log.poses)
    assert dt.max() < 0.15, f"rollout-SLAM translation error: {dt.max():.3f} m"
    assert da.max() < 0.05, f"rollout-SLAM rotation error: {da.max():.4f} rad"
    # align() re-scores with the exact cost: finite and meaningfully negative.
    assert float(np.asarray(costs_r)[-1]) < -50.0


def test_slam_rollout_runs_unaligned_shapes():
    """A 360-beam scan buffer and the reference's 50-particle budget (no
    multiple of any tile) run through the rollout kernel and track like
    the XLA fast_local loop on the same Threefry streams."""
    cfg = cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=10, population=50),
        map=cfgm.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=4),
        scan=cfgm.ScanConfig(max_beams=360),
        og=cfgm.OccupancyGridConfig(enabled=False),
        cost_mode="rollout",
    )
    log = synthetic.make_log(seed=6, n_scans=4, n_beams=360, world_size=40.0)
    scans = _load_scans(log, cfg)
    state = slam.init_slam(cfg, initial_pose=tuple(log.poses[0]))
    _, poses_r, _ = slam.run_offline(state, scans, KEY, cfg)
    cfg_f = dataclasses.replace(cfg, cost_mode="fast_local")
    state = slam.init_slam(cfg_f, initial_pose=tuple(log.poses[0]))
    _, poses_f, _ = slam.run_offline(state, scans, KEY, cfg_f)
    np.testing.assert_allclose(
        np.asarray(poses_r), np.asarray(poses_f), rtol=0, atol=2e-2
    )
    dt, _ = _traj_errors(poses_r, log.poses)
    assert dt.max() < 0.15, f"rollout-SLAM translation error: {dt.max():.3f} m"


def test_align_rescores_final_pose_with_exact_cost():
    """Fast modes report the exact NDT objective for the winning pose
    (VERDICT r1 weak #6)."""
    from ndtpso_slam.models import cost as cost_mod, ndt_map
    from ndtpso_slam.ops import rng

    cfg = _small_cfg("fast_local")
    log = synthetic.make_log(seed=7, n_scans=3, n_beams=360, world_size=40.0)
    scans = _load_scans(log, cfg)
    state = slam.init_slam(cfg, initial_pose=tuple(log.poses[0]))
    for i in range(3):
        key = rng.threefry2x32(KEY, np.uint32(i), np.uint32(0))
        sc = scan_mod.Scan(points=scans.points[i], valid=scans.valid[i])
        prev_map = state.map
        state, pose, cost = slam.slam_step(state, sc, key, cfg)
    snap = ndt_map.snapshot(prev_map, cfg.map)
    exact = cost_mod.ndt_cost(
        jnp.asarray(pose)[None, :], snap, sc.points, sc.valid, cfg.map
    )[0]
    np.testing.assert_allclose(float(cost), float(exact), rtol=1e-6)
