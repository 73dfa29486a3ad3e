"""Tracking-loss detection + multi-swarm relocalization (SlamConfig.recovery).

The reference has no failure handling at all (SURVEY §5: startup retries only,
a runtime_error kills the node, no relocalization on tracking loss).  These
tests cover the new capability: a kidnapped robot is detected by the per-scan
match fitness and relocalized by the K-hypothesis multi-swarm search; sensor
dropouts dead-reckon without polluting the map; a healthy run is bit-identical
with recovery on or off.
"""

import numpy as np
import jax.numpy as jnp

from ndtpso_slam import config as cfgm
from ndtpso_slam.io import synthetic
from ndtpso_slam.models import scan as scan_mod
from ndtpso_slam.models import slam
from ndtpso_slam.ops import rng

KEY = (np.uint32(21), np.uint32(9))
N_BEAMS = 360


def _cfg(recovery_on: bool):
    return cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=30, population=50),
        map=cfgm.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=8),
        scan=cfgm.ScanConfig(max_beams=N_BEAMS),
        og=cfgm.OccupancyGridConfig(enabled=False),
        recovery=cfgm.RecoveryConfig(
            enabled=recovery_on,
            fitness_threshold=0.2,
            spread=(3.0, 3.0, np.pi),
            grid=(24, 24, 16),
        ),
        cost_mode="exact",
    )


def _scan_at(segs, pose, cfg):
    r = synthetic.raycast(
        segs, np.asarray(pose, np.float64), N_BEAMS, -np.pi,
        2 * np.pi / N_BEAMS, 30.0
    )
    return scan_mod.load_laser(
        r.astype(np.float32), -np.pi, 2 * np.pi / N_BEAMS, 30.0,
        cfg.scan, cfg.map,
    )


def _run(cfg, poses_true, scans):
    state = slam.init_slam(cfg, initial_pose=tuple(poses_true[0]))
    out = []
    for i, sc in enumerate(scans):
        key = rng.threefry2x32(KEY, np.uint32(i), np.uint32(0))
        state, pose, _ = slam.slam_step(state, sc, key, cfg)
        out.append(np.asarray(pose, np.float64))
    return state, np.stack(out)


def _kidnap_workload(cfg):
    """8 crawling scans, then the robot teleports 3 m away (still inside the
    mapped region, so the exact cost can re-anchor it)."""
    segs = synthetic.make_world(seed=11, size=40.0, n_boxes=6)
    path = [(0.06 * i, 0.03 * i, 0.01 * i) for i in range(8)]
    kidnap = (2.4, -1.6, 0.5)
    poses = path + [kidnap, (kidnap[0] + 0.05, kidnap[1], kidnap[2])]
    scans = [_scan_at(segs, p, cfg) for p in poses]
    return np.asarray(poses), scans


def test_kidnapped_robot_relocalizes():
    cfg = _cfg(recovery_on=True)
    poses_true, scans = _kidnap_workload(cfg)
    state, est = _run(cfg, poses_true, scans)
    err = np.hypot(est[:, 0] - poses_true[:, 0], est[:, 1] - poses_true[:, 1])
    assert int(state.recoveries) >= 1, "kidnap did not trigger recovery"
    assert err[-2] < 0.3, f"relocalization missed: err {err[-2]:.3f} m"
    assert err[-1] < 0.3, f"post-recovery tracking lost: err {err[-1]:.3f} m"
    # The jump must not be treated as robot motion: the next align's adaptive
    # deviation comes from pose_diff, which recovery resets.
    assert float(np.abs(np.asarray(state.align.pose_diff)).max()) < 0.5


def test_without_recovery_kidnap_loses_tracking():
    """Control: same workload, recovery off (= reference behavior) diverges."""
    cfg = _cfg(recovery_on=False)
    poses_true, scans = _kidnap_workload(cfg)
    state, est = _run(cfg, poses_true, scans)
    err = np.hypot(est[:, 0] - poses_true[:, 0], est[:, 1] - poses_true[:, 1])
    assert err[-1] > 1.0, (
        f"expected tracking loss without recovery, err {err[-1]:.3f} m"
    )
    assert int(state.recoveries) == 0


def test_degraded_scan_dead_reckons_and_skips_ingestion():
    cfg = _cfg(recovery_on=True)
    segs = synthetic.make_world(seed=12, size=40.0, n_boxes=6)
    poses = [(0.1 * i, 0.05 * i, 0.0) for i in range(6)]
    scans = [_scan_at(segs, p, cfg) for p in poses]
    # Scan 4 is a dropout: every beam invalid (range 0 fails the epsilon
    # filter, `ndtframe.cpp:165`).
    dead = scan_mod.load_laser(
        np.zeros(N_BEAMS, np.float32), -np.pi, 2 * np.pi / N_BEAMS, 30.0,
        cfg.scan, cfg.map,
    )
    assert not bool(np.asarray(dead.valid).any())

    state = slam.init_slam(cfg, initial_pose=tuple(poses[0]))
    for i in range(4):
        key = rng.threefry2x32(KEY, np.uint32(i), np.uint32(0))
        state, pose, _ = slam.slam_step(state, scans[i], key, cfg)
    diff_before = np.asarray(state.align.pose_diff)
    pose_before = np.asarray(state.pose)
    counts_before = int(np.asarray(state.map.g_count).sum()) + int(
        np.asarray(state.map.cur_count).sum()
    )
    key = rng.threefry2x32(KEY, np.uint32(4), np.uint32(0))
    state, pose, _ = slam.slam_step(state, dead, key, cfg)
    # Constant-velocity dead reckoning, velocity estimate preserved.
    np.testing.assert_allclose(
        np.asarray(pose), pose_before + diff_before, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(state.align.pose_diff), diff_before, atol=1e-6
    )
    counts_after = int(np.asarray(state.map.g_count).sum()) + int(
        np.asarray(state.map.cur_count).sum()
    )
    assert counts_after == counts_before, "dropout scan was ingested"
    # Next real scan re-tracks.
    key = rng.threefry2x32(KEY, np.uint32(5), np.uint32(0))
    state, pose, _ = slam.slam_step(state, scans[5], key, cfg)
    err = np.hypot(pose[0] - poses[5][0], pose[1] - poses[5][1])
    assert float(err) < 0.15


def test_recovery_is_noop_on_healthy_run():
    """With no tracking loss the recovery-enabled pose stream is bit-identical
    to the plain one (the lax.cond branch never executes)."""
    log = synthetic.make_log(seed=13, n_scans=10, n_beams=N_BEAMS,
                             world_size=40.0, dt=0.1)
    scans_on = [
        scan_mod.load_laser(r, log.angle_min, log.angle_increment,
                            log.range_max, _cfg(True).scan, _cfg(True).map)
        for r in log.ranges
    ]
    state_on, est_on = _run(_cfg(True), log.poses, scans_on)
    state_off, est_off = _run(_cfg(False), log.poses, scans_on)
    np.testing.assert_array_equal(est_on, est_off)
    assert int(state_on.recoveries) == 0
    # Fitness of a healthy run sits well above the loss threshold.
    assert float(state_on.fitness) > 0.3
