"""Fleet recovery: a kidnapped robot in a flat fleet relocalizes via the
host-escalation path (fleet step quarantines + flags, the host runs the solo
3-stage sweep on that robot's state slice) while the other robots' state is
untouched bitwise.

The reference has no failure handling at all (SURVEY §5); solo recovery is
covered by tests/test_recovery.py — this file covers the fleet shape, which
is exactly the reference's multi-LiDAR deployment
(`launch/lidar_front.launch:2,11-14`) plus the new capability.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ndtpso_slam import config as cfgm
from ndtpso_slam.io import synthetic
from ndtpso_slam.models import scan as scan_mod
from ndtpso_slam.models import slam
from ndtpso_slam.parallel.sessions import SlamSessionPool

N_BEAMS = 360


def _cfg():
    return cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=30, population=50),
        map=cfgm.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=8),
        scan=cfgm.ScanConfig(max_beams=N_BEAMS),
        og=cfgm.OccupancyGridConfig(enabled=False),
        recovery=cfgm.RecoveryConfig(
            enabled=True,
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


def test_fleet_kidnapped_robot_relocalizes_others_untouched():
    cfg = _cfg()
    segs = synthetic.make_world(seed=11, size=40.0, n_boxes=6)
    crawl = [(0.06 * i, 0.03 * i, 0.01 * i) for i in range(8)]
    kidnap = (2.4, -1.6, 0.5)
    r1_poses = crawl + [kidnap, (kidnap[0] + 0.05, kidnap[1], kidnap[2])]
    # Robot 0 just keeps crawling the whole time.
    r0_poses = [(0.06 * i, 0.03 * i, 0.01 * i) for i in range(10)]

    base_keys = np.array([[21, 9], [21, 10]], np.uint32)
    pool = SlamSessionPool(
        cfg, np.float32([r0_poses[0], r1_poses[0]]), base_keys
    )
    assert pool._use_flat, "recovery fleet must take the flat path now"
    hist = {0: [], 1: []}
    for t in range(10):
        pool.submit(0, _scan_at(segs, r0_poses[t], cfg))
        pool.submit(1, _scan_at(segs, r1_poses[t], cfg))
        for sid, (pose, cost) in pool.poll().items():
            hist[sid].append(np.asarray(pose, np.float64))

    est1 = np.stack(hist[1])
    err1 = np.hypot(est1[:, 0] - np.asarray(r1_poses)[:, 0],
                    est1[:, 1] - np.asarray(r1_poses)[:, 1])
    recoveries = np.asarray(pool.states.recoveries)
    assert recoveries[1] >= 1, "kidnap did not trigger fleet recovery"
    assert recoveries[0] == 0, "healthy robot must not relocalize"
    assert err1[-2] < 0.3, f"relocalization missed: err {err1[-2]:.3f} m"
    assert err1[-1] < 0.3, f"post-recovery tracking lost: err {err1[-1]:.3f} m"
    # The jump is not robot motion: pose_diff reset on accept.
    assert float(np.abs(np.asarray(pool.states.align.pose_diff)[1]).max()) < 0.5

    # Robot 0 is bitwise the solo run of the same log/key/config — the
    # other robot's quarantine + escalation wrote nothing into its rows.
    solo = slam.init_slam(cfg, initial_pose=tuple(r0_poses[0]))
    scans0 = [_scan_at(segs, p, cfg) for p in r0_poses]
    solo_scans = scan_mod.Scan(
        points=jnp.stack([s.points for s in scans0]),
        valid=jnp.stack([s.valid for s in scans0]),
    )
    solo, sposes, _ = slam.run_offline(
        solo, solo_scans, (base_keys[0, 0], base_keys[0, 1]), cfg
    )
    np.testing.assert_array_equal(np.stack(hist[0]), np.asarray(sposes))
    np.testing.assert_array_equal(
        np.asarray(pool.states.map.mean_c)[0], np.asarray(solo.map.mean_c)
    )
    np.testing.assert_array_equal(
        np.asarray(pool.states.map.g_count)[0], np.asarray(solo.map.g_count)
    )


def test_fleet_dropout_dead_reckons_in_step():
    """Sensor dropout in a fleet dead-reckons in-step (no escalation) and
    does not ingest the empty scan."""
    cfg = _cfg()
    segs = synthetic.make_world(seed=12, size=40.0, n_boxes=6)
    poses = [(0.1 * i, 0.05 * i, 0.0) for i in range(6)]
    base_keys = np.array([[31, 5], [31, 6]], np.uint32)
    pool = SlamSessionPool(cfg, np.float32([poses[0], poses[0]]), base_keys)
    for t in range(4):
        for sid in (0, 1):
            pool.submit(sid, _scan_at(segs, poses[t], cfg))
        pool.poll()
    diff_before = np.asarray(pool.states.align.pose_diff)[1]
    pose_before = np.asarray(pool.states.pose)[1]
    counts_before = int(np.asarray(pool.states.map.g_count)[1].sum()) + int(
        np.asarray(pool.states.map.cur_count)[1].sum()
    )
    dead = scan_mod.load_laser(
        np.zeros(N_BEAMS, np.float32), -np.pi, 2 * np.pi / N_BEAMS, 30.0,
        cfg.scan, cfg.map,
    )
    pool.submit(0, _scan_at(segs, poses[4], cfg))
    pool.submit(1, dead)
    res = pool.poll()
    np.testing.assert_allclose(res[1][0], pose_before + diff_before, atol=1e-6)
    counts_after = int(np.asarray(pool.states.map.g_count)[1].sum()) + int(
        np.asarray(pool.states.map.cur_count)[1].sum()
    )
    assert counts_after == counts_before, "dropout scan was ingested"
    assert int(np.asarray(pool.states.recoveries)[1]) == 0
    # Next real scan re-tracks.
    pool.submit(0, _scan_at(segs, poses[5], cfg))
    pool.submit(1, _scan_at(segs, poses[5], cfg))
    res = pool.poll()
    err = np.hypot(res[1][0][0] - poses[5][0], res[1][0][1] - poses[5][1])
    assert float(err) < 0.15


def test_fleet_escalation_rejects_unrecoverable_kidnap():
    """A kidnap far outside the relocalization spread must be REJECTED:
    the failed pose is kept, the quarantined scan is never ingested, the
    recovery counter stays 0, and the robot keeps getting flagged lost on
    subsequent polls (so an operator can see it) — no silent corruption."""
    cfg = _cfg()
    segs = synthetic.make_world(seed=11, size=40.0, n_boxes=6)
    crawl = [(0.06 * i, 0.03 * i, 0.01 * i) for i in range(8)]
    # Teleport ~12 m away: outside the (3, 3, pi) recovery spread and into
    # geometry the map has never seen.
    far = (12.0, -11.0, 0.4)
    base_keys = np.array([[71, 3], [71, 4]], np.uint32)
    pool = SlamSessionPool(cfg, np.float32([crawl[0], crawl[0]]), base_keys)
    for t in range(8):
        for sid in (0, 1):
            pool.submit(sid, _scan_at(segs, crawl[t], cfg))
        pool.poll()
    counts_before = int(np.asarray(pool.states.map.g_count)[1].sum()) + int(
        np.asarray(pool.states.map.cur_count)[1].sum()
    )
    pose_before = np.asarray(pool.states.pose)[1].copy()
    for _ in range(2):  # two far-kidnap polls: flagged + escalated each time
        pool.submit(0, _scan_at(segs, crawl[7], cfg))
        pool.submit(1, _scan_at(segs, far, cfg))
        pool.poll()
    assert int(np.asarray(pool.states.recoveries)[1]) == 0, (
        "unrecoverable kidnap must not be accepted"
    )
    counts_after = int(np.asarray(pool.states.map.g_count)[1].sum()) + int(
        np.asarray(pool.states.map.cur_count)[1].sum()
    )
    assert counts_after == counts_before, "quarantined scans were ingested"
    # Fitness stays below the loss threshold -> still observably lost.
    assert float(np.asarray(pool.states.fitness)[1]) < cfg.recovery.fitness_threshold
    # The healthy robot is unaffected throughout.
    assert int(np.asarray(pool.states.recoveries)[0]) == 0
