"""Streaming multi-session scheduler (parallel/sessions.py).

The reference's async multi-sensor deployment is one OS process per LiDAR at
independent rates (`launch/lidar_front.launch`, `lidar_back.launch`); the
pool multiplexes K live sessions onto one chip with masked batched steps.
The contract under test: arbitrary interleaving of arrivals must leave every
session's trajectory identical to a solo `run_offline` of its log (same
base key), and idle polls must not perturb state.
"""

import numpy as np
import jax.numpy as jnp

from ndtpso_slam import config as cfgm
from ndtpso_slam.io import synthetic
from ndtpso_slam.models import scan as scan_mod, slam
from ndtpso_slam.parallel.sessions import SlamSessionPool

CFG = cfgm.SlamConfig(
    pso=cfgm.PSOConfig(iterations=8, population=40),
    map=cfgm.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=4),
    scan=cfgm.ScanConfig(max_beams=128),
    cost_mode="fast",
)


def _load_log(seed, n_scans):
    lg = synthetic.make_log(seed=seed, n_scans=n_scans, n_beams=120,
                            world_size=40.0)
    loaded = [
        scan_mod.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max,
                            CFG.scan, CFG.map)
        for r in lg.ranges
    ]
    return lg, loaded


def test_interleaved_sessions_match_solo_runs():
    """Session 0 feeds every poll, session 1 every other poll (two LiDARs at
    different rates); each must replay its solo run_offline bit-for-bit on
    this backend."""
    lg0, scans0 = _load_log(3, 8)
    lg1, scans1 = _load_log(4, 5)
    keys = np.array([[3, 9], [7, 21]], np.uint32)
    pool = SlamSessionPool(
        CFG, np.stack([lg0.poses[0], lg1.poses[0]]).astype(np.float32), keys
    )
    got0, got1 = [], []
    i0 = i1 = 0
    tick = 0
    while i0 < len(scans0) or i1 < len(scans1):
        if i0 < len(scans0):
            pool.submit(0, scans0[i0]); i0 += 1
        if tick % 2 == 0 and i1 < len(scans1):
            pool.submit(1, scans1[i1]); i1 += 1
        res = pool.poll()
        if 0 in res:
            got0.append(res[0][0])
        if 1 in res:
            got1.append(res[1][0])
        tick += 1
    # A few idle polls at the end must be no-ops.
    assert pool.poll() == {}

    for lg, scans, key, got in (
        (lg0, scans0, keys[0], got0), (lg1, scans1, keys[1], got1)
    ):
        st = slam.init_slam(CFG, initial_pose=tuple(lg.poses[0]))
        stacked = scan_mod.Scan(
            points=jnp.stack([s.points for s in scans]),
            valid=jnp.stack([s.valid for s in scans]),
        )
        _, solo_poses, _ = slam.run_offline(
            st, stacked, (np.uint32(key[0]), np.uint32(key[1])), CFG
        )
        np.testing.assert_array_equal(np.stack(got), np.asarray(solo_poses))


def test_multi_session_node_matches_solo_nodes(tmp_path):
    """MultiSessionNode (the dual-LiDAR CLI mode) == two solo SlamNodes on
    the same logs, and per-session export bundles are written."""
    import dataclasses

    from ndtpso_slam.node import MultiSessionNode, NodeConfig, SlamNode

    base = NodeConfig(
        frame_size_m=48.0, cell_side_m=1.0, window_slots=4, max_beams=128,
        pso_iterations=8, pso_population=40, cost_mode="fast", build_og=False,
    )
    cfgs = [
        dataclasses.replace(base, init_pose=(8.0, 0.0, np.pi / 2)),
        dataclasses.replace(base, init_pose=(8.0, 0.0, np.pi / 2),
                            mount_trans=(0.1, 0.0, 0.05)),
    ]
    lg0 = synthetic.make_log(seed=3, n_scans=6, n_beams=120, world_size=40.0)
    lg1 = synthetic.make_log(seed=4, n_scans=4, n_beams=120, world_size=40.0,
                             dt=0.15)  # a slower sensor
    mnode = MultiSessionNode(cfgs, verbose=False)
    poses = mnode.run_logs([lg0, lg1])
    assert len(poses[0]) == 6 and len(poses[1]) == 4

    for cfg, lg, got, seed_off in ((cfgs[0], lg0, poses[0], 0),
                                   (cfgs[1], lg1, poses[1], 1)):
        solo = SlamNode(
            dataclasses.replace(cfg, seed=cfg.seed + 101 * seed_off),
            verbose=False,
        )
        solo_poses = solo.run_log(lg)
        np.testing.assert_array_equal(np.asarray(got), solo_poses)

    files = mnode.shutdown(str(tmp_path / "duo"))
    assert any("duo-s0" in f and f.endswith(".pose.csv") for f in files)
    assert any("duo-s1" in f and f.endswith(".pose.csv") for f in files)


def test_multi_session_rejects_mismatched_shapes():
    import dataclasses

    import pytest

    from ndtpso_slam.node import MultiSessionNode, NodeConfig

    a = NodeConfig(frame_size_m=48.0, cell_side_m=1.0, max_beams=128,
                   window_slots=4)
    b = dataclasses.replace(a, max_beams=256)
    with pytest.raises(ValueError, match="shape-identical"):
        MultiSessionNode([a, b])


def test_pool_session_state_slices_one_session():
    lg0, scans0 = _load_log(5, 3)
    lg1, scans1 = _load_log(6, 3)
    keys = np.array([[1, 2], [3, 4]], np.uint32)
    pool = SlamSessionPool(
        CFG, np.stack([lg0.poses[0], lg1.poses[0]]).astype(np.float32), keys
    )
    for s0, s1 in zip(scans0, scans1):
        pool.submit(0, s0)
        pool.submit(1, s1)
    pool.drain()
    st1 = pool.session_state(1)
    assert int(st1.step) == 3
    assert st1.pose.shape == (3,)
    assert np.isfinite(np.asarray(st1.pose)).all()
