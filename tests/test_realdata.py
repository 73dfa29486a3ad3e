"""Real-data ingestion path (VERDICT r1 item 5): ROS1 bag parsing, CSV
import, the converter CLI, and an end-to-end SLAM run over the committed
realistic fixture (noise + dropout + dynamic clutter + drifting odometry —
the failure modes live LiDAR has and the clean raycaster lacks).
"""

import os

import numpy as np
import pytest

from ndtpso_slam.io import importers, rosbag, synthetic

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "realistic.bag")
FIXTURE_GT = os.path.join(HERE, "data", "realistic_gt.npy")


def _small_log():
    return synthetic.make_log(seed=9, n_scans=5, n_beams=90, world_size=30.0,
                              odom_noise=0.01)


def test_bag_roundtrip(tmp_path):
    log = _small_log()
    path = str(tmp_path / "rt.bag")
    rosbag.write_bag(
        path, log.ranges, log.timestamps, log.angle_min, log.angle_increment,
        log.range_max, odoms=np.asarray(log.odoms),
    )
    back = rosbag.read_bag(path)
    np.testing.assert_allclose(back.ranges, log.ranges, rtol=0, atol=0)
    np.testing.assert_allclose(back.timestamps, log.timestamps, atol=1e-6)
    assert back.angle_min == pytest.approx(log.angle_min, abs=1e-6)
    assert back.angle_increment == pytest.approx(log.angle_increment, abs=1e-9)
    assert back.range_max == pytest.approx(log.range_max, abs=1e-4)
    # Odometry reassociated by timestamp; same stamps => exact x/y, yaw via
    # quaternion round-trip.
    np.testing.assert_allclose(back.odoms, log.odoms, atol=1e-9)


def test_bag_topic_selection_and_missing(tmp_path):
    log = _small_log()
    path = str(tmp_path / "t.bag")
    rosbag.write_bag(
        path, log.ranges, log.timestamps, log.angle_min, log.angle_increment,
        log.range_max, scan_topic="/front/scan",
    )
    back = rosbag.read_bag(path, scan_topic="/front/scan")
    assert back.ranges.shape == log.ranges.shape
    with pytest.raises(IOError, match="no sensor_msgs/LaserScan"):
        rosbag.read_bag(path, scan_topic="/back/scan")
    with pytest.raises(IOError, match="not a ROS bag"):
        bad = str(tmp_path / "bad.bag")
        open(bad, "wb").write(b"nope")
        rosbag.read_bag(bad)


def test_csv_roundtrip(tmp_path):
    log = _small_log()
    path = str(tmp_path / "rt.csv")
    importers.write_scan_csv(
        path, log.ranges, log.timestamps, log.angle_min, log.angle_increment,
        log.range_max, odoms=np.asarray(log.odoms),
    )
    back = importers.read_scan_csv(path)
    np.testing.assert_allclose(back.ranges, log.ranges, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back.odoms, log.odoms, atol=1e-12)
    assert back.angle_increment == pytest.approx(log.angle_increment)


def test_bag_convert_cli(tmp_path):
    import sys

    sys.path.insert(0, os.path.join(HERE, "..", "tools"))
    import bag_convert

    log = _small_log()
    src = str(tmp_path / "src.bag")
    rosbag.write_bag(
        src, log.ranges, log.timestamps, log.angle_min, log.angle_increment,
        log.range_max, odoms=np.asarray(log.odoms),
    )
    npz = str(tmp_path / "out.npz")
    assert bag_convert.main([src, npz]) == 0
    d = np.load(npz)
    np.testing.assert_allclose(d["ranges"], log.ranges, atol=0)
    csv = str(tmp_path / "out.csv")
    assert bag_convert.main([npz, csv]) == 0
    back = importers.read_scan_csv(csv)
    assert back.ranges.shape == log.ranges.shape
    bag2 = str(tmp_path / "back.bag")
    assert bag_convert.main([csv, bag2]) == 0
    again = rosbag.read_bag(bag2)
    np.testing.assert_allclose(again.ranges, log.ranges, rtol=1e-5, atol=1e-4)


def test_fixture_end_to_end_slam(tmp_path):
    """SLAM over the committed realistic bag: track ground truth through
    noise, 5% dropout, and moving clutter; beat the drifting odometry; and
    produce the trajectory-overlay PNG (the reference's RViz comparison,
    `src/test/path_publisher`)."""
    from ndtpso_slam.node import NodeConfig, SlamNode

    log = importers.load_log(FIXTURE)
    gt = np.load(FIXTURE_GT)
    assert log.ranges.shape == (60, 540)

    cfg = NodeConfig(
        frame_size_m=48.0, cell_side_m=1.0, window_slots=8, max_beams=540,
        pso_iterations=30, pso_population=50, cost_mode="fast_local",
        build_og=False,
    )
    node = SlamNode(cfg, verbose=False)
    # Start from the odometry's initial pose, as a real deployment would.
    node.state = node.state.replace(
        pose=node.state.pose * 0 + np.float32(log.odoms[0]),
        align=node.state.align.replace(
            prev_pose=node.state.align.prev_pose * 0 + np.float32(log.odoms[0])
        ),
    )
    poses = node.run_log(log)

    err = np.hypot(poses[:, 0] - gt[:, 0], poses[:, 1] - gt[:, 1])
    odo_err = np.hypot(log.odoms[:, 0] - gt[:, 0], log.odoms[:, 1] - gt[:, 1])
    assert err.max() < 0.3, f"realistic-data trajectory error {err.max():.3f} m"
    assert err[-1] < odo_err[-1], "SLAM should end closer to truth than odometry"

    files = node.shutdown(str(tmp_path / "real"))
    pose_csv = [f for f in files if f.endswith(".pose.csv")]
    assert pose_csv, files
    import sys

    sys.path.insert(0, os.path.join(HERE, "..", "tools"))
    import path_publisher

    out_png = str(tmp_path / "overlay.png")
    assert path_publisher.main([pose_csv[0], "--out", out_png]) == 0
    assert os.path.getsize(out_png) > 100
