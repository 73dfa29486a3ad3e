"""Laser-scan ingestion semantics (`NDTFrame::loadLaser`, ndtframe.cpp:144-185)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ndtpso_slam.config import MapConfig, ScanConfig
from ndtpso_slam.models.scan import load_laser

CFG = ScanConfig(max_beams=16, ignore_epsilon=0.1)


def test_range_filters():
    # > 0, < max_range, > epsilon (ndtframe.cpp:165)
    ranges = np.array([0.0, 0.05, 0.1, 0.11, 5.0, 29.9, 30.0, 35.0], np.float32)
    sc = load_laser(ranges, 0.0, 0.1, 30.0, CFG)
    valid = np.asarray(sc.valid)[:8]
    assert list(valid) == [False, False, False, True, True, True, False, False]


def test_polar_conversion_and_angles():
    ranges = np.full(4, 2.0, np.float32)
    sc = load_laser(ranges, 0.0, np.pi / 2, 30.0, CFG)
    p = np.asarray(sc.points)[:4]
    np.testing.assert_allclose(p[0], [2, 0], atol=1e-6)
    np.testing.assert_allclose(p[1], [0, 2], atol=1e-6)
    np.testing.assert_allclose(p[2], [-2, 0], atol=1e-6)
    np.testing.assert_allclose(p[3], [0, -2], atol=1e-6)


def test_padding_is_invalid():
    sc = load_laser(np.full(4, 2.0, np.float32), 0.0, 0.1, 30.0, CFG)
    assert sc.points.shape == (16, 2)
    assert not np.asarray(sc.valid)[4:].any()


def test_mount_transform_applied():
    # TRANSFORM_POINTS_AT_LOAD with a latched base<-scan transform
    # (ndtframe.cpp:174-177): x-forward 0.65 m like launch/scan.launch.
    ranges = np.array([1.0], np.float32)
    mount = np.array([0.65, 0.0, np.pi / 2], np.float32)
    sc = load_laser(ranges, 0.0, 0.1, 30.0, CFG, mount=mount)
    np.testing.assert_allclose(np.asarray(sc.points)[0], [0.65, 1.0], atol=1e-6)
    # near-zero mount is skipped entirely
    sc2 = load_laser(ranges, 0.0, 0.1, 30.0, CFG, mount=np.zeros(3, np.float32))
    np.testing.assert_allclose(np.asarray(sc2.points)[0], [1.0, 0.0], atol=1e-6)


def test_frame_border_invalidation():
    # Points outside the map frame are dropped at load, like addPoint's
    # bounds check (ndtframe.cpp:220-223).
    map_cfg = MapConfig(size_m=4.0, cell_side_m=1.0)
    ranges = np.array([1.0, 3.0], np.float32)
    sc = load_laser(ranges, 0.0, 0.0, 30.0, ScanConfig(max_beams=4), map_cfg)
    valid = np.asarray(sc.valid)
    assert valid[0] and not valid[1]  # 3.0 > half size 2.0


def test_oversized_scan_rejected():
    with pytest.raises(AssertionError, match="max_beams"):
        load_laser(np.ones(20, np.float32), 0.0, 0.1, 30.0, CFG)


def test_prefer_frontal_points_matches_reference_loop():
    """PREFER_FRONTAL_POINTS (`ndtframe.cpp:157-182`, compile-time off
    upstream): the lax.scan threshold-accumulator must reproduce the
    reference's sequential accumulate-test-reset loop exactly, including
    invalid beams leaving the accumulator untouched."""
    rs = np.random.RandomState(7)
    n = 360
    ranges = rs.uniform(0.5, 20.0, n).astype(np.float32)
    ranges[rs.rand(n) < 0.15] = 0.0  # dropouts interleaved
    angle_min, inc, rmax = -np.pi, 2 * np.pi / n, 30.0
    cfg = ScanConfig(max_beams=512, prefer_frontal_points=True)
    sc = load_laser(ranges, angle_min, inc, rmax, cfg)
    got = np.asarray(sc.valid)

    # Reference loop in plain numpy (float32 accumulator, like the C++).
    want = np.zeros(512, bool)
    delta = np.float32(0.0)
    for i in range(n):
        if 0.0 < ranges[i] < rmax and ranges[i] > cfg.ignore_epsilon:
            # f32 throughout, matching load_laser's index_to_angle
            # (idx * step + min_angle on f32 operands).
            theta = np.float32(i) * np.float32(inc) + np.float32(angle_min)
            delta = np.float32(delta + np.float32(np.cos(theta)))
            if abs(delta) > 0.5:
                want[i] = True
                delta = np.float32(0.0)
    np.testing.assert_array_equal(got, want)
    # Decimation actually decimates: side-looking beams thinned, frontal
    # kept — overall fewer beams than the undecimated load.
    base = load_laser(ranges, angle_min, inc, rmax,
                      ScanConfig(max_beams=512))
    assert got.sum() < np.asarray(base.valid).sum()
    assert got.sum() > 0
