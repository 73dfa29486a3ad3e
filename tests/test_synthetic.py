"""Synthetic data generators (io/synthetic.py): the swept (motion-distorted)
raycaster and the soak world/log used by `bench.py --soak`."""

import numpy as np

from ndtpso_slam.io import synthetic


def test_raycast_swept_degenerates_to_rigid():
    """With zero motion over the sweep, the swept raycaster IS the rigid
    one, bit-for-bit."""
    segs = synthetic.make_world(seed=4, size=30.0)
    pose = np.array([1.0, -2.0, 0.3])
    r_rigid = synthetic.raycast(segs, pose, 90, -np.pi, 2 * np.pi / 90, 25.0)
    r_swept = synthetic.raycast_swept(
        segs, pose, pose, 90, -np.pi, 2 * np.pi / 90, 25.0
    )
    np.testing.assert_array_equal(r_rigid, r_swept)


def test_raycast_swept_skews_with_motion():
    """A moving sensor must measurably distort the scan: late beams see the
    world from the advanced pose, early beams from the start pose."""
    segs = synthetic.make_world(seed=4, size=30.0)
    p0 = np.array([0.0, 0.0, 0.0])
    p1 = np.array([0.3, 0.1, 0.05])  # ~one LiDAR period of brisk motion
    r_rigid = synthetic.raycast(segs, p0, 180, -np.pi, 2 * np.pi / 180, 25.0)
    r_swept = synthetic.raycast_swept(
        segs, p0, p1, 180, -np.pi, 2 * np.pi / 180, 25.0
    )
    both = (r_rigid > 0) & (r_swept > 0)
    # First beams fire from ~p0: near-identical (beam 0 exactly).
    assert r_swept[0] == r_rigid[0]
    head = both[:3]
    np.testing.assert_allclose(
        r_swept[:3][head], r_rigid[:3][head], atol=0.05
    )
    # Across the sweep the skew must be visible (cm-dm scale somewhere).
    assert np.abs(r_swept[both] - r_rigid[both]).max() > 0.05


def test_make_soak_log_shape_and_coverage():
    lg = synthetic.make_soak_log(seed=1, n_scans=40, n_beams=90)
    assert lg.ranges.shape == (40, 90)
    # Pillar hall: every scan must see structure (no featureless scans).
    frac_hit = (lg.ranges > 0).mean(axis=1)
    # ~a quarter of beams returning (pillars + the near wall) is plenty for
    # matching; the guard is against *featureless* scans in open space.
    assert frac_hit.min() > 0.2, f"featureless scan: {frac_hit.min():.2f}"
    # The loop traverses: total path length scales with the loop radius.
    d = np.diff(lg.poses[:, :2], axis=0)
    path = np.hypot(d[:, 0], d[:, 1]).sum()
    assert path > 4.0  # 40/1200 of a ~157 m loop
