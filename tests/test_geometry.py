"""SE(2)/polar geometry vs direct NumPy oracles."""

import numpy as np

from ndtpso_slam.ops import geometry


def _np_transform(points, pose):
    c, s = np.cos(pose[2]), np.sin(pose[2])
    return np.stack(
        [
            points[:, 0] * c - points[:, 1] * s + pose[0],
            points[:, 0] * s + points[:, 1] * c + pose[1],
        ],
        axis=-1,
    )


def test_transform_points_matches_oracle():
    rs = np.random.RandomState(0)
    pts = rs.uniform(-10, 10, (100, 2)).astype(np.float32)
    pose = np.array([1.5, -2.0, 0.7], np.float32)
    out = np.asarray(geometry.transform_points(pts, pose))
    np.testing.assert_allclose(out, _np_transform(pts, pose), rtol=1e-5, atol=1e-5)


def test_transform_points_batched_poses():
    rs = np.random.RandomState(1)
    pts = rs.uniform(-5, 5, (20, 2)).astype(np.float32)
    poses = rs.uniform(-1, 1, (7, 3)).astype(np.float32)
    out = np.asarray(geometry.transform_points(pts, poses))
    assert out.shape == (7, 20, 2)
    for i in range(7):
        np.testing.assert_allclose(
            out[i], _np_transform(pts, poses[i]), rtol=1e-5, atol=1e-5
        )


def test_polar_roundtrip():
    r = np.array([1.0, 2.5, 30.0], np.float32)
    th = np.array([0.0, np.pi / 3, -2.0], np.float32)
    p = np.asarray(geometry.polar_to_point(r, th))
    np.testing.assert_allclose(np.hypot(p[:, 0], p[:, 1]), r, rtol=1e-5)
    np.testing.assert_allclose(np.arctan2(p[:, 1], p[:, 0]), th, rtol=1e-4, atol=1e-5)


def test_cell_index_matches_reference_formula():
    size, cell, w = 20.0, 0.5, 40
    rs = np.random.RandomState(2)
    pts = rs.uniform(-12, 12, (500, 2))
    idx, inb = geometry.cell_index(
        pts.astype(np.float32), size_m=size, cell_side_m=cell, cells_per_side=w
    )
    idx, inb = np.asarray(idx), np.asarray(inb)
    for k in range(500):
        x, y = pts[k]
        expect_in = -10 < x < 10 and -10 < y < 10
        assert inb[k] == expect_in
        if expect_in:
            ref = int(np.floor((x + 10) / cell) + w * np.floor((y + 10) / cell))
            assert idx[k] == ref


def test_cell_index_border_strictness():
    # Borders are strictly outside (`ndtframe.cpp:242`).
    pts = np.array([[10.0, 0.0], [-10.0, 0.0], [0.0, 10.0], [9.999, 9.999]], np.float64)
    _, inb = geometry.cell_index(pts, size_m=20.0, cell_side_m=0.5, cells_per_side=40)
    assert list(np.asarray(inb)) == [False, False, False, True]


def test_se2_compose_inverse():
    a = np.array([1.0, 2.0, 0.5], np.float32)
    ainv = np.asarray(geometry.se2_inverse(a))
    ident = np.asarray(geometry.se2_compose(a, ainv))
    np.testing.assert_allclose(ident, [0, 0, 0], atol=1e-6)
    pts = np.array([[3.0, 4.0]], np.float32)
    via_compose = np.asarray(
        geometry.transform_points(pts, geometry.se2_compose(a, a))
    )
    twice = np.asarray(
        geometry.transform_points(geometry.transform_points(pts, a), a)
    )
    np.testing.assert_allclose(via_compose, twice, rtol=1e-5, atol=1e-5)
