"""Closed-form 2x2 Gaussian math vs LAPACK-based oracle."""

import numpy as np

from ndtpso_slam.ops import gaussian
from oracle import OracleCell


def _pack(m):
    return np.array([m[0, 0], m[0, 1], m[1, 1]])


def test_eigenvalues_match_lapack():
    rs = np.random.RandomState(0)
    for _ in range(50):
        a = rs.randn(2, 2)
        cov = a @ a.T
        large, small = gaussian.sym2_eigenvalues(_pack(cov).astype(np.float64))
        ev = np.linalg.eigvalsh(cov)
        np.testing.assert_allclose(float(large), ev[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(small), ev[0], rtol=1e-5, atol=1e-6)


def test_regularized_inverse_well_conditioned():
    rs = np.random.RandomState(1)
    for _ in range(50):
        a = rs.randn(2, 2)
        cov = a @ a.T + 0.5 * np.eye(2)
        inv3 = np.asarray(gaussian.regularized_inverse(_pack(cov)))
        ev = np.linalg.eigvalsh(cov)
        if ev[0] >= 1e-3 * ev[1]:  # unregularized branch
            expect = np.linalg.inv(cov)
            np.testing.assert_allclose(
                inv3, _pack(expect), rtol=2e-4, atol=1e-5
            )


def test_regularized_inverse_degenerate_matches_cell_oracle():
    # Thin covariance: regularized determinant branch (`ndtcell.cpp:103-105`).
    d = np.array([3.0, 1.0])
    cov = np.outer(d, d) + 1e-9 * np.eye(2)
    inv3 = np.asarray(gaussian.regularized_inverse(_pack(cov).astype(np.float64)))
    cell = OracleCell()
    cell.g_cov = cov * 4.0
    cell.g_count = 4
    cell._calc_inv()
    np.testing.assert_allclose(inv3, _pack(cell.inv_cov), rtol=2e-4)


def test_ndt_score_matches_cell():
    rs = np.random.RandomState(2)
    cell = OracleCell()
    pts = rs.normal([1.0, 2.0], [0.3, 0.5], (20, 2))
    for p in pts:
        cell.add_point(p)
    cell.build()
    assert cell.built
    q = np.array([1.1, 2.2])
    d = q - cell.mean
    ours = float(
        gaussian.ndt_score(
            d.astype(np.float64), _pack(cell.inv_cov).astype(np.float64), True
        )
    )
    np.testing.assert_allclose(ours, cell.score(q), rtol=1e-5)
    assert float(gaussian.ndt_score(d, _pack(cell.inv_cov), False)) == 0.0
