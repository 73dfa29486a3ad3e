"""Per-cell 2x2 Gaussian math in closed form.

The reference fits an unnormalized Gaussian per NDT cell and regularizes the
covariance through its eigenvalues with a LAPACK eigensolve
(`NDTCell::s_calc_covar_inverse`, `ndtcell.cpp:93-111`).  A symmetric 2x2
eigenproblem is analytic, so here it is a handful of elementwise ops over dense
[H*W] cell arrays — no solver, no loop.

Symmetric 2x2 matrices are packed as 3-vectors ``(xx, xy, yy)`` throughout.
"""

from __future__ import annotations

import jax.numpy as jnp

# Eigenvalue regularization threshold (`ndtcell.cpp:103`).
EIG_RATIO = 1e-3


def sym2_eigenvalues(cov3: jnp.ndarray):
    """Eigenvalues of symmetric 2x2 matrices, (large, small).

    cov3: [..., 3] packed (xx, xy, yy).
    """
    a, b, c = cov3[..., 0], cov3[..., 1], cov3[..., 2]
    half_tr = (a + c) / 2.0
    disc = jnp.sqrt(jnp.square((a - c) / 2.0) + jnp.square(b))
    return half_tr + disc, half_tr - disc


def regularized_inverse(cov3: jnp.ndarray) -> jnp.ndarray:
    """Regularized inverse of packed symmetric 2x2 covariances.

    Replicates `ndtcell.cpp:93-111`: if the small eigenvalue is below
    ``1e-3 * large``, the determinant used for the adjugate inverse is replaced
    by ``1e-3 * large^2``; otherwise the true determinant is used.  Degenerate
    all-zero covariances produce inf/nan exactly as the C++ does (IEEE
    division) — callers mask by `built`, and `count > 2` cells with coincident
    points are as pathological here as upstream.

    Returns [..., 3] packed inverse (ixx, ixy, iyy).
    """
    a, b, c = cov3[..., 0], cov3[..., 1], cov3[..., 2]
    large, small = sym2_eigenvalues(cov3)
    det = jnp.where(small < EIG_RATIO * large, EIG_RATIO * large * large, a * c - b * b)
    return jnp.stack([c / det, -b / det, a / det], axis=-1)


def quadform(icov3: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """d' Σ⁻¹ d for packed symmetric Σ⁻¹: [..., 3] x [..., 2] -> [...]."""
    dx, dy = d[..., 0], d[..., 1]
    return icov3[..., 0] * dx * dx + 2.0 * icov3[..., 1] * dx * dy + icov3[..., 2] * dy * dy


def ndt_score(d: jnp.ndarray, icov3: jnp.ndarray, built) -> jnp.ndarray:
    """Unnormalized Gaussian score exp(-d'Σ⁻¹d / 2), 0 when not built.

    Replicates `NDTCell::normalDistribution` (`ndtcell.cpp:70-78`): the score
    is deliberately unnormalized (no 1/(2π√detΣ) factor), matching the
    reference's cost landscape exactly.
    """
    return jnp.where(built, jnp.exp(-0.5 * quadform(icov3, d)), 0.0)
