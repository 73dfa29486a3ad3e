"""PSO solver: protocol parity with the oracle, convergence, determinism."""

import jax.numpy as jnp
import numpy as np

from ndtpso_slam.config import PSOConfig
from ndtpso_slam.models.pso import glir_pso_solve, pso_solve
from oracle import oracle_pso

KEY = (np.uint32(11), np.uint32(22))


def _quad_cost_np(target):
    def f(pose):
        d = pose - target
        return float(d @ d)

    return f


def _quad_cost_jax(target):
    t = jnp.asarray(target, jnp.float32)

    def f(poses, bind):
        d = poses - t
        return jnp.sum(d * d, axis=-1)

    return f


def test_pso_matches_oracle_on_analytic_cost():
    target = np.array([0.35, -0.2, 0.08])
    cfg = PSOConfig(iterations=25, population=16)
    guess = np.zeros(3, np.float32)
    dev = np.array([0.5, 0.5, 0.2], np.float32)
    res = pso_solve(KEY, jnp.asarray(guess), jnp.asarray(dev), _quad_cost_jax(target), cfg)
    opose, ocost = oracle_pso(
        KEY, guess, dev, _quad_cost_np(target), cfg.iterations, cfg.population,
        w=cfg.w, c1=cfg.c1, c2=cfg.c2, w_damping=cfg.w_damping,
    )
    # Same Threefry stream, same synchronous update rule: f32 vs f64 drift only.
    np.testing.assert_allclose(np.asarray(res.pose), opose, atol=5e-4)
    np.testing.assert_allclose(float(res.cost), ocost, atol=1e-4)


def test_pso_converges_to_target():
    target = np.array([0.1, 0.25, -0.05])
    cfg = PSOConfig(iterations=50, population=50)
    res = pso_solve(
        KEY,
        jnp.zeros(3, jnp.float32),
        jnp.asarray([0.5, 0.5, 0.3], jnp.float32),
        _quad_cost_jax(target),
        cfg,
    )
    np.testing.assert_allclose(np.asarray(res.pose), target, atol=2e-3)


def test_pso_deterministic():
    cfg = PSOConfig(iterations=10, population=8)
    f = _quad_cost_jax(np.array([0.2, 0.0, 0.0]))
    a = pso_solve(KEY, jnp.zeros(3), jnp.asarray([0.3, 0.3, 0.1]), f, cfg)
    b = pso_solve(KEY, jnp.zeros(3), jnp.asarray([0.3, 0.3, 0.1]), f, cfg)
    np.testing.assert_array_equal(np.asarray(a.pose), np.asarray(b.pose))
    c = pso_solve((np.uint32(1), np.uint32(2)), jnp.zeros(3), jnp.asarray([0.3, 0.3, 0.1]), f, cfg)
    assert not np.array_equal(np.asarray(a.pose), np.asarray(c.pose))


def test_pso_respects_w_damping():
    # With damping < 1 the swarm cools; result should still converge.
    cfg = PSOConfig(iterations=40, population=30, w_damping=0.95)
    target = np.array([-0.15, 0.1, 0.02])
    res = pso_solve(
        KEY, jnp.zeros(3), jnp.asarray([0.4, 0.4, 0.2]), _quad_cost_jax(target), cfg
    )
    np.testing.assert_allclose(np.asarray(res.pose), target, atol=5e-3)


def test_glir_pso_runs_and_improves():
    cfg = PSOConfig(iterations=30, population=30)
    target = np.array([0.2, -0.1, 0.05])
    f = _quad_cost_jax(target)
    res = glir_pso_solve(
        KEY, jnp.zeros(3, jnp.float32), jnp.asarray([0.4, 0.4, 0.2], jnp.float32), f, cfg
    )
    init_cost = float(f(jnp.zeros((1, 3)), None)[0])
    assert float(res.cost) < init_cost
    assert np.all(np.isfinite(np.asarray(res.pose)))
