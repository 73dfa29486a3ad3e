"""Whole-solve PSO kernel vs the XLA solver (Triton route, interpret mode on
the CPU).

The rollout kernel re-implements, in one program per solve, the frozen
pieces the XLA path uses: the Threefry draw protocol (ops/rng.py), the
stencil rebind (models/cost.py:bind_points_local), and the synchronous-gbest
PSO update (models/pso.py).  These tests pin each piece to its XLA
counterpart, and check that the kernel lowers for the GPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ndtpso_slam import config as cfgm
from ndtpso_slam.models import ndt_map
from ndtpso_slam.ops import rng
from ndtpso_slam.ops import pallas_rollout as pr
from ndtpso_slam.parallel import mesh as mesh_mod

MAP_CFG = cfgm.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)


@pytest.fixture(scope="module")
def world():
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    pts = np.stack([9 * np.cos(t), 6 * np.sin(t)], -1) + rs.normal(0, 0.05, (200, 2))
    pts = pts.astype(np.float32)
    state = ndt_map.init_map(MAP_CFG)
    for _ in range(2):
        state = ndt_map.add_points(
            state, MAP_CFG, pts + rs.normal(0, 0.02, pts.shape).astype(np.float32),
            np.ones(200, bool),
        )
        state = ndt_map.build(state, MAP_CFG)
    return ndt_map.snapshot(state, MAP_CFG), pts


def _batch(world, b, n_pad=256):
    """Batch of solves with the point set padded to N = n_pad."""
    snap, pts = world
    n = pts.shape[0]
    rs = np.random.RandomState(1)
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32)
    guesses = rs.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)
    devs = np.tile(np.float32([0.2, 0.2, 0.05]), (b, 1))
    points = np.zeros((b, n_pad, 2), np.float32)
    points[:, :n] = pts[None]
    valid = np.zeros((b, n_pad), bool)
    valid[:, :n] = True
    snaps = jax.tree_util.tree_map(
        lambda x: jnp.tile(x[None], (b,) + (1,) * x.ndim), snap
    )
    return keys, guesses, devs, snaps, points, valid


def test_threefry_kernel_matches_rng_protocol():
    """The kernel's in-lined Threefry/uniform helpers are the plain-jnp
    functions of ops/rng.py — bit-identical streams."""
    key = (np.uint32(0xDEADBEEF), np.uint32(0x12345))
    ctr = np.arange(4096, dtype=np.uint32).reshape(8, 512)
    u0_ref, u1_ref = rng.uniform_pairs(key, ctr)
    u0_k, u1_k = pr._uniform_pairs(
        jnp.uint32(key[0]), jnp.uint32(key[1]), jnp.asarray(ctr)
    )
    np.testing.assert_array_equal(np.asarray(u0_ref), np.asarray(u0_k))
    np.testing.assert_array_equal(np.asarray(u1_ref), np.asarray(u1_k))


def test_rollout_matches_fast_local(world):
    """rollout (whole solve in one kernel program) == fast_local (XLA loop,
    same stencil semantics, same Threefry streams) up to reduction order."""
    keys, guesses, devs, snaps, points, valid = _batch(world, b=4)
    cfg = cfgm.PSOConfig(iterations=10, population=128)
    r_ref = mesh_mod.solve_batch(
        keys, guesses, devs, snaps, points, valid, MAP_CFG, cfg, "fast_local"
    )
    r_roll = mesh_mod.solve_batch(
        keys, guesses, devs, snaps, points, valid, MAP_CFG, cfg, "rollout"
    )
    np.testing.assert_allclose(
        np.asarray(r_ref.cost), np.asarray(r_roll.cost), rtol=1e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(r_ref.pose), np.asarray(r_roll.pose), atol=5e-3
    )


def test_rollout_converges_to_truth(world):
    """End-to-end: rollout solves recover a known SE(2) offset."""
    snap, pts = world
    true = np.float32([0.15, -0.1, 0.04])
    c, s = np.cos(true[2]), np.sin(true[2])
    moved = np.stack(
        [pts[:, 0] * c - pts[:, 1] * s + true[0],
         pts[:, 0] * s + pts[:, 1] * c + true[1]], -1
    ).astype(np.float32)
    # Solve for the pose that maps `moved` back onto the map built at identity
    # => expected pose = inverse of `true` applied... the solver finds the pose
    # minimizing cost of transform(moved_inv_points); use the standard setup:
    # query points are the world seen from `true`, so align() should return
    # ~`-true`-composed... simplest: transform by -true recovers pts, so the
    # optimum pose p satisfies R(p)·q + t = map points with q = R(true)·pts +
    # t_true; p = inverse(true).
    inv = np.float32([-(true[0] * c + true[1] * s),
                      true[0] * s - true[1] * c, -true[2]])
    keys, guesses, devs, snaps, points, valid = _batch(world, b=2)
    points[:, :200] = moved[None]
    cfg = cfgm.PSOConfig(iterations=20, population=256)
    res = mesh_mod.solve_batch(
        keys, guesses, devs, snaps, points, valid, MAP_CFG, cfg, "rollout"
    )
    pose = np.asarray(res.pose)
    assert np.abs(pose[:, :2] - inv[None, :2]).max() < 0.05
    assert np.abs(pose[:, 2] - inv[2]).max() < 0.02


@pytest.mark.parametrize("population", [50, 200])
def test_rollout_masked_population_matches_fast_local(world, population):
    """Populations that are no multiple of the particle tile run with a
    masked tail; the real particles consume the exact ops/rng.py Threefry
    counters of a P=population jnp solve, so the result matches fast_local
    at the same budget.  P=50 is the reference's own
    launch budget (`scan.launch:11-13`)."""
    keys, guesses, devs, snaps, points, valid = _batch(world, b=3)
    cfg = cfgm.PSOConfig(iterations=10, population=population)
    r_ref = mesh_mod.solve_batch(
        keys, guesses, devs, snaps, points, valid, MAP_CFG, cfg, "fast_local"
    )
    r_roll = mesh_mod.solve_batch(
        keys, guesses, devs, snaps, points, valid, MAP_CFG, cfg, "rollout"
    )
    np.testing.assert_allclose(
        np.asarray(r_ref.cost), np.asarray(r_roll.cost), rtol=1e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(r_ref.pose), np.asarray(r_roll.pose), atol=5e-3
    )


def test_slam_rollout_runs_reference_budget(world):
    """The node's default 50-particle budget goes through the rollout cost
    mode end-to-end (models/slam.py:_align_rollout)."""
    from ndtpso_slam.models import slam as slam_mod
    from ndtpso_slam.models.scan import Scan

    snap, pts = world
    cfg = cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=8, population=50),
        map=MAP_CFG,
        scan=cfgm.ScanConfig(max_beams=256),
        cost_mode="rollout",
    )
    n_pad = 256
    points = np.zeros((n_pad, 2), np.float32)
    points[:200] = pts
    valid = np.zeros(n_pad, bool)
    valid[:200] = True
    astate = slam_mod.AlignState(
        prev_pose=jnp.zeros(3, jnp.float32),
        pose_diff=jnp.zeros(3, jnp.float32),
        iter=jnp.asarray(0, jnp.int32),  # cold start -> first_deviation
    )
    scan = Scan(points=jnp.asarray(points), valid=jnp.asarray(valid))
    _, res = slam_mod.align(
        (np.uint32(5), np.uint32(7)), astate, snap, scan,
        jnp.zeros(3, jnp.float32), cfg,
    )
    pose = np.asarray(res.pose)
    assert np.abs(pose[:2]).max() < 0.1 and abs(pose[2]) < 0.05
    assert np.isfinite(float(res.cost))


def test_multi_swarm_rollout_relocalizes(world):
    """Island-model multiswarm through the rollout kernel: spread hypotheses
    against one shared map, exact-cost final merge picks the true basin
    (parallel/multi_swarm.py:multi_swarm_rollout)."""
    from ndtpso_slam.parallel.multi_swarm import multi_swarm_rollout

    snap, pts = world
    true = np.float32([0.3, -0.2, 0.05])
    c, s = np.cos(true[2]), np.sin(true[2])
    moved = np.stack(
        [pts[:, 0] * c - pts[:, 1] * s + true[0],
         pts[:, 0] * s + pts[:, 1] * c + true[1]], -1
    ).astype(np.float32)
    inv = np.float32([-(true[0] * c + true[1] * s),
                      true[0] * s - true[1] * c, -true[2]])
    n_pad = 256
    points = np.zeros((n_pad, 2), np.float32)
    points[:200] = moved
    valid = np.zeros(n_pad, bool)
    valid[:200] = True
    rs = np.random.RandomState(7)
    k = 4
    keys = rs.randint(0, 2**31, (k, 2)).astype(np.uint32)
    # One hypothesis near the truth, the rest far off — the exact-cost merge
    # must pick the true basin's swarm.
    hypo = inv + rs.uniform(-1.0, 1.0, (k, 3)).astype(np.float32) * np.float32(
        [1, 1, 0.1]
    )
    hypo[1] = inv + np.float32([0.15, -0.1, 0.02])
    cfg = cfgm.PSOConfig(iterations=15, population=128)
    res = multi_swarm_rollout(
        jnp.asarray(keys), jnp.asarray(hypo), np.float32([0.4, 0.4, 0.08]),
        snap, jnp.asarray(points), jnp.asarray(valid), cfg, MAP_CFG,
    )
    pose = np.asarray(res.pose)
    assert np.abs(pose[:2] - inv[:2]).max() < 0.07
    assert abs(pose[2] - inv[2]) < 0.03
    # The merged cost is the exact NDT objective of the returned pose.
    from ndtpso_slam.models import cost as cost_mod

    expected = cost_mod.ndt_cost(
        pose[None].astype(np.float32), snap, jnp.asarray(points),
        jnp.asarray(valid), MAP_CFG,
    )[0]
    np.testing.assert_allclose(float(res.cost), float(expected), rtol=1e-5)


def test_rollout_early_exit_semantics(world):
    """early_exit=K makes iterations a CAP: with K >= iterations the loop
    can never trip before the budget, so results are bitwise the fixed-
    budget kernel's; small K still returns finite, accurate solves."""
    from ndtpso_slam.models import cost as cost_mod
    from ndtpso_slam.ops.pallas_rollout import (
        pack_rollout_inputs, pso_rollout,
    )

    keys, guesses, devs, snaps, points, valid = _batch(world, b=3)
    cfg = cfgm.PSOConfig(iterations=10, population=128)
    nbrs = jax.vmap(
        lambda g, s, p, v: cost_mod.bind_neighborhood(
            g, s, p, v, MAP_CFG, radius=cost_mod.DEFAULT_STENCIL_RADIUS
        )
    )(jnp.asarray(guesses), snaps, jnp.asarray(points), jnp.asarray(valid))
    sten, pts = jax.vmap(pack_rollout_inputs)(nbrs, jnp.asarray(points))
    kw = dict(cfg=cfg, map_cfg=MAP_CFG, radius=cost_mod.DEFAULT_STENCIL_RADIUS)
    p0, c0 = pso_rollout(keys, guesses, devs, sten, pts, **kw)
    p1, c1 = pso_rollout(keys, guesses, devs, sten, pts, early_exit=10, **kw)
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
    p2, c2 = pso_rollout(keys, guesses, devs, sten, pts, early_exit=2, **kw)
    assert np.isfinite(np.asarray(p2)).all()
    # An early-exited best can only be the same or worse than the full
    # budget's (the loop monotonically improves gbest).
    assert (np.asarray(c2) >= np.asarray(c0) - 1e-6).all()




def _packed(world, b, n_pad, population=128):
    """A batch plus its packed kernel inputs (stencil bound at the guess)."""
    from ndtpso_slam.models import cost as cost_mod

    keys, guesses, devs, snaps, points, valid = _batch(world, b, n_pad)
    nbrs = jax.vmap(
        lambda g, s, p, v: cost_mod.bind_neighborhood(
            g, s, p, v, MAP_CFG, radius=cost_mod.DEFAULT_STENCIL_RADIUS
        )
    )(jnp.asarray(guesses), snaps, jnp.asarray(points), jnp.asarray(valid))
    sten, pts = jax.vmap(pr.pack_rollout_inputs)(nbrs, jnp.asarray(points))
    return keys, guesses, devs, snaps, points, valid, nbrs, sten, pts


def test_solve_batch_forwards_early_exit_to_rollout(world):
    """solve_batch(cost_mode='rollout', early_exit=K) forwards K to the
    kernel: the batch result equals a direct pso_rollout call with the same
    K, and a tight K differs from the K=0 fixed-budget run."""
    keys, guesses, devs, snaps, points, valid, _, sten, pts = _packed(world, 3, 256)
    cfg = cfgm.PSOConfig(iterations=12, population=64)
    batch = lambda k: mesh_mod.solve_batch(
        keys, guesses, devs, snaps, points, valid, MAP_CFG, cfg,
        cost_mode="rollout", early_exit=k,
    )
    r1 = batch(1)
    pd, cd = pr.pso_rollout(keys, guesses, devs, sten, pts, cfg, MAP_CFG,
                            early_exit=1)
    np.testing.assert_array_equal(np.asarray(r1.pose), np.asarray(pd))
    np.testing.assert_array_equal(np.asarray(r1.cost), np.asarray(cd))
    r0 = batch(0)
    assert not np.array_equal(np.asarray(r1.cost), np.asarray(r0.cost)), (
        "early_exit=1 produced the fixed-budget result on every solve — "
        "the flag is not reaching the kernel"
    )


@pytest.mark.parametrize("n_points, population", [(256, 128), (200, 70)])
def test_rollout_scores_match_bound_cost(world, n_points, population):
    """The kernel's coefficient build + tile score == bound_cost of
    bind_points_local at the same binding, float32 throughout (the order of
    the sums differs, so to rounding).  200 points / 70 poses leave ragged
    tails on both tiled axes."""
    from ndtpso_slam.models import cost as cost_mod

    _, guesses, _, _, points, _, nbrs, sten, pts = _packed(world, 2, n_points)
    rs = np.random.RandomState(3)
    poses = jnp.asarray(
        guesses[:, None, :]
        + rs.uniform(-0.3, 0.3, (2, population, 3)).astype(np.float32)
        * np.float32([1, 1, 0.1])
    )
    binds = jnp.asarray(guesses) + jnp.float32([0.05, -0.04, 0.01])
    got = pr.rollout_scores(poses, binds, sten, pts, MAP_CFG)
    want = jax.vmap(
        lambda p, g, nb, q: cost_mod.bound_cost(
            p, cost_mod.bind_points_local(g, nb, q, MAP_CFG)
        )
    )(poses, binds, nbrs, jnp.asarray(points))
    assert got.shape == (2, population)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-3)


def test_rollout_unpadded_360_beams_matches_fast_local(world):
    """A 360-beam buffer (no multiple of any tile) runs through the kernel
    and matches the XLA loop on the same Threefry streams."""
    keys, guesses, devs, snaps, points, valid = _batch(world, b=2, n_pad=360)
    cfg = cfgm.PSOConfig(iterations=8, population=96)
    r_ref = mesh_mod.solve_batch(
        keys, guesses, devs, snaps, points, valid, MAP_CFG, cfg, "fast_local"
    )
    r_roll = mesh_mod.solve_batch(
        keys, guesses, devs, snaps, points, valid, MAP_CFG, cfg, "rollout"
    )
    np.testing.assert_allclose(
        np.asarray(r_ref.cost), np.asarray(r_roll.cost), rtol=1e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(r_ref.pose), np.asarray(r_roll.pose), atol=5e-3
    )


def test_rollout_small_tiles_match_default_tiles(world, monkeypatch):
    """Tile sizes change only how the work is cut: many small tiles with
    ragged tails give the default tiling's solves to rounding."""
    keys, guesses, devs, _, _, _, _, sten, pts = _packed(world, 2, 200)
    cfg = cfgm.PSOConfig(iterations=5, population=50)
    run = lambda: jax.jit(
        lambda *a: pr._rollout_call(*a, cfg, MAP_CFG, 2, 0, True)
    )(keys, guesses, devs, sten, pts)
    p_ref, c_ref = run()
    monkeypatch.setattr(pr, "TILE_P", 16)
    monkeypatch.setattr(pr, "TILE_N", 8)
    p_small, c_small = run()
    np.testing.assert_allclose(np.asarray(c_small), np.asarray(c_ref),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(p_small), np.asarray(p_ref),
                               atol=1e-4)


@pytest.mark.parametrize(
    "backend, interpret", [("cpu", True), ("gpu", False), ("rocm", None)]
)
def test_interpret_mode_picks_the_kernel_route(monkeypatch, backend, interpret):
    """Compiled Triton on a GPU, the interpreter on the CPU, and no route
    (an error, never a silent interpreter) anywhere else."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if interpret is None:
        with pytest.raises(NotImplementedError, match="no Pallas kernel route"):
            pr.interpret_mode()
    else:
        assert pr.interpret_mode() is interpret


@pytest.mark.parametrize("kernel", ["pso_rollout", "rollout_scores"])
def test_rollout_kernels_lower_for_triton(kernel):
    """Both kernels lower to Triton IR for CUDA at the batch operating
    point's widths (N=384 beams, P=4096 particles).  This runs the Pallas
    Triton lowering on the CPU; compiling that IR for the card happens only
    on a GPU."""
    S = jax.ShapeDtypeStruct
    map_cfg = cfgm.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=4)
    b, n, p = 2, 384, 4096
    if kernel == "pso_rollout":
        cfg = cfgm.PSOConfig(iterations=50, population=p)
        fn = lambda k, g, d, s, q: pr._rollout_call(
            k, g, d, s, q, cfg, map_cfg, 2, 2, False
        )
        args = (S((b, 2), jnp.uint32), S((b, 3), jnp.float32),
                S((b, 3), jnp.float32), S((b, 25, 8, n), jnp.float32),
                S((b, 8, n), jnp.float32))
    else:
        fn = lambda x, g, s, q: pr._scores_call(x, g, s, q, map_cfg, 2, False)
        args = (S((b, p, 3), jnp.float32), S((b, 3), jnp.float32),
                S((b, 25, 8, n), jnp.float32), S((b, 8, n), jnp.float32))
    exported = jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[
            jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(*args)
    text = exported.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert f'name = "{kernel}"' in text


@pytest.mark.parametrize("population", [1, 50, 200, 1000, 4096, 5000])
def test_rollout_tiling_adapts_to_population(population):
    """The particle tile is a power of two no larger than the full-size
    tile and no larger than the swarm needs; the tiles cover the swarm and
    the point tiles cover the 384-beam buffer."""
    tile_p, p_tiles, tile_n, n_tiles, num_warps = pr._tiling(population, 384)
    assert tile_p & (tile_p - 1) == 0 and tile_n & (tile_n - 1) == 0
    assert tile_p <= pr.TILE_P and tile_p < 2 * max(population, 1)
    assert (p_tiles - 1) * tile_p < population <= p_tiles * tile_p
    assert (n_tiles - 1) * tile_n < 384 <= n_tiles * tile_n
    assert 4 <= num_warps <= pr.NUM_WARPS
