"""Tests that need a GPU: full-precision selections, the compiled kernel,
and the fleet's agreement with solo runs under atomic scatter-adds.

They run under ``JAX_PLATFORMS=cuda`` (``python chip_smoke.py`` runs them
first) and skip elsewhere.  Whether a card is present is decided in the
``card`` fixture, when a test runs — never while the module is imported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ndtpso_slam import config as cfgm
from ndtpso_slam.models import cost as cost_mod, ndt_map

pytestmark = pytest.mark.gpu

# A map whose cells sit ~100 m from the origin: float32 keeps ~7 digits of
# a 100 m mean (~10 µm), TF32 only ~3 (~5 cm), and the map's Gaussians are
# ~1 cm thin.  A selection run in TF32 cannot pass these tests.
MAP_CFG = cfgm.MapConfig(size_m=256.0, cell_side_m=1.0, window_slots=4)
CENTRE = np.float32([100.0, 95.0])


@pytest.fixture(scope="module")
def card():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda)")
    return jax.devices()[0]


@pytest.fixture(scope="module")
def far_world(card):
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 256, endpoint=False)
    pts = CENTRE + np.stack([9 * np.cos(t), 6 * np.sin(t)], -1)
    state = ndt_map.init_map(MAP_CFG)
    for _ in range(3):
        noisy = pts + rs.normal(0, 0.02, pts.shape)
        state = ndt_map.add_points(state, MAP_CFG, noisy.astype(np.float32),
                                   np.ones(len(pts), bool))
        state = ndt_map.build(state, MAP_CFG)
    scan = (pts - CENTRE + rs.normal(0, 0.02, pts.shape)).astype(np.float32)
    return ndt_map.snapshot(state, MAP_CFG), scan


def test_onehot_binder_is_bit_identical_to_gather_on_card(far_world):
    """bind_points_matmul's one-hot [N, C] @ [C, 6] selection returns the
    gathered rows bit-for-bit on the card (precision HIGHEST)."""
    snap, scan = far_world
    valid = np.ones(len(scan), bool)
    tbl = cost_mod.snapshot_table(snap)
    rs = np.random.RandomState(1)
    for _ in range(3):
        pose = np.float32([*CENTRE, 0.0]) + rs.uniform(-0.3, 0.3, 3).astype(
            np.float32
        )
        ref = jax.jit(lambda p: cost_mod.bind_points(p, snap, scan, valid,
                                                     MAP_CFG))(pose)
        got = jax.jit(lambda p: cost_mod.bind_points_matmul(p, tbl, scan, valid,
                                                            MAP_CFG))(pose)
        np.testing.assert_array_equal(np.asarray(ref.mask), np.asarray(got.mask))
        np.testing.assert_array_equal(np.asarray(ref.w), np.asarray(got.w))


def test_stencil_selection_matches_gather_cost_on_card(far_world):
    """stencil_exact_cost's one-hot einsum selection == the gather cost
    ndt_cost on the card, within float32 rounding of the final sums."""
    snap, scan = far_world
    valid = np.ones(len(scan), bool)
    anchor = np.float32([*CENTRE, 0.0])
    nbr = cost_mod.bind_neighborhood(anchor, snap, scan, valid, MAP_CFG)
    rs = np.random.RandomState(5)
    poses = (anchor + rs.uniform(-0.5, 0.5, (64, 3)) * np.float32([1, 1, 0.1])
             ).astype(np.float32)
    got = jax.jit(lambda p: cost_mod.stencil_exact_cost(p, nbr, scan, MAP_CFG))(
        poses)
    want = jax.jit(lambda p: cost_mod.ndt_cost(p, snap, scan, valid, MAP_CFG))(
        poses)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_rollout_kernel_matches_fast_local_on_card(far_world):
    """The compiled Triton kernel's solves land where the XLA fast_local
    solves land, on a map ~100 m from the origin (same Threefry streams;
    sums in another order, so to float32 rounding)."""
    from ndtpso_slam.parallel import mesh as mesh_mod

    snap, scan = far_world
    b, n = 8, 384
    rs = np.random.RandomState(2)
    points = np.zeros((b, n, 2), np.float32)
    points[:, : len(scan)] = scan
    valid = np.zeros((b, n), bool)
    valid[:, : len(scan)] = True
    guesses = (np.float32([*CENTRE, 0.0])
               + rs.uniform(-0.05, 0.05, (b, 3)).astype(np.float32))
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32)
    devs = np.tile(np.float32([0.2, 0.2, 0.05]), (b, 1))
    snaps = jax.tree_util.tree_map(
        lambda x: jnp.tile(x[None], (b,) + (1,) * x.ndim), snap
    )
    cfg = cfgm.PSOConfig(iterations=20, population=1000)
    ref = mesh_mod.solve_batch(keys, guesses, devs, snaps, points, valid,
                               MAP_CFG, cfg, "fast_local")
    got = mesh_mod.solve_batch(keys, guesses, devs, snaps, points, valid,
                               MAP_CFG, cfg, "rollout")
    np.testing.assert_allclose(np.asarray(got.cost), np.asarray(ref.cost),
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(got.pose), np.asarray(ref.pose),
                               atol=2e-2)


def test_fleet_matches_solo_on_card(card):
    """run_offline_fleet (flat scatters over [B*C] with disjoint per-robot
    ids) against each robot's solo run_offline, on the card.  Unlike on the
    CPU (tests/test_parallel.py) this is not bitwise: XLA's scatter-adds
    are atomics that add in another order (map means to ~1e-9 m), and the
    exact-cost re-score sums in another order (costs to 1e-5 relative,
    1e-3 absolute).
    Poses must stay within 1 mm: a rounding difference in the map may not
    move a solve."""
    from ndtpso_slam.io import synthetic
    from ndtpso_slam.models import scan as scan_mod, slam as slam_mod
    from ndtpso_slam.parallel.fleet import run_offline_fleet

    cfg = cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=15, population=50),
        map=cfgm.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=4,
                           slot_capacity=20),
        scan=cfgm.ScanConfig(max_beams=256),
        cost_mode="local_exact",
    )
    logs = [synthetic.make_log(seed=20 + r, n_scans=10, n_beams=256,
                               world_size=40.0, odom_noise=0.02)
            for r in range(3)]

    def load(lg):
        ss = [scan_mod.load_laser(r, lg.angle_min, lg.angle_increment,
                                  lg.range_max, cfg.scan, cfg.map)
              for r in lg.ranges]
        return scan_mod.Scan(points=jnp.stack([s.points for s in ss]),
                             valid=jnp.stack([s.valid for s in ss]))

    scans = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                   *[load(lg) for lg in logs])
    init = np.stack([lg.poses[0] for lg in logs]).astype(np.float32)
    keys = np.stack([np.full(3, 3, np.uint32),
                     np.arange(9, 12, dtype=np.uint32)], -1)
    fstates, fposes, fcosts = run_offline_fleet(
        slam_mod.init_slam_batch(cfg, init), scans, keys, cfg)
    for r in range(3):
        solo, sposes, scosts = slam_mod.run_offline(
            slam_mod.init_slam(cfg, initial_pose=tuple(init[r])),
            jax.tree_util.tree_map(lambda x: x[r], scans),
            (keys[r, 0], keys[r, 1]), cfg)
        np.testing.assert_allclose(np.asarray(fposes[r]), np.asarray(sposes),
                                   atol=1e-3)
        np.testing.assert_allclose(np.asarray(fcosts[r]), np.asarray(scosts),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(np.asarray(fstates.map.mean_c[r]),
                                   np.asarray(solo.map.mean_c), atol=1e-6)
