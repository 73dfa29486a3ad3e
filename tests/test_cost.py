"""Cost functions: exact vs oracle, fast (matmul) vs exact."""

import numpy as np

from ndtpso_slam.config import MapConfig
from ndtpso_slam.models import cost as cost_mod
from ndtpso_slam.models import ndt_map
from oracle import OracleFrame

CFG = MapConfig(size_m=16.0, cell_side_m=1.0, window_slots=4, slot_capacity=5)


def _build_pair(seed=0, n_pts=120):
    """Matching engine/oracle maps from the same random wall-like world."""
    rs = np.random.RandomState(seed)
    # Points along two "walls" => anisotropic cells, realistic NDT Gaussians.
    t = rs.uniform(-6, 6, n_pts)
    wall = np.where(rs.rand(n_pts) > 0.5, 1.0, -1.0)
    pts = np.stack([t, 3.0 * wall + rs.normal(0, 0.08, n_pts)], axis=-1)
    pts = np.concatenate([pts, np.stack([3.0 * wall, t], axis=-1) + rs.normal(0, 0.08, (n_pts, 2))])
    state = ndt_map.init_map(CFG)
    state = ndt_map.add_points(state, CFG, pts.astype(np.float32), np.ones(len(pts), bool))
    state = ndt_map.build(state, CFG)
    frame = OracleFrame(CFG.size_m, CFG.cell_side_m, CFG.window_slots, CFG.slot_capacity)
    for p in pts:
        frame.add_point(p)
    frame.build()
    # A query scan: noisy re-observation of some wall points.
    scan = pts[rs.choice(len(pts), 80, replace=False)] + rs.normal(0, 0.02, (80, 2))
    return state, frame, scan.astype(np.float32)


def test_exact_cost_matches_oracle():
    state, frame, scan = _build_pair()
    snap = ndt_map.snapshot(state, CFG)
    valid = np.ones(len(scan), bool)
    rs = np.random.RandomState(1)
    for _ in range(10):
        pose = rs.uniform([-0.3, -0.3, -0.1], [0.3, 0.3, 0.1]).astype(np.float32)
        ours = float(cost_mod.ndt_cost(pose, snap, scan, valid, CFG))
        ref = frame.cost(pose.astype(np.float64), scan.astype(np.float64))
        np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)


def test_exact_cost_batched_poses():
    state, _, scan = _build_pair()
    snap = ndt_map.snapshot(state, CFG)
    valid = np.ones(len(scan), bool)
    poses = np.random.RandomState(2).uniform(-0.2, 0.2, (16, 3)).astype(np.float32)
    batch = np.asarray(cost_mod.ndt_cost(poses, snap, scan, valid, CFG))
    for i in range(16):
        one = float(cost_mod.ndt_cost(poses[i], snap, scan, valid, CFG))
        np.testing.assert_allclose(batch[i], one, rtol=1e-5, atol=1e-4)


def test_fast_cost_equals_exact_at_binding_pose():
    """At the binding pose itself the frozen-correspondence cost is the exact
    cost (same cells, same Gaussians, delta = 0)."""
    state, _, scan = _build_pair()
    snap = ndt_map.snapshot(state, CFG)
    valid = np.ones(len(scan), bool)
    rs = np.random.RandomState(3)
    for _ in range(5):
        bind = rs.uniform([-0.2, -0.2, -0.05], [0.2, 0.2, 0.05]).astype(np.float32)
        bound = cost_mod.bind_points(bind, snap, scan, valid, CFG)
        fast = float(cost_mod.bound_cost(bind[None], bound)[0])
        exact = float(cost_mod.ndt_cost(bind, snap, scan, valid, CFG))
        np.testing.assert_allclose(fast, exact, rtol=2e-3, atol=2e-3)


def test_fast_cost_tracks_exact_nearby():
    """Within a small delta of the binding pose, fast == exact up to
    correspondence changes — differences stay a small fraction of the cost."""
    state, _, scan = _build_pair()
    snap = ndt_map.snapshot(state, CFG)
    valid = np.ones(len(scan), bool)
    bind = np.zeros(3, np.float32)
    bound = cost_mod.bind_points(bind, snap, scan, valid, CFG)
    rs = np.random.RandomState(4)
    deltas = rs.uniform([-0.05, -0.05, -0.02], [0.05, 0.05, 0.02], (32, 3)).astype(np.float32)
    fast = np.asarray(cost_mod.bound_cost(deltas, bound))
    exact = np.asarray(cost_mod.ndt_cost(deltas, snap, scan, valid, CFG))
    denom = np.maximum(np.abs(exact), 1.0)
    assert np.median(np.abs(fast - exact) / denom) < 0.08
    # And the minimum of both surfaces is in the same place (rank agreement).
    assert abs(int(np.argmin(fast)) - int(np.argmin(exact))) == 0 or (
        exact[np.argmin(fast)] - exact.min() < 0.05 * np.abs(exact.min())
    )


def test_stencil_exact_cost_equals_exact_within_radius():
    """Per-particle stencil rebind == ndt_cost whenever every point stays
    within +-radius cells of its anchor (models/cost.py:stencil_exact_cost)."""
    state, _, scan = _build_pair(seed=3)
    snap = ndt_map.snapshot(state, CFG)
    valid = np.ones(len(scan), bool)
    rs = np.random.RandomState(5)
    anchor = np.float32([0.05, -0.03, 0.02])
    nbr = cost_mod.bind_neighborhood(anchor, snap, scan, valid, CFG, radius=2)
    # Poses within ~1 cell of the anchor: every point stays in its stencil.
    poses = (anchor + rs.uniform(-0.5, 0.5, (32, 3)) * np.float32([1, 1, 0.1])
             ).astype(np.float32)
    got = np.asarray(cost_mod.stencil_exact_cost(poses, nbr, scan, CFG))
    want = np.asarray(cost_mod.ndt_cost(poses, snap, scan, valid, CFG))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_stencil_exact_cost_zero_outside_stencil():
    state, _, scan = _build_pair(seed=3)
    snap = ndt_map.snapshot(state, CFG)
    valid = np.ones(len(scan), bool)
    anchor = np.float32([0.0, 0.0, 0.0])
    nbr = cost_mod.bind_neighborhood(anchor, snap, scan, valid, CFG, radius=1)
    # A pose 5 cells away pushes every point out of its r=1 stencil.
    far = np.float32([[5.0, 5.0, 0.0]])
    got = float(cost_mod.stencil_exact_cost(far, nbr, scan, CFG)[0])
    assert got == 0.0


def test_bind_points_matmul_matches_gather():
    """The one-hot matmul binder reproduces bind_points bit-for-bit (a
    single-nonzero one-hot row accumulates exactly the gathered row)."""
    state, _, scan = _build_pair(seed=3)
    snap = ndt_map.snapshot(state, CFG)
    # include points outside the frame so the in-bounds masking is covered
    scan = np.concatenate([scan, scan[:5] + 30.0]).astype(np.float32)
    valid = np.ones(len(scan), bool)
    valid[7] = False
    tbl = cost_mod.snapshot_table(snap)
    rs = np.random.RandomState(9)
    for _ in range(5):
        pose = rs.uniform(-0.4, 0.4, 3).astype(np.float32)
        ref = cost_mod.bind_points(pose, snap, scan, valid, CFG)
        got = cost_mod.bind_points_matmul(pose, tbl, scan, valid, CFG)
        np.testing.assert_array_equal(np.asarray(ref.mask), np.asarray(got.mask))
        np.testing.assert_array_equal(np.asarray(ref.w), np.asarray(got.w))


def test_bind_points_matmul_window_matches_full_table():
    """The windowed one-hot binder is bit-identical to the full-table one
    for points inside the window, and masks (scores 0) points outside it —
    the out-of-map convention (cost.py:bind_points_matmul_window)."""
    import jax
    import jax.numpy as jnp

    state, _, scan = _build_pair(seed=5)
    snap = ndt_map.snapshot(state, CFG)
    valid = np.ones(len(scan), bool)
    tbl = cost_mod.snapshot_table(snap)
    w = CFG.cells_per_side  # 16
    ps = 8
    rs = np.random.RandomState(4)
    for ox, oy in ((0, 0), (4, 6), (w - ps, w - ps)):
        patch = jax.lax.dynamic_slice(
            tbl.reshape(w, w, 6), (oy, ox, 0), (ps, ps, 6)
        ).reshape(ps * ps, 6)
        for _ in range(3):
            pose = rs.uniform(-0.4, 0.4, 3).astype(np.float32)
            full = cost_mod.bind_points_matmul(pose, tbl, scan, valid, CFG)
            win = cost_mod.bind_points_matmul_window(
                pose, patch, (jnp.int32(ox), jnp.int32(oy)), ps, scan, valid,
                CFG,
            )
            # which points landed inside the window at this pose?
            from ndtpso_slam.ops.geometry import cell_coords, transform_points

            q0 = transform_points(jnp.asarray(scan), jnp.asarray(pose))
            ix, iy, _ = cell_coords(
                q0, size_m=CFG.size_m, cell_side_m=CFG.cell_side_m
            )
            inside = np.asarray(
                (ix >= ox) & (ix < ox + ps) & (iy >= oy) & (iy < oy + ps)
            )
            assert inside.any() and not inside.all()  # both cases exercised
            np.testing.assert_array_equal(
                np.asarray(win.mask)[inside], np.asarray(full.mask)[inside]
            )
            np.testing.assert_array_equal(
                np.asarray(win.w)[inside], np.asarray(full.w)[inside]
            )
            assert (np.asarray(win.mask)[~inside] == 0).all()
            assert (np.asarray(win.w)[~inside] == 0).all()


def test_kidnapped_robot_relocalizes_windowed():
    """Relocalization through the stage-2/3 binder *window* (the deployment
    path at 360k cells, ADVICE r3 medium #1) still recovers the kidnapped
    robot: window covers spread + the mapped surroundings."""
    import dataclasses

    from test_recovery import _cfg, _kidnap_workload, _run

    base = _cfg(recovery_on=True)
    cfg = dataclasses.replace(
        base, recovery=dataclasses.replace(base.recovery, patch_cells=44)
    )
    assert 0 < cfg.recovery.patch_cells < cfg.map.cells_per_side
    poses_true, scans = _kidnap_workload(cfg)
    state, est = _run(cfg, poses_true, scans)
    err = np.hypot(est[:, 0] - poses_true[:, 0], est[:, 1] - poses_true[:, 1])
    assert int(state.recoveries) >= 1, "kidnap did not trigger recovery"
    assert err[-2] < 0.3, f"windowed relocalization missed: {err[-2]:.3f} m"
    assert err[-1] < 0.3, f"post-recovery tracking lost: {err[-1]:.3f} m"


def test_patch_stencil_matches_full_roll():
    """A patch-local stencil bind (stencil_patch_cells) is bit-identical to
    the whole-grid rolled table whenever the patch covers the scan — for the
    bind arrays, the per-iteration local rebinding, and the per-particle
    stencil-exact cost."""
    import dataclasses

    # A grid big enough that the patch is a strict sub-window, and an anchor
    # far off-centre so the patch-origin clamping is exercised too.
    big = dataclasses.replace(CFG, size_m=64.0)
    state_b = ndt_map.init_map(big)
    rs = np.random.RandomState(5)
    pts = rs.uniform(-12, 12, (400, 2)).astype(np.float32)
    state_b = ndt_map.add_points(state_b, big, pts, np.ones(400, bool))
    state_b = ndt_map.build(state_b, big)
    snap = ndt_map.snapshot(state_b, big)
    scan = (pts[rs.choice(400, 100, replace=False)]
            + rs.normal(0, 0.02, (100, 2))).astype(np.float32)
    valid = np.ones(len(scan), bool)
    for anchor in (np.float32([0.15, -0.1, 0.08]), np.float32([-25.0, 24.0, 0.4])):
        cfg_p = dataclasses.replace(
            big, stencil_patch_cells=big.patch_cells_for_range(13.0)
        )
        assert 0 < cfg_p.stencil_patch_cells < big.cells_per_side
        full = cost_mod.bind_neighborhood(anchor, snap, scan, valid, big)
        patch = cost_mod.bind_neighborhood(anchor, snap, scan, valid, cfg_p)
        for name in ("anchor_ix", "anchor_iy", "built", "valid"):
            np.testing.assert_array_equal(
                np.asarray(getattr(full, name)), np.asarray(getattr(patch, name)),
                err_msg=f"{name} diverged (anchor {anchor})",
            )
        # mean/icov are only defined where built (unbuilt lanes hold
        # clamp-dependent garbage that the cost paths mask away).
        b = np.asarray(full.built)
        for name in ("mean", "icov"):
            np.testing.assert_array_equal(
                np.asarray(getattr(full, name))[b],
                np.asarray(getattr(patch, name))[b],
                err_msg=f"{name} diverged where built (anchor {anchor})",
            )
        poses = (anchor + np.random.RandomState(6).uniform(-0.3, 0.3, (32, 3))
                 ).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(cost_mod.stencil_exact_cost(poses, full, scan, big)),
            np.asarray(cost_mod.stencil_exact_cost(poses, patch, scan, cfg_p)),
        )
        b_full = cost_mod.bind_points_local(anchor, full, scan, big)
        b_patch = cost_mod.bind_points_local(anchor, patch, scan, cfg_p)
        np.testing.assert_array_equal(np.asarray(b_full.w), np.asarray(b_patch.w))


def test_bind_neighborhood_strategies_agree():
    """'gather' and 'roll' produce identical `built` and identical stats on
    every built lane (the auto strategy switch must never change results —
    cost.py:GATHER_BIND_MIN_CELLS)."""
    state, _, scan = _build_pair(seed=7)
    snap = ndt_map.snapshot(state, CFG)
    valid = np.ones(len(scan), bool)
    valid[3] = False
    for anchor in (np.float32([0.1, -0.05, 0.04]), np.float32([2.0, 1.5, -0.3])):
        roll = cost_mod.bind_neighborhood(anchor, snap, scan, valid, CFG,
                                          strategy="roll")
        gat = cost_mod.bind_neighborhood(anchor, snap, scan, valid, CFG,
                                         strategy="gather")
        np.testing.assert_array_equal(np.asarray(roll.built),
                                      np.asarray(gat.built))
        b = np.asarray(roll.built)
        assert b.any()
        for name in ("mean", "icov"):
            np.testing.assert_array_equal(
                np.asarray(getattr(roll, name))[b],
                np.asarray(getattr(gat, name))[b],
                err_msg=f"{name} diverged between bind strategies",
            )
        # and identical solve-level costs (unbuilt-lane garbage is masked)
        poses = (anchor + np.random.RandomState(1).uniform(-0.3, 0.3, (16, 3))
                 ).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(cost_mod.stencil_exact_cost(poses, roll, scan, CFG)),
            np.asarray(cost_mod.stencil_exact_cost(poses, gat, scan, CFG)),
        )
