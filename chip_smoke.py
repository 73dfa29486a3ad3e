#!/usr/bin/env python
"""Smoke run of the whole system on one NVIDIA GPU, from a checkout's root.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # only the multi-card paths, each
                                       # against its one-card twin

Phases, in one process (a phase that fails stops the run, exit code 1):

1. the card's name and power limit, from ``nvidia-smi`` in a child process;
2. the tests marked ``gpu``, in a child process that runs before this one
   touches JAX, so only one process ever holds the card;
3. JAX must see a GPU;
4. the native libraries, built from source;
5. the rollout kernel, compiled at path B's widths, with its memory
   analysis, then (a) its scores against ``bound_cost(bind_points_local)``
   and (b) whole solves against the XLA ``fast_local`` loop, both timed;
6. path B: 256 solves x 4096 particles x <= 50 iterations x 360 beams
   (padded to 384) through ``solve_batch(cost_mode="rollout", early_exit=2)``,
   with bench.py's batch accuracy gate;
7. path A: the SLAM node (``node.main``) over a 100-scan x 360-beam
   ``.ndtlog`` at the reference's deployment scale (launch/scan.json: 300 m
   frame, 0.5 m cells, 100-slot window, 50 x 30 PSO, 0.1 m occupancy
   raster, ``local_exact``), with bench.py's SLAM gate on the exported
   trajectory.

The last line of stdout is one JSON object naming the device; it is printed
only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, ".smoke_out")

# Path B: bench.py's batch operating point.
BATCH, PARTICLES, ITERS, EARLY_EXIT = 256, 4096, 50, 2
# Check (b): share of solves whose final cost must agree with fast_local to
# COST_RTOL.  PSO is chaotic under reordered float32 sums, so a few solves
# may take another path to (nearly) the same optimum.
COST_RTOL, AGREE_SHARE = 1e-3, 0.9
# --four-cards fleet: one robot per card at the reference's deployment map
# scale, sparse ring (MapConfig.ring_rows) sized for a 30-scan log.
FLEET_MAP = dict(size_m=300.0, cell_side_m=0.5, window_slots=100,
                 ring_rows=16384)


def log(msg):
    print(msg, flush=True)


def phase(name, fn, *args):
    log(f"== {name}")
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")
    return out


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(out)
    return out


def gpu_tests():
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests")],
        cwd=ROOT, env=env, capture_output=True, text=True,
    )
    log(proc.stdout[-3000:] + proc.stderr[-2000:])
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    if proc.returncode != 0 or "passed" not in summary or "skipped" in summary:
        raise RuntimeError(f"gpu tests did not all pass: {summary!r}")


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {dev.platform}")
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")
    return dev


def build_native():
    from ndtpso_slam.utils import native

    native.build()


def batch_inputs():
    import jax

    import bench

    map_cfg, pso_cfg, inputs, true = bench.batch_setup(
        BATCH, particles=PARTICLES, iters=ITERS
    )
    return map_cfg, pso_cfg, jax.device_put(inputs), true


def _median_time(fn, reps=5):
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _bound_cost_f64(poses, bind, w, mask):
    """models/cost.py:bound_cost in float64 NumPy, for one solve."""
    from ndtpso_slam.models.cost import _IJ

    poses, bind, w = (np.asarray(x, np.float64) for x in (poses, bind, w))
    dth = poses[:, 2] - bind[2]
    u = np.stack([np.cos(dth) - 1.0, np.sin(dth), poses[:, 0] - bind[0],
                  poses[:, 1] - bind[1], np.ones_like(dth)], -1)
    phi = np.stack([u[:, a] * u[:, b] for a, b in _IJ], -1)
    score = np.exp(-0.5 * np.maximum(phi @ w.T, 0.0))
    return -score @ np.asarray(mask, np.float64)


def kernel_checks(setup):
    """Phase 5: compile, check (a), check (b) with kernel-vs-XLA times."""
    import jax
    import jax.numpy as jnp

    import bench
    from ndtpso_slam.models import cost as cost_mod
    from ndtpso_slam.ops import pallas_rollout as pr
    from ndtpso_slam.parallel import mesh as mesh_mod

    map_cfg, pso_cfg, inputs, true = setup
    keys, guesses, devs, snaps, points, valid = inputs

    @jax.jit
    def pack(guesses, snaps, points, valid):
        nbrs = jax.vmap(lambda g, s, p, v: cost_mod.bind_neighborhood(
            g, s, p, v, map_cfg, radius=mesh_mod.STENCIL_RADIUS
        ))(guesses, snaps, points, valid)
        return (nbrs,) + jax.vmap(pr.pack_rollout_inputs)(nbrs, points)

    nbrs, sten, pts = pack(guesses, snaps, points, valid)
    t0 = time.perf_counter()
    compiled = pr.pso_rollout.lower(
        keys, guesses, devs, sten, pts, pso_cfg, map_cfg,
        radius=mesh_mod.STENCIL_RADIUS, early_exit=EARLY_EXIT,
    ).compile()
    log(f"pso_rollout compiled in {time.perf_counter() - t0:.1f} s: "
        f"{compiled.memory_analysis()}")

    # (a) Scores of one fixed set of poses (the swarm's init spread around
    # each solve's binding) at N=384 beams x P=4096 poses, against
    # bound_cost(bind_points_local) with every XLA contraction at
    # Precision.HIGHEST.  Both are float32 with the sums in other orders;
    # the quadratic form cancels large terms far from the binding, so each
    # is judged by its distance from a float64 evaluation of the same bound
    # scan: the kernel's may be at most twice XLA's, plus 1e-4.
    n_a = min(16, BATCH)
    rs = np.random.RandomState(3)
    binds = true[:n_a].astype(np.float32)
    poses = binds[:, None, :] + (
        rs.uniform(-1, 1, (n_a, PARTICLES, 3)) * np.float32([0.5, 0.5, 0.1])
    ).astype(np.float32)
    got = np.asarray(pr.rollout_scores(jnp.asarray(poses), jnp.asarray(binds),
                                       sten[:n_a], pts[:n_a], map_cfg))
    sub = jax.tree_util.tree_map(lambda x: x[:n_a], nbrs)
    bound = jax.jit(jax.vmap(lambda g, nb, q: cost_mod.bind_points_local(
        g, nb, q, map_cfg)))(binds, sub, points[:n_a])
    with jax.default_matmul_precision("highest"):
        xla = np.asarray(jax.jit(jax.vmap(cost_mod.bound_cost))(poses, bound))
    exact = np.stack([
        _bound_cost_f64(poses[i], np.asarray(bound.bind_pose[i]),
                        np.asarray(bound.w[i]), np.asarray(bound.mask[i]))
        for i in range(n_a)
    ])
    err_k, err_x = np.abs(got - exact), np.abs(xla - exact)
    log(f"check (a): {got.size} scores in [{exact.min():.3f}, "
        f"{exact.max():.3f}]; |kernel - f64| max {err_k.max():.3e} mean "
        f"{err_k.mean():.3e}; |XLA - f64| max {err_x.max():.3e} mean "
        f"{err_x.mean():.3e}")
    if not (err_k.max() <= 2 * err_x.max() + 1e-4
            and err_k.mean() <= 2 * err_x.mean() + 1e-4):
        raise AssertionError("check (a): kernel scores off by more than "
                             "float32 rounding")

    # (b) Whole solves on the same Threefry streams, fixed 50-iteration
    # budget on both sides: the accuracy gate on each, and the share of
    # solves whose final cost agrees to COST_RTOL.
    def solve(mode, early_exit=0):
        return lambda: mesh_mod.solve_batch(
            *inputs, map_cfg, pso_cfg, cost_mode=mode, early_exit=early_exit
        )

    results, times = {}, {}
    for mode in ("rollout", "fast_local"):
        results[mode] = solve(mode)()
        times[mode] = _median_time(solve(mode))
        log(f"check (b) {mode}, {ITERS} iterations: {times[mode] * 1e3:.3f} ms "
            f"per {BATCH} solves ({BATCH / times[mode]:.1f} solves/s)")
        bench.batch_accuracy(results[mode].pose, true)
    a = np.asarray(results["rollout"].cost)
    b = np.asarray(results["fast_local"].cost)
    rel = np.abs(a - b) / np.abs(b)
    share = float((rel <= COST_RTOL).mean())
    log(f"check (b): cost rel diff median {np.median(rel):.3e}, max "
        f"{rel.max():.3e}; {share:.4f} of solves within {COST_RTOL:g}")
    if share < AGREE_SHARE:
        raise AssertionError(
            f"check (b): only {share:.4f} of solves agree with fast_local"
        )
    log(f"kernel vs XLA at path B's shapes, fixed budget: rollout "
        f"{times['rollout'] * 1e3:.3f} ms, fast_local "
        f"{times['fast_local'] * 1e3:.3f} ms "
        f"({times['fast_local'] / times['rollout']:.2f}x)")


def path_b(setup):
    import jax

    import bench
    from ndtpso_slam.parallel import mesh as mesh_mod

    map_cfg, pso_cfg, inputs, true = setup
    run = lambda: mesh_mod.solve_batch(
        *inputs, map_cfg, pso_cfg, cost_mode="rollout", early_exit=EARLY_EXIT
    )
    res = run()
    jax.block_until_ready(res)
    bench.batch_accuracy(res.pose, true)
    dt = _median_time(run)
    log(f"path B: {dt * 1e3:.3f} ms per {BATCH} solves -> "
        f"{BATCH / dt:.1f} solves/s (bring-up reading)")


def path_a():
    from ndtpso_slam import node
    from ndtpso_slam.io import synthetic
    from ndtpso_slam.ops.geometry import se2_compose, se2_inverse
    from ndtpso_slam.utils import native

    os.makedirs(OUT_DIR, exist_ok=True)
    lg = synthetic.make_log(seed=2, n_scans=100, n_beams=360, world_size=50.0)
    log_path = os.path.join(OUT_DIR, "smoke.ndtlog")
    native.scanlog_write(log_path, lg.ranges, lg.poses, lg.odoms,
                         lg.timestamps, lg.angle_min, lg.angle_increment,
                         lg.range_max)
    with open(os.path.join(ROOT, "launch", "scan.json")) as f:
        launch = json.load(f)
    # The log's poses are the laser's; the node estimates the base, which
    # sits behind the laser by the launch file's mount transform.
    mount = np.asarray(launch["mount_trans"], np.float64)
    gt = np.asarray(se2_compose(lg.poses, se2_inverse(mount)))
    launch["init_pose"] = [float(v) for v in gt[0]]
    cfg_path = os.path.join(OUT_DIR, "scan.json")
    with open(cfg_path, "w") as f:
        json.dump(launch, f)
    base = os.path.join(OUT_DIR, "slam")
    # The second run reuses the first one's compiled step: its rate is the
    # steady-state reading (log loading and export writing included).
    for label in ("first run, compile included", "second run"):
        t0 = time.perf_counter()
        rc = node.main(["--scanlog", log_path, "--config", cfg_path, "--out",
                        base, "--quiet"])
        dt = time.perf_counter() - t0
        log(f"path A: node.main rc {rc}, {len(lg.ranges)} scans in {dt:.2f} s "
            f"-> {len(lg.ranges) / dt:.2f} scans/s ({label})")
        if rc != 0:
            raise RuntimeError(f"node.main returned {rc}")
    for suffix in (".pose.csv", ".map.csv", ".gnuplot", ".cells.csv"):
        if not os.path.getsize(base + suffix):
            raise RuntimeError(f"empty export {base + suffix}")
    est = np.loadtxt(base + ".pose.csv", delimiter=",", skiprows=1,
                     usecols=(1, 2, 3))
    err = np.hypot(est[:, 0] - gt[:, 0], est[:, 1] - gt[:, 1])
    log(f"path A: {len(est)} poses, position error mean {err.mean():.4f} m, "
        f"max {err.max():.4f} m")
    if not (len(est) == len(gt) and err.mean() < 0.35 and err.max() < 0.7):
        raise AssertionError("path A: SLAM trajectory accuracy gate failed")


def four_cards():
    """Each multi-card path against its one-card twin, on 4 cards."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import bench
    from ndtpso_slam import config as cfgm
    from ndtpso_slam.io import synthetic
    from ndtpso_slam.models import cost as cost_mod, ndt_map
    from ndtpso_slam.models import scan as scan_mod, slam as slam_mod
    from ndtpso_slam.parallel import distributed, mesh as mesh_mod
    from ndtpso_slam.parallel.fleet import (
        run_offline_fleet, run_offline_fleet_sharded,
    )
    from ndtpso_slam.parallel.multi_swarm import multi_swarm_solve

    n = len(jax.devices())
    if n != 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, JAX found {n}")
    mesh = mesh_mod.make_mesh(4)
    axis = mesh_mod.SOLVE_AXIS
    one = jax.devices()[0]

    def compare(name, got, want, exact):
        got, want = (np.asarray(x, np.float64) for x in (got, want))
        d = float(np.abs(got - want).max())
        same = np.array_equal(got, want)
        log(f"{name}: bitwise {'equal' if same else 'different'}, "
            f"max |diff| {d:.3e}")
        if exact and not same:
            raise AssertionError(f"{name}: differs from its one-card twin")
        return d

    # Sharded solver vs solve_batch on one card (independent programs).
    map_cfg, pso_cfg, inputs, true = bench.batch_setup(
        BATCH, particles=PARTICLES, iters=ITERS
    )
    ref = mesh_mod.solve_batch(*jax.device_put(inputs, one), map_cfg,
                               pso_cfg, cost_mode="rollout",
                               early_exit=EARLY_EXIT)
    solver = mesh_mod.make_sharded_solver(mesh, map_cfg, pso_cfg,
                                          cost_mode="rollout",
                                          early_exit=EARLY_EXIT)
    got = solver(*inputs)
    bench.batch_accuracy(got.pose, true)
    compare("make_sharded_solver pose", got.pose, ref.pose, exact=True)
    compare("make_sharded_solver cost", got.cost, ref.cost, exact=True)

    # Robots-over-cards fleet vs the one-card flat fleet.
    cfg = cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=30, population=50),
        map=cfgm.MapConfig(**FLEET_MAP),
        scan=cfgm.ScanConfig(max_beams=384),
        cost_mode="local_exact",
    )
    logs = [synthetic.make_log(seed=2 + r, n_scans=30, n_beams=360,
                               world_size=50.0) for r in range(4)]

    def load(lg):
        ss = [scan_mod.load_laser(r, lg.angle_min, lg.angle_increment,
                                  lg.range_max, cfg.scan, cfg.map)
              for r in lg.ranges]
        return scan_mod.Scan(points=jnp.stack([s.points for s in ss]),
                             valid=jnp.stack([s.valid for s in ss]))

    scans = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                   *[load(lg) for lg in logs])
    init = np.stack([lg.poses[0] for lg in logs]).astype(np.float32)
    keys = np.stack([np.full(4, 3, np.uint32),
                     np.arange(9, 13, dtype=np.uint32)], -1)
    with jax.default_device(one):
        _, ref_poses, ref_costs = run_offline_fleet(
            slam_mod.init_slam_batch(cfg, init), scans, keys, cfg)
    _, poses, costs = run_offline_fleet_sharded(
        mesh, slam_mod.init_slam_batch(cfg, init), scans, keys, cfg)
    gt = np.stack([lg.poses for lg in logs])
    err = np.hypot(*(np.asarray(poses)[..., :2] - gt[..., :2]).transpose(2, 0, 1))
    log(f"sharded fleet: 4 robots x 30 scans, position error mean "
        f"{err.mean():.4f} m, max {err.max():.4f} m")
    if not (err.mean(axis=1).max() < 0.35 and err.max() < 0.7):
        raise AssertionError("sharded fleet: SLAM accuracy gate failed")
    compare("run_offline_fleet_sharded poses", poses, ref_poses, exact=False)
    compare("run_offline_fleet_sharded costs", costs, ref_costs, exact=False)

    # Multi-swarm global-best exchange across cards vs all swarms on one:
    # 16 swarms relocalize solve 0's query scan in its map.
    snap = jax.tree_util.tree_map(lambda x: x[0], inputs[3])
    rs = np.random.RandomState(4)
    q_pts, q_valid = inputs[4][0], inputs[5][0]
    swarm_cfg = cfgm.PSOConfig(iterations=30, population=1024)
    cost_fn = lambda poses, bind: cost_mod.bound_cost(
        poses, cost_mod.bind_points(bind, snap, q_pts, q_valid, map_cfg))
    k = 16
    skeys = rs.randint(0, 2**31, (k, 2)).astype(np.uint32)
    hyps = (true[0] + rs.uniform(-1, 1, (k, 3)) * np.float32([1, 1, 0.1])
            ).astype(np.float32)
    dev = jnp.float32([0.6, 0.6, 0.1])
    with jax.default_device(one):
        ref_ms = jax.jit(lambda kk, h: multi_swarm_solve(
            kk, h, dev, cost_fn, swarm_cfg, exchange_every=5))(skeys, hyps)
    sharded_ms = jax.jit(jax.shard_map(
        lambda kk, h: tuple(multi_swarm_solve(
            kk, h, dev, cost_fn, swarm_cfg, exchange_every=5,
            axis_name=axis)),
        mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=(P(), P()),
        check_vma=False,
    ))(skeys, hyps)
    log(f"multi-swarm: one card {np.asarray(ref_ms.pose)} cost "
        f"{float(ref_ms.cost):.4f}; four cards {np.asarray(sharded_ms[0])} "
        f"cost {float(sharded_ms[1]):.4f}; truth {true[0]}")
    if np.abs(np.asarray(sharded_ms[0]) - true[0])[:2].max() > 0.1:
        raise AssertionError("multi-swarm exchange across cards missed the pose")
    compare("multi_swarm_solve pose", sharded_ms[0], ref_ms.pose, exact=False)

    # psum map merge vs serial ingestion on one card.
    pts4 = rs.uniform(-20, 20, (4 * 256, 2)).astype(np.float32)
    val4 = np.ones(len(pts4), bool)
    pose0 = np.zeros(3, np.float32)
    map0 = ndt_map.init_map(map_cfg)
    with jax.default_device(one):
        serial = ndt_map.update(map0, map_cfg, pose0, pts4, val4)
    merged = jax.jit(jax.shard_map(
        lambda st, p, v: distributed.sharded_update(st, map_cfg, pose0, p, v,
                                                    axis),
        mesh=mesh, in_specs=(P(), P(axis), P(axis)), out_specs=P(),
        check_vma=False,
    ))(map0, pts4, val4)
    compare("psum merge cur_count", merged.cur_count, serial.cur_count,
            exact=True)
    compare("psum merge created", merged.created, serial.created, exact=True)
    d = compare("psum merge cur_sum", merged.cur_sum, serial.cur_sum,
                exact=False)
    if d > 1e-3:
        raise AssertionError(f"psum merge cur_sum off by {d}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on 4 GPUs")
    args = ap.parse_args(argv)
    try:
        phase("card", card_info)
        if not args.four_cards:
            phase("gpu tests", gpu_tests)
        sys.path.insert(0, ROOT)
        from ndtpso_slam.utils import compile_cache

        compile_cache.enable()
        dev = phase("device", require_gpu)
        if args.four_cards:
            phase("four cards", four_cards)
        else:
            phase("native build", build_native)
            setup = phase("path B setup", batch_inputs)
            phase("rollout kernel", kernel_checks, setup)
            phase("path B", path_b, setup)
            phase("path A", path_a)
    except Exception:
        import traceback

        traceback.print_exc()
        return 1
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
