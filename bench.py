"""Benchmark configs on the GPU: batched scan-match solves, sequential SLAM,
multi-swarm relocalization, a recovery event and single-scan latency.

The default config is batch solves: independent SE(2) scan-match solves at
4096 particles x 50 PSO iterations, each solve a 360-beam scan registered
against its own prebuilt NDT map with a known ground-truth offset, through
the whole-solve rollout kernel with early exit 2.  Each config asserts its
accuracy gate before it times anything.

Runs on a GPU only: it fails when JAX finds none.  Prints exactly ONE JSON
line on stdout, naming the device it ran on; diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def require_gpu():
    """The first device, which must be a GPU: a measurement path never falls
    back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX found {dev.platform} ({dev.device_kind})"
        )
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    return dev


def emit(metric, value, unit):
    """The one JSON result line, with the device it was measured on."""
    import jax

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": metric,
        "value": float(value),
        "unit": unit,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


def batch_setup(b, beams=360, pad_beams=384, particles=4096, iters=50,
                cells=1.0):
    """The batch config's inputs: B worlds, a reference scan (map) and an
    offset query scan each.  Returns (map_cfg, pso_cfg, (keys, guesses,
    deviations, snaps, points, valid), true_offsets [B, 3])."""
    import jax.numpy as jnp

    from ndtpso_slam import config as cfgm
    from ndtpso_slam.io import synthetic
    from ndtpso_slam.models import ndt_map, scan as scan_mod
    from ndtpso_slam.models.ndt_map import MapSnapshot

    map_cfg = cfgm.MapConfig(size_m=64.0, cell_side_m=cells, window_slots=4)
    pso_cfg = cfgm.PSOConfig(iterations=iters, population=particles)
    scan_cfg = cfgm.ScanConfig(max_beams=pad_beams)
    rs = np.random.RandomState(0)
    segs = synthetic.make_world(seed=1, size=50.0, n_boxes=8)
    true_offsets = np.stack(
        [
            rs.uniform(-0.3, 0.3, b),
            rs.uniform(-0.3, 0.3, b),
            rs.uniform(-0.05, 0.05, b),
        ],
        -1,
    )
    inc = 2 * np.pi / beams
    ref_ranges = synthetic.raycast(segs, np.zeros(3), beams, -np.pi, inc, 30.0)
    ref_scan = scan_mod.load_laser(
        ref_ranges.astype(np.float32), -np.pi, inc, 30.0, scan_cfg, map_cfg,
    )
    # Per-solve maps: each built from 3 jittered re-observations of the ref
    # scan so cells have count > 2 and real covariances.
    state = ndt_map.init_map(map_cfg)
    for _ in range(3):
        jit_pts = np.asarray(ref_scan.points) + rs.normal(0, 0.03, (pad_beams, 2))
        state = ndt_map.add_points(
            state, map_cfg, jit_pts.astype(np.float32), np.asarray(ref_scan.valid)
        )
        state = ndt_map.build(state, map_cfg)
    snap1 = ndt_map.snapshot(state, map_cfg)
    snaps = MapSnapshot(
        mean=jnp.tile(snap1.mean[None], (b, 1, 1)),
        inv_cov=jnp.tile(snap1.inv_cov[None], (b, 1, 1)),
        built=jnp.tile(snap1.built[None], (b, 1)),
    )
    # Query scans: the same world viewed from true_offsets[i].
    q_pts = np.zeros((b, pad_beams, 2), np.float32)
    q_valid = np.zeros((b, pad_beams), bool)
    for i in range(b):
        r = synthetic.raycast(segs, true_offsets[i], beams, -np.pi, inc, 30.0)
        s = scan_mod.load_laser(
            r.astype(np.float32), -np.pi, inc, 30.0, scan_cfg, map_cfg,
        )
        q_pts[i] = np.asarray(s.points)
        q_valid[i] = np.asarray(s.valid)
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32)
    guesses = np.zeros((b, 3), np.float32)
    deviations = np.tile(np.float32([0.5, 0.5, 0.1]), (b, 1))
    inputs = (keys, guesses, deviations, snaps, q_pts, q_valid)
    return map_cfg, pso_cfg, inputs, true_offsets


def batch_accuracy(pose, true_offsets):
    """Batch accuracy gate: median xy < 0.05 m and median theta < 0.01 rad
    against the known offsets.  Returns (median xy, median theta); raises
    when the gate fails."""
    err = np.abs(np.asarray(pose) - true_offsets)
    med_xy, med_th = np.median(err[:, :2]), np.median(err[:, 2])
    log(f"pose err vs truth: median xy {med_xy:.6f} m, median th "
        f"{med_th:.7f} rad, max xy {err[:, :2].max():.6f}")
    if not (med_xy < 0.05 and med_th < 0.01):
        raise AssertionError(
            f"solve accuracy regressed: median xy {med_xy:.6f} m, "
            f"median th {med_th:.7f} rad"
        )
    return med_xy, med_th


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--particles", type=int, default=None,
                    help="default: 4096 (batch/multiswarm), 50 for slam "
                    "(the reference's launch budget, scan.launch:11-13)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--beams", type=int, default=360)
    ap.add_argument("--pad-beams", type=int, default=384)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument(
        "--mode", default=None,
        choices=["fast", "fast_local", "fast_matmul", "local_exact",
                 "rollout", "exact"],
        help="default: rollout for batch, local_exact for slam "
        "(frozen-binding modes lose tracking at 0.5 m cells), fast for "
        "multiswarm",
    )
    ap.add_argument("--early-exit", type=int, default=None, metavar="K",
                    help="rollout mode: stop a solve once the global best "
                    "stalls K consecutive iterations (--iters becomes a "
                    "cap; 0 = the reference's fixed budget).  Default: 2 "
                    "for batch rollout, 0 otherwise")
    ap.add_argument("--cells", type=float, default=1.0)
    ap.add_argument(
        "--config", default="batch",
        choices=["batch", "slam", "multiswarm", "recovery", "latency"],
        help="BASELINE workload: batch solves (2), sequential SLAM (3), "
        "multi-swarm relocalization (4); 'recovery' measures one kidnapped-"
        "robot relocalization event through slam_step (latency vs the 10 Hz "
        "budget + healthy-run overhead of recovery=True); 'latency' "
        "measures the one-scan-in-one-pose-out dispatch distribution "
        "(p50/p95 over >=100 single slam_step dispatches, host dispatch "
        "floor separated via a no-op dispatch) — the reference's actual "
        "10 Hz operating mode (ndtpso_slam_node.cpp:232-240)",
    )
    ap.add_argument("--og", action="store_true",
                    help="slam config: build the occupancy grid raster")
    ap.add_argument("--fleet-mode", default="vmap", choices=["vmap", "flat"],
                    help="slam config with --robots N: 'vmap' = "
                    "run_offline_batch (batched-scatter carry: XLA copies "
                    "map state per step); 'flat' = run_offline_fleet "
                    "(robot axis folded into the cell axis -> in-place "
                    "flat scatters, no copy wall)")
    ap.add_argument("--robots", type=int, default=1,
                    help="slam config: run N independent SLAM sessions as "
                    "one program and report aggregate scans/s — the "
                    "reference's one-process-per-LiDAR deployment "
                    "(lidar_front/back.launch) on one card")
    ap.add_argument("--full-scale", action="store_true",
                    help="slam config: reference deployment scale "
                    "(300 m frame, 0.5 m cells, 100-slot window, 0.1 m OG)")
    ap.add_argument("--window-slots", type=int, default=None, metavar="S",
                    help="slam config: override the sliding-window slot "
                    "count (ring state scales linearly; full-scale default "
                    "100, test default 8)")
    ap.add_argument("--ring-rows", type=int, default=None, metavar="R",
                    help="slam config: sparse sliding-window storage — "
                    "allocate R ring rows assigned to cells on first build "
                    "instead of one per cell (MapConfig.ring_rows)")
    ap.add_argument("--patch-range", type=float, default=0.0, metavar="M",
                    help="slam full-scale: force the dynamic-slice stencil "
                    "patch covering this laser range; 0 (default) = auto "
                    "binder strategy (cost.py:bind_neighborhood)")
    ap.add_argument("--soak", type=int, default=None, metavar="T",
                    help="slam config: long-soak mode — T scans (1000+) on a "
                    "~157 m warehouse loop at full deployment scale; asserts "
                    "the sliding-window ring actually WRAPS (eviction "
                    "exercised) and reports end-to-end drift")
    ap.add_argument("--sharded", action="store_true",
                    help="batch config: shard solves over all visible devices "
                    "(reports aggregate solves/s)")
    ap.add_argument("--devices", type=int, default=None,
                    help="with --sharded: use only the first N devices")
    args = ap.parse_args()

    from ndtpso_slam.utils import compile_cache

    compile_cache.enable()
    require_gpu()
    if args.mode is None:
        args.mode = {"batch": "rollout", "slam": "local_exact",
                     "multiswarm": "fast", "recovery": "local_exact",
                     "latency": "local_exact"}[args.config]
    if args.particles is None:
        args.particles = (
            50 if args.config in ("slam", "recovery", "latency") else 4096
        )
    if args.early_exit is None:
        args.early_exit = (
            2 if args.config == "batch" and args.mode == "rollout" else 0
        )

    if args.config == "slam":
        return bench_slam(args)
    if args.config == "multiswarm":
        return bench_multiswarm(args)
    if args.config == "recovery":
        return bench_recovery(args)
    if args.config == "latency":
        return bench_latency(args)

    import jax

    from ndtpso_slam.parallel import mesh as mesh_mod

    b = args.batch
    t0 = time.time()
    map_cfg, pso_cfg, inputs, true_offsets = batch_setup(
        b, args.beams, args.pad_beams, args.particles, args.iters, args.cells
    )
    log(f"setup {time.time()-t0:.1f}s; B={b} P={args.particles} I={args.iters} "
        f"N={args.pad_beams}")

    n_dev = 1
    if args.sharded:
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = args.devices or len(jax.devices())
        if b % n_dev:
            raise SystemExit(f"--batch {b} must divide over {n_dev} devices")
        smesh = mesh_mod.make_mesh(n_dev)
        solver = mesh_mod.make_sharded_solver(
            smesh, map_cfg, pso_cfg, cost_mode=args.mode,
            early_exit=args.early_exit,
        )
        inputs = jax.device_put(
            inputs, NamedSharding(smesh, P(mesh_mod.SOLVE_AXIS))
        )
        log(f"sharded over {n_dev} devices ({b // n_dev} solves/device)")
        run = lambda: solver(*inputs)
    else:
        run = lambda: mesh_mod.solve_batch(
            *inputs, map_cfg, pso_cfg, cost_mode=args.mode,
            early_exit=args.early_exit,
        )

    t0 = time.time()
    res = run()
    jax.block_until_ready(res)
    log(f"compile+first run {time.time()-t0:.1f}s")
    # Accuracy gate: a kernel regression that wrecks the solve must fail the
    # bench, not print a healthy throughput headline.
    batch_accuracy(res.pose, true_offsets)

    # Throughput protocol: enqueue all reps, block on the last.
    jax.block_until_ready(run())
    t0 = time.time()
    outs = [run() for _ in range(args.reps)]
    jax.block_until_ready(outs[-1])
    total = time.time() - t0
    solves_per_s = b * args.reps / total
    log(f"{args.reps} reps in {total:.3f}s -> {solves_per_s:.1f} solves/s "
        f"over {n_dev} device(s)")
    emit(
        f"scan_match_solves_per_s_{args.particles}p_{args.iters}i_{args.mode}"
        + (f"_ee{args.early_exit}" if args.early_exit else "")
        + (f"_sharded{n_dev}dev" if args.sharded else ""),
        solves_per_s, "solves/s",
    )


def bench_slam(args):
    """BASELINE config 3: sequential SLAM over a recorded log at LiDAR rate.

    Metric: scans/s through `run_offline` (one lax.scan program); baseline is
    the reference's 10 Hz LiDAR-rate budget."""
    import jax
    import jax.numpy as jnp

    from ndtpso_slam import config as cfgm
    from ndtpso_slam.io import synthetic
    from ndtpso_slam.models import scan as scan_mod, slam

    if args.soak:
        args.full_scale = True  # soak is defined at deployment scale
    if args.full_scale:
        # Reference deployment scale (`launch/scan.launch:10-16`,
        # `ndtpso_slam_node.hpp:25-34`, `config.h:8`): 300 m frame, 0.5 m
        # cells (360k cells), 100-slot window, 0.1 m occupancy grid.  The
        # stencil binders roll a scan-sized patch instead of the 360k-cell
        # table (cost.py:bind_neighborhood).
        map_cfg = cfgm.MapConfig(size_m=300.0, cell_side_m=0.5, window_slots=100)
        if args.patch_range > 0:
            map_cfg = dataclasses.replace(
                map_cfg,
                stencil_patch_cells=map_cfg.patch_cells_for_range(args.patch_range),
            )
    else:
        map_cfg = cfgm.MapConfig(size_m=64.0, cell_side_m=0.5, window_slots=8)
    if args.window_slots:
        map_cfg = dataclasses.replace(map_cfg, window_slots=args.window_slots)
    if args.ring_rows:
        map_cfg = dataclasses.replace(map_cfg, ring_rows=args.ring_rows)
    cfg = cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=30, population=max(args.particles, 50)),
        map=map_cfg,
        scan=cfgm.ScanConfig(max_beams=args.pad_beams),
        og=cfgm.OccupancyGridConfig(enabled=args.og),
        cost_mode=args.mode,
        solver_early_exit=args.early_exit if args.mode == "rollout" else 0,
    )
    t0 = time.time()
    b = args.robots
    if args.soak:
        # 1200-scan default: one full 157 m loop of a pillar hall.  The
        # central pillars stay in LiDAR range the whole run, so their
        # cells' sliding windows rotate >window_slots times — the
        # wraparound/eviction regime (`ndtcell.cpp:61-65` mod-100) that
        # a 50-scan bench never reaches.
        n_scans = args.soak
        logs = [
            synthetic.make_soak_log(seed=2 + r, n_scans=n_scans,
                                    n_beams=args.beams)
            for r in range(b)
        ]
    else:
        n_scans = 50
        logs = [
            synthetic.make_log(seed=2 + r, n_scans=n_scans,
                               n_beams=args.beams, world_size=50.0)
            for r in range(b)
        ]

    def load_log(lg):
        loaded = [
            scan_mod.load_laser(r, lg.angle_min, lg.angle_increment,
                                lg.range_max, cfg.scan, cfg.map)
            for r in lg.ranges
        ]
        return scan_mod.Scan(
            points=jnp.stack([s.points for s in loaded]),
            valid=jnp.stack([s.valid for s in loaded]),
        )

    per_robot = [load_log(lg) for lg in logs]
    if b == 1:
        scans = per_robot[0]
        state0 = slam.init_slam(cfg, initial_pose=tuple(logs[0].poses[0]))
    else:
        scans = scan_mod.Scan(
            points=jnp.stack([s.points for s in per_robot]),
            valid=jnp.stack([s.valid for s in per_robot]),
        )
        state0 = slam.init_slam_batch(
            cfg, np.stack([lg.poses[0] for lg in logs]).astype(np.float32)
        )
    scans, state0 = jax.device_put((scans, state0))
    log(f"setup {time.time()-t0:.1f}s; B={b} T={n_scans} "
        f"P={cfg.pso.population} I={cfg.pso.iterations}")

    if b == 1:
        key = (np.uint32(3), np.uint32(9))
        run = lambda: slam.run_offline(state0, scans, key, cfg)
    else:
        keys = np.stack(
            [np.full(b, 3, np.uint32), np.arange(9, 9 + b, dtype=np.uint32)],
            -1,
        )
        if args.fleet_mode == "flat":
            from ndtpso_slam.parallel.fleet import run_offline_fleet

            run = lambda: run_offline_fleet(state0, scans, keys, cfg)
        else:
            run = lambda: slam.run_offline_batch(state0, scans, keys, cfg)
    t0 = time.time()
    final_state, poses, _ = run()
    jax.block_until_ready(poses)
    log(f"compile+first run {time.time()-t0:.1f}s")
    p = np.asarray(poses).reshape(b, n_scans, 3)  # drain
    gt = np.stack([lg.poses for lg in logs])
    err = np.hypot(p[..., 0] - gt[..., 0], p[..., 1] - gt[..., 1])
    per_robot = err.mean(axis=1)
    log(f"traj err: mean {err.mean():.4f} m, max {err.max():.4f} m, "
        f"worst robot mean {per_robot.max():.4f} m")
    if args.soak:
        # Calibrated on the 2400-scan dock+oval log against a CPU reference
        # run over the 153 m lap (no loop closure — the reference has none
        # either).
        assert per_robot.max() < 0.15 and err.max() < 1.5, (
            f"soak drift regressed: per-robot mean {np.round(per_robot, 4)} "
            f"m, max {err.max():.4f} m over the ~153 m lap"
        )
        rot = np.asarray(final_state.map.rot_count).reshape(b, -1)
        wrapped_cells = (rot >= cfg.map.window_slots).sum(axis=-1)
        log(f"ring rotations: max {rot.max()} (window={cfg.map.window_slots}); "
            f"cells wrapped per robot: {wrapped_cells}")
        # The soak's whole point: the sliding window must actually WRAP
        # (old slots evicted), not just fill.
        assert (wrapped_cells > 0).all(), (
            f"soak never wrapped the {cfg.map.window_slots}-slot ring: max "
            f"rotations {rot.max()} — lengthen the log or slow the loop"
        )
        try:
            ms = jax.devices()[0].memory_stats()
            log(f"device memory: {ms.get('bytes_in_use', 0)/2**30:.2f} GiB in "
                f"use / {ms.get('bytes_limit', 0)/2**30:.2f} GiB limit")
        except Exception as e:  # memory_stats is optional on some backends
            log(f"device memory stats unavailable: {e}")
    else:
        # Gate calibrated to the reference's own 30x50 budget at 0.5 m cells;
        # it catches the frozen-binding failure mode (metre-scale drift).
        # Gated PER ROBOT so one degraded session can't hide in a fleet mean.
        assert per_robot.max() < 0.35 and err.max() < 0.7, (
            f"SLAM trajectory accuracy regressed: per-robot mean "
            f"{np.round(per_robot, 4)} m, max {err.max():.4f} m"
        )

    # Release the accuracy-run's session state before any further dispatch:
    # holding it across the warmup would keep TWO fleet states live (~2.8
    # GiB each at full scale x 8 robots) and OOM HBM.
    del final_state
    jax.block_until_ready(run()[1])
    # Queued reps each allocate their session-state output AT DISPATCH; for
    # a full-scale fleet that is ~3 GB per rep and the queue OOMs HBM
    # (observed RESOURCE_EXHAUSTED).  Big-state configs therefore time
    # sequential blocking reps (costs one dispatch round-trip per rep,
    # ~5% on a 50-scan program — noted here for honest comparison);
    # small-state configs keep the pipelined-queue protocol.
    state_bytes = sum(
        np.prod(x.shape) * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(state0)
    )
    sequential = state_bytes * (args.reps + 1) > 6e9
    t0 = time.time()
    if sequential:
        log(f"timing protocol: sequential blocking reps "
            f"(state {state_bytes/2**30:.2f} GiB x {args.reps} reps would "
            "overflow HBM if queued)")
        for _ in range(args.reps):
            st_r, poses_r, costs_r = run()
            jax.block_until_ready(poses_r)
            del st_r, poses_r, costs_r
    else:
        outs = [run() for _ in range(args.reps)]
        jax.block_until_ready(outs[-1][1])
    total = time.time() - t0
    scans_per_s = b * n_scans * args.reps / total
    log(f"{args.reps} reps -> {scans_per_s:.1f} scans/s aggregate over {b} "
        f"robot(s) (LiDAR rate 10 Hz)")
    scale = "_fullscale" if args.full_scale else ""
    if cfg.solver_early_exit:
        scale += f"_ee{cfg.solver_early_exit}"
    if args.soak:
        scale = f"_soak{args.soak}"
    if args.window_slots:
        scale += f"_w{args.window_slots}"
    if args.ring_rows:
        scale += f"_r{args.ring_rows}"
    og = "_og" if args.og else ""
    robots = f"_{b}robots" if b > 1 else ""
    if b > 1 and args.fleet_mode == "flat":
        robots += "_flat"
    emit(
        f"sequential_slam_scans_per_s_{cfg.pso.population}p_"
        f"{cfg.pso.iterations}i_{cfg.cost_mode}{scale}{og}{robots}",
        scans_per_s, "scans/s",
    )


def bench_recovery(args):
    """Tracking-loss recovery on the card (new capability — the reference
    has none, SURVEY §5 'failure detection: none').

    Three numbers an operator needs, measured as single `slam_step` calls on
    a prebuilt map (so compile cost is two slam_step variants, not a whole
    rollout program):

    * kidnapped-event latency — the step where `lax.cond` takes the
      3-stage relocalization branch (`models/slam.py:_relocalize`), against
      the 10 Hz scan budget;
    * healthy-step time with recovery compiled in (branch not taken);
    * healthy-step time with recovery off — the overhead of enabling it.

    Headline metric: recovery events/s (1/latency); >= 10/s means a
    relocalization fits inside one LiDAR period.
    """
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    from ndtpso_slam import config as cfgm
    from ndtpso_slam.io import synthetic
    from ndtpso_slam.models import ndt_map, scan as scan_mod, slam
    from ndtpso_slam.ops.geometry import transform_points

    if args.full_scale:
        # Reference deployment scale (`scan.launch:14`, `config.h:8`):
        # 300 m frame, 0.5 m cells = 360k cells, window 100.  The stage-2/3
        # binder reads a recovery.patch_cells window here
        # (cost.py:bind_points_matmul_window) — the full-table one-hot
        # matmul would be 553 MB/rebind at this C (ADVICE r3 medium #1).
        map_cfg = cfgm.MapConfig(
            size_m=300.0, cell_side_m=0.5,
            window_slots=args.window_slots or 100,
        )
    else:
        map_cfg = cfgm.MapConfig(size_m=64.0, cell_side_m=0.5, window_slots=8)
    base = cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=30, population=max(args.particles, 50)),
        map=map_cfg,
        scan=cfgm.ScanConfig(max_beams=args.pad_beams),
        cost_mode="local_exact",
    )
    # Pure shipped defaults: grid_beam_stride=0 (auto) resolves to 2 at
    # full scale (sweep is gather-row-bound and dominates event latency),
    # 1 at test scale; the in-bench relocalization accuracy gate below
    # validates whatever the auto rule picked.
    cfg_rec = dc.replace(base, recovery=cfgm.RecoveryConfig(enabled=True))

    t0 = time.time()
    lg = synthetic.make_log(seed=3, n_scans=31, n_beams=args.beams,
                            world_size=50.0)
    loaded = [
        scan_mod.load_laser(r, lg.angle_min, lg.angle_increment,
                            lg.range_max, base.scan, map_cfg)
        for r in lg.ranges
    ]
    # Build the map at ground truth (no align — we are benching one step,
    # not a whole session; run_offline's compile is benched by --config
    # slam).
    st = slam.init_slam(cfg_rec, initial_pose=tuple(lg.poses[0]))
    m = st.map
    # build_touched prebuild (bit-identical to the dense build under the
    # build-after-every-ingest invariant, tests/test_map.py) — the dense
    # [C, S] pass is infeasible at --full-scale (360k x 100 slots).
    from ndtpso_slam.ops.geometry import cell_index
    prev_ids = jnp.full((args.pad_beams,), map_cfg.num_cells, jnp.int32)
    for s, pose in zip(loaded[:30], lg.poses[:30]):
        wpts = transform_points(s.points, jnp.asarray(pose, jnp.float32))
        idx, inb = cell_index(
            wpts, size_m=map_cfg.size_m, cell_side_m=map_cfg.cell_side_m,
            cells_per_side=map_cfg.cells_per_side,
        )
        ids = jnp.where(s.valid & inb, idx, map_cfg.num_cells)
        m = ndt_map.add_points(m, map_cfg, wpts, s.valid)
        m = ndt_map.build_touched(m, map_cfg, jnp.concatenate([ids, prev_ids]))
        prev_ids = ids
    prev_pose = jnp.asarray(lg.poses[29], jnp.float32)
    st = st.replace(
        map=m,
        prev_ids=prev_ids,
        pose=prev_pose,
        align=slam.AlignState(
            prev_pose=prev_pose,
            pose_diff=jnp.asarray(
                lg.poses[29] - lg.poses[28], jnp.float32
            ),
            iter=jnp.asarray(30, jnp.int32),
        ),
        step=jnp.asarray(30, jnp.int32),
    )
    healthy = loaded[30]  # scan from poses[30]: normal next step
    # Kidnapped: the robot was teleported inside the relocalization
    # spread (±3 m, ±π) but believes it is at poses[29].
    kid_pose = lg.poses[30] + np.float64([2.3, -1.8, 2.2])
    kid_r = synthetic.raycast(
        synthetic.make_world(seed=3, size=50.0), kid_pose, args.beams,
        lg.angle_min, lg.angle_increment, lg.range_max,
    )
    kidnapped = scan_mod.load_laser(
        kid_r.astype(np.float32), lg.angle_min, lg.angle_increment,
        lg.range_max, base.scan, map_cfg,
    )
    st, healthy, kidnapped = jax.device_put((st, healthy, kidnapped))
    st_norec = st.replace()  # same pytree; configs differ at jit time
    key = (np.uint32(11), np.uint32(13))
    log(f"setup {time.time()-t0:.1f}s; P={base.pso.population} "
        f"I={base.pso.iterations} grid={cfg_rec.recovery.grid}")

    def timed(fn, label, reps):
        t0 = time.time()
        out = fn()
        jax.block_until_ready(out)
        np.asarray(out[1])  # force a real device->host round-trip
        compile_s = time.time() - t0
        np.asarray(fn()[1])
        # Dispatch every rep, then read the last one back: the readback
        # waits for the whole queue.
        t0 = time.time()
        outs = [fn() for _ in range(reps)]
        np.asarray(outs[-1][1])
        dt = (time.time() - t0) / reps
        log(f"{label}: {dt*1e3:.2f} ms/step (compile+first {compile_s:.1f}s)")
        return out, dt

    out_k, t_kid = timed(
        lambda: slam.slam_step(st, kidnapped, key, cfg_rec),
        "kidnapped step (recovery taken)", args.reps,
    )
    out_h, t_heal = timed(
        lambda: slam.slam_step(st, healthy, key, cfg_rec),
        "healthy step (recovery compiled, not taken)", args.reps,
    )
    _, t_off = timed(
        lambda: slam.slam_step(st_norec, healthy, key, base),
        "healthy step (recovery off)", args.reps,
    )

    st_k = out_k[0]
    assert int(st_k.recoveries) == 1, (
        f"kidnapped step did not relocalize (recoveries={int(st_k.recoveries)})"
    )
    err = np.abs(np.asarray(out_k[1]) - kid_pose)
    err[2] = abs((err[2] + np.pi) % (2 * np.pi) - np.pi)
    log(f"relocalized pose err vs kidnapped truth: {err.round(4)}")
    assert err[0] < 0.3 and err[1] < 0.3 and err[2] < 0.1, (
        f"relocalization missed the kidnapped pose: err {err.round(4)}"
    )
    st_h = out_h[0]
    assert int(st_h.recoveries) == 0, "healthy step must not relocalize"
    overhead = (t_heal - t_off) / t_off * 100.0
    log(f"recovery=True healthy overhead: {overhead:+.1f}% "
        f"({t_heal*1e3:.2f} vs {t_off*1e3:.2f} ms)")
    events_per_s = 1.0 / t_kid
    log(f"recovery event latency {t_kid*1e3:.1f} ms "
        f"({'fits' if t_kid < 0.1 else 'EXCEEDS'} the 10 Hz budget)")
    emit(
        f"recovery_events_per_s_grid{cfg_rec.recovery.grid[0]}x"
        f"{cfg_rec.recovery.grid[1]}x{cfg_rec.recovery.grid[2]}_"
        f"k{cfg_rec.recovery.k_hypotheses}"
        + ("_fullscale" if args.full_scale else ""),
        events_per_s, "events/s",
    )


def bench_latency(args):
    """One-scan-in, one-pose-out dispatch latency (the reference's actual
    operating mode: one `scan_matcher_` callback per LiDAR message at 10 Hz,
    `ndtpso_slam_node.cpp:177-244`).

    The throughput rows dispatch whole `lax.scan` programs, so the host
    dispatch overhead amortizes away; an online robot pays it EVERY scan.  This config pins the per-scan number: the distribution
    (p50/p95) of >=100 blocking single `slam_step` dispatches on a prebuilt
    deployment-scale map, plus the same distribution for a no-op dispatch
    (a jitted [8] add with device->host readback) — the host dispatch
    floor, so compute = step - noop is attributable.

    Headline metric: p50 step latency in ms; <= 100 ms (one 10 Hz period)
    means a healthy step fits the budget.
    """
    import jax
    import jax.numpy as jnp

    from ndtpso_slam import config as cfgm
    from ndtpso_slam.io import synthetic
    from ndtpso_slam.models import ndt_map, scan as scan_mod, slam
    from ndtpso_slam.ops.geometry import cell_index, transform_points

    if args.full_scale:
        map_cfg = cfgm.MapConfig(
            size_m=300.0, cell_side_m=0.5,
            window_slots=args.window_slots or 100,
        )
    else:
        map_cfg = cfgm.MapConfig(size_m=64.0, cell_side_m=0.5, window_slots=8)
    if args.ring_rows:
        map_cfg = dataclasses.replace(map_cfg, ring_rows=args.ring_rows)
    cfg = cfgm.SlamConfig(
        pso=cfgm.PSOConfig(iterations=30, population=max(args.particles, 50)),
        map=map_cfg,
        scan=cfgm.ScanConfig(max_beams=args.pad_beams),
        cost_mode=args.mode,
        solver_early_exit=args.early_exit if args.mode == "rollout" else 0,
    )
    n_steps = max(args.reps, 100)

    t0 = time.time()
    lg = synthetic.make_log(seed=3, n_scans=30 + n_steps,
                            n_beams=args.beams, world_size=50.0)
    loaded = [
        scan_mod.load_laser(r, lg.angle_min, lg.angle_increment,
                            lg.range_max, cfg.scan, map_cfg)
        for r in lg.ranges
    ]
    # Prebuild the map from the first 30 scans at ground truth (same
    # recipe as bench_recovery: we are timing one step, not a session).
    st = slam.init_slam(cfg, initial_pose=tuple(lg.poses[0]))
    m = st.map
    prev_ids = jnp.full((args.pad_beams,), map_cfg.num_cells, jnp.int32)
    for s, pose in zip(loaded[:30], lg.poses[:30]):
        wpts = transform_points(s.points, jnp.asarray(pose, jnp.float32))
        idx, inb = cell_index(
            wpts, size_m=map_cfg.size_m, cell_side_m=map_cfg.cell_side_m,
            cells_per_side=map_cfg.cells_per_side,
        )
        ids = jnp.where(s.valid & inb, idx, map_cfg.num_cells)
        m = ndt_map.add_points(m, map_cfg, wpts, s.valid)
        m = ndt_map.build_touched(m, map_cfg, jnp.concatenate([ids, prev_ids]))
        prev_ids = ids
    prev_pose = jnp.asarray(lg.poses[29], jnp.float32)
    st = st.replace(
        map=m, prev_ids=prev_ids, pose=prev_pose,
        align=slam.AlignState(
            prev_pose=prev_pose,
            pose_diff=jnp.asarray(lg.poses[29] - lg.poses[28], jnp.float32),
            iter=jnp.asarray(30, jnp.int32),
        ),
        step=jnp.asarray(30, jnp.int32),
    )
    live = scan_mod.Scan(
        points=jnp.stack([s.points for s in loaded[30:30 + n_steps]]),
        valid=jnp.stack([s.valid for s in loaded[30:30 + n_steps]]),
    )
    st, live = jax.device_put((st, live))
    key = (np.uint32(11), np.uint32(13))
    log(f"setup {time.time()-t0:.1f}s; {n_steps} single-step dispatches at "
        f"{'full' if args.full_scale else 'test'} scale, mode {args.mode}")

    # No-op dispatch floor: tiny jitted add + device->host readback.
    noop_in = jax.device_put(np.arange(8, dtype=np.float32))
    noop = jax.jit(lambda x: x + 1.0)
    np.asarray(noop(noop_in))  # compile
    noop_ms = []
    for _ in range(n_steps):
        t1 = time.time()
        np.asarray(noop(noop_in))
        noop_ms.append((time.time() - t1) * 1e3)
    noop_ms = np.array(noop_ms)
    log(f"no-op dispatch: p50 {np.percentile(noop_ms, 50):.2f} ms, "
        f"p95 {np.percentile(noop_ms, 95):.2f} ms, "
        f"max {noop_ms.max():.2f} ms (host dispatch floor)")

    # Compile + warm the step, then time each dispatch blocking (the online
    # operating mode: the node cannot pipeline — scan t+1's guess needs
    # pose t).
    t1 = time.time()
    st_w, pose_w, _ = slam.slam_step(st, jax.tree_util.tree_map(
        lambda x: x[0], live), key, cfg)
    np.asarray(pose_w)
    log(f"compile+first step {time.time()-t1:.1f}s")
    del st_w, pose_w
    step_ms = []
    poses = []
    cur = st
    for t in range(n_steps):
        scan_t = jax.tree_util.tree_map(lambda x: x[t], live)
        t1 = time.time()
        cur, pose, _ = slam.slam_step(cur, scan_t, key, cfg)
        p = np.asarray(pose)
        step_ms.append((time.time() - t1) * 1e3)
        poses.append(p)
    step_ms = np.array(step_ms)
    p50, p95 = np.percentile(step_ms, 50), np.percentile(step_ms, 95)
    log(f"slam_step dispatch: p50 {p50:.2f} ms, p95 {p95:.2f} ms, "
        f"min {step_ms.min():.2f}, max {step_ms.max():.2f} ms over {n_steps}")
    log(f"attributable compute (p50 step - p50 noop): "
        f"{p50 - np.percentile(noop_ms, 50):.2f} ms")
    # Accuracy gate: the timed steps must actually track.
    est = np.stack(poses)
    gt = lg.poses[30:30 + n_steps]
    err = np.hypot(est[:, 0] - gt[:, 0], est[:, 1] - gt[:, 1])
    log(f"tracking err over timed steps: mean {err.mean():.4f} m, "
        f"max {err.max():.4f} m")
    assert err.max() < 0.5, f"latency-run tracking regressed: {err.max():.3f} m"

    scale = "_fullscale" if args.full_scale else ""
    emit(f"slam_step_latency_p50_ms_{cfg.cost_mode}{scale}", p50, "ms")


def bench_multiswarm(args):
    """BASELINE config 4: 16 swarms x 4096 particles against one global map,
    cross-swarm global-best merge.  One multi-swarm relocalization = one
    solve; baseline share = 625/16 (16x the per-solve particle budget)."""
    import jax
    import jax.numpy as jnp

    from ndtpso_slam import config as cfgm
    from ndtpso_slam.io import synthetic
    from ndtpso_slam.models import cost as cost_mod, ndt_map, scan as scan_mod
    from ndtpso_slam.parallel.multi_swarm import (
        multi_swarm_rollout, multi_swarm_solve,
    )

    k_swarms = 16
    map_cfg = cfgm.MapConfig(size_m=64.0, cell_side_m=args.cells, window_slots=4)
    pso_cfg = cfgm.PSOConfig(iterations=args.iters, population=args.particles)
    scan_cfg = cfgm.ScanConfig(max_beams=args.pad_beams)
    rs = np.random.RandomState(0)
    t0 = time.time()
    segs = synthetic.make_world(seed=1, size=50.0, n_boxes=8)
    ref_r = synthetic.raycast(segs, np.zeros(3), args.beams, -np.pi,
                              2 * np.pi / args.beams, 30.0)
    ref = scan_mod.load_laser(ref_r.astype(np.float32), -np.pi,
                              2 * np.pi / args.beams, 30.0, scan_cfg, map_cfg)
    state = ndt_map.init_map(map_cfg)
    for _ in range(3):
        jp = np.asarray(ref.points) + rs.normal(0, 0.03, (args.pad_beams, 2))
        state = ndt_map.add_points(state, map_cfg, jp.astype(np.float32),
                                   np.asarray(ref.valid))
        state = ndt_map.build(state, map_cfg)
    snap = ndt_map.snapshot(state, map_cfg)
    true = np.float32([0.8, -0.5, 0.06])
    q_r = synthetic.raycast(segs, true.astype(np.float64), args.beams,
                            -np.pi, 2 * np.pi / args.beams, 30.0)
    q = scan_mod.load_laser(q_r.astype(np.float32), -np.pi,
                            2 * np.pi / args.beams, 30.0, scan_cfg, map_cfg)
    # Relocalization: swarm guesses spread over hypotheses around the truth.
    keys = rs.randint(0, 2**31, (k_swarms, 2)).astype(np.uint32)
    hypo = true + rs.uniform(-1.5, 1.5, (k_swarms, 3)).astype(np.float32) * np.float32([1, 1, 0.1])
    snap, q, keys, hypo = jax.device_put((snap, q, keys, hypo))
    log(f"setup {time.time()-t0:.1f}s; K={k_swarms} P={args.particles} I={args.iters}")

    # Swarms bind at exchanged global bests that can be far from any one
    # swarm's hypothesis, so the stencil binding doesn't apply here.
    # 'fast_matmul' replaces the per-iteration [N]-row binding gathers with
    # the one-hot matmul binder (bit-identical; cost.py:bind_points_matmul).
    if args.mode == "rollout":
        # Island-model: K swarms as one B=K batch of the whole-solve rollout
        # kernel, exact-cost final merge (multi_swarm_rollout).  No periodic
        # exchange — for spread relocalization hypotheses the exchange is a
        # diversity loss.
        run = jax.jit(lambda k, h: multi_swarm_rollout(
            k, h, jnp.float32([0.6, 0.6, 0.1]), snap, q.points, q.valid,
            pso_cfg, map_cfg,
            early_exit=args.early_exit,
        ))
    else:
        if args.mode == "fast_matmul":
            tbl = cost_mod.snapshot_table(snap)
            cost_fn = lambda poses, bind: cost_mod.bound_cost(
                poses, cost_mod.bind_points_matmul(bind, tbl, q.points, q.valid, map_cfg)
            )
        else:
            cost_fn = lambda poses, bind: cost_mod.bound_cost(
                poses, cost_mod.bind_points(bind, snap, q.points, q.valid, map_cfg)
            )
        run = jax.jit(lambda k, h: multi_swarm_solve(
            k, h, jnp.float32([0.6, 0.6, 0.1]), cost_fn, pso_cfg, exchange_every=5
        ))
    t0 = time.time()
    res = run(keys, hypo)
    jax.block_until_ready(res)
    log(f"compile+first run {time.time()-t0:.1f}s")
    pose = np.asarray(res.pose)  # drain
    log(f"relocalized pose {pose.round(4)} vs true {true.round(4)} "
        f"(err {np.abs(pose - true).round(4)})")
    perr = np.abs(pose - true)
    assert perr[:2].max() < 0.1 and perr[2] < 0.02, (
        f"relocalization accuracy regressed: err {perr.round(4)}"
    )

    jax.block_until_ready(run(keys, hypo))
    t0 = time.time()
    outs = [run(keys, hypo) for _ in range(args.reps)]
    jax.block_until_ready(outs[-1])
    total = time.time() - t0
    relocs_per_s = args.reps / total
    log(f"{args.reps} reps -> {relocs_per_s:.2f} relocalizations/s")
    emit(
        f"multiswarm_relocalizations_per_s_{k_swarms}x{args.particles}p_"
        f"{args.iters}i_{args.mode}"
        + (f"_ee{args.early_exit}" if args.early_exit else ""),
        relocs_per_s, "relocs/s",
    )


if __name__ == "__main__":
    main()
