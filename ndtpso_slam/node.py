"""The SLAM node: streaming session + CLI — the ROS-node capability, ROS-free.

Re-designs `NDTPSONode` (`src/ndtpso_slam_node.cpp`, `src/main.cpp`) as a
plain streaming session: scans come from a scan log (native ``.ndtlog`` or
``.npz``) or any iterator, poses go to registered callbacks ("publishers"),
rate metrics are logged like the reference's per-scan report
(`ndtpso_slam_node.cpp:239`), and shutdown dumps the export bundle
(`ndtpso_slam_node.cpp:154-174`).  The latched TF mount transform becomes an
explicit ``mount_trans`` parameter applied at scan load
(`TRANSFORM_POINTS_AT_LOAD`, `ndtframe.cpp:174-177`).

Config mirrors the three-tier reference system: dataclass defaults
(= compile-time defines), a JSON "launch" file (= launch/*.launch), CLI flags
(= rosparam overrides).  The reference node's ``pso_c2``-into-``c1`` param
bug (`ndtpso_slam_node.cpp:34`) is deliberately not replicated.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, List, Optional

import numpy as np

from ndtpso_slam import config as cfgm
from ndtpso_slam.models import scan as scan_mod
from ndtpso_slam.models import slam
from ndtpso_slam.ops import rng
from ndtpso_slam.utils import export as export_mod
from ndtpso_slam.utils import profiling


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """Node-level parameters (`ndtpso_slam_node.hpp:24-34`, scan.launch)."""

    frame_size_m: float = 300.0
    cell_side_m: float = 0.5
    map_size_m: float = 25.0  # export-only global map extent
    rate_hz: int = 10
    og_cell_size_m: float = 0.1
    build_og: bool = False
    init_pose: tuple = (0.0, 0.0, 0.0)
    mount_trans: tuple = (0.0, 0.0, 0.0)  # latched base<-scan transform
    pso_iterations: int = 30
    pso_population: int = 50
    pso_w: float = cfgm.PSO_W
    pso_c1: float = cfgm.PSO_C1
    pso_c2: float = cfgm.PSO_C2
    pso_w_damping: float = cfgm.PSO_W_DAMPING
    window_slots: int = cfgm.NDT_WINDOW_SIZE
    max_beams: int = 1024
    # local_exact: per-particle stencil rebind — exact correspondences with
    # no gathers in the loop.  The frozen-binding 'fast*' modes measurably
    # lose tracking at the default 0.5 m cell side (see models/cost.py:
    # stencil_exact_cost); they remain available for coarser maps.
    cost_mode: str = "local_exact"
    # 'pso' (deployed) | 'glir' (the reference's GLIR-PSO API surface,
    # core.h:21-23; XLA cost modes only — see SlamConfig.optimizer).
    optimizer: str = "pso"
    seed: int = 42
    save_every: int = 10  # SAVE_DATA_TO_FILE_EACH_NUM_ITERS
    save_map_images: bool = False
    # Tracking-loss recovery (a capability the reference lacks; SURVEY §5
    # "failure detection: none").  Off by default to match reference behavior.
    recovery: bool = False
    recovery_fitness_threshold: float = 0.15
    recovery_hypotheses: int = 8
    # Max laser range the stencil patch must cover (m); 0 (default) lets
    # the binder pick its strategy automatically (cost.py:bind_neighborhood
    # — direct [N*K2]-row gather above GATHER_BIND_MIN_CELLS (8k), roll
    # below).  >0 forces the dynamic-slice patch roll, which caps the
    # transient device memory of the bind.
    patch_range_m: float = 0.0
    # Sparse sliding-window storage (MapConfig.ring_rows): 0 = dense (one
    # ring row per cell); R > 0 allocates R rows assigned on first build —
    # the memory/fleet knob (ring HBM and per-step copy traffic shrink by
    # C/R; size R to the deployment's visited-cell count).
    ring_rows: int = 0
    # PREFER_FRONTAL_POINTS beam decimation (`config.h:11`) — the
    # reference's compile-time knob as a runtime one.  Off by default like
    # upstream; lossy by design (ScanConfig.prefer_frontal_points).
    prefer_frontal_points: bool = False

    def slam_config(self) -> cfgm.SlamConfig:
        map_cfg = cfgm.MapConfig(
            size_m=self.frame_size_m,
            cell_side_m=self.cell_side_m,
            window_slots=self.window_slots,
            ring_rows=self.ring_rows,
        )
        if self.patch_range_m > 0:
            map_cfg = dataclasses.replace(
                map_cfg,
                stencil_patch_cells=map_cfg.patch_cells_for_range(self.patch_range_m),
            )
        return cfgm.SlamConfig(
            pso=cfgm.PSOConfig(
                iterations=self.pso_iterations,
                population=self.pso_population,
                w=self.pso_w,
                c1=self.pso_c1,
                c2=self.pso_c2,
                w_damping=self.pso_w_damping,
            ),
            map=map_cfg,
            scan=cfgm.ScanConfig(
                max_beams=self.max_beams,
                prefer_frontal_points=self.prefer_frontal_points,
            ),
            og=cfgm.OccupancyGridConfig(
                cell_size_m=self.og_cell_size_m, enabled=self.build_og
            ),
            recovery=cfgm.RecoveryConfig(
                enabled=self.recovery,
                fitness_threshold=self.recovery_fitness_threshold,
                k_hypotheses=self.recovery_hypotheses,
            ),
            cost_mode=self.cost_mode,
            optimizer=self.optimizer,
        )

    @staticmethod
    def from_json(path: str, **overrides) -> "NodeConfig":
        with open(path) as f:
            # Keys starting with "_" are comments (launch/*.json use one).
            data = {k: v for k, v in json.load(f).items()
                    if not k.startswith("_")}
        data.update({k: v for k, v in overrides.items() if v is not None})
        fields = {f.name for f in dataclasses.fields(NodeConfig)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
        for key in ("init_pose", "mount_trans"):
            if key in data:
                data[key] = tuple(data[key])
        return NodeConfig(**data)


class SlamNode:
    """Streaming SLAM session: feed scans, get poses."""

    def __init__(self, node_cfg: NodeConfig, verbose: bool = True):
        self.cfg = node_cfg
        self.slam_cfg = node_cfg.slam_config()
        self.state = slam.init_slam(self.slam_cfg, node_cfg.init_pose)
        self.global_map = export_mod.GlobalMap(keep_every=node_cfg.save_every)
        self.meter = profiling.RateMeter()
        self.pose_callbacks: List[Callable] = []
        self.verbose = verbose
        self._key = (np.uint32(node_cfg.seed), np.uint32(node_cfg.seed ^ 0x9E3779B9))
        self._mount = (
            np.asarray(node_cfg.mount_trans, np.float32)
            if any(abs(v) > 1e-9 for v in node_cfg.mount_trans)
            else None
        )
        self._step = 0
        self._warned_ring_overflow = False

    def on_pose(self, callback: Callable) -> None:
        """Register a pose 'publisher' (timestamp, pose[3]) -> None."""
        self.pose_callbacks.append(callback)

    def process_scan(
        self,
        ranges: np.ndarray,
        angle_min: float,
        angle_increment: float,
        range_max: float,
        timestamp: float = 0.0,
        odom=None,
    ) -> np.ndarray:
        """One scan callback (`scan_matcher_`, `ndtpso_slam_node.cpp:177-244`).

        Returns the estimated [3] pose.
        """
        with self.meter.tick():
            sc = scan_mod.load_laser(
                np.asarray(ranges, np.float32),
                angle_min,
                angle_increment,
                range_max,
                self.slam_cfg.scan,
                self.slam_cfg.map,
                mount=self._mount,
            )
            # Key derived from the *state's* step counter so a restored
            # checkpoint resumes the exact same random stream.
            key = rng.threefry2x32(
                self._key, np.uint32(int(self.state.step)), np.uint32(0)
            )
            self.state, pose, _cost = slam.slam_step(
                self.state, sc, key, self.slam_cfg
            )
            pose_np = np.asarray(pose, np.float64)
            self.global_map.add_scan(
                np.asarray(sc.points), np.asarray(sc.valid), pose_np
            )
            self.global_map.add_pose(timestamp, pose_np, odom)
            self._step += 1
        for cb in self.pose_callbacks:
            cb(timestamp, pose_np)
        if (
            self.cfg.ring_rows > 0
            and not self._warned_ring_overflow
            and int(self.state.map.ring_overflow) > 0
        ):
            # Undersized R silently stops NEW cells from ever building
            # (they score as out-of-map) — make it loud the moment it
            # starts, not just in tests.  One warning per session; the
            # shutdown report carries the final count.
            self._warned_ring_overflow = True
            print(
                f"[ndtpso] WARNING: sparse ring overflow — "
                f"{int(self.state.map.ring_overflow)} distinct cell(s) got no "
                f"ring row (ring_rows={self.cfg.ring_rows} exhausted; newly "
                "visited cells will not build). Increase NodeConfig.ring_rows "
                "by at least the reported count.",
                file=sys.stderr,
            )
        if self.verbose and self._step > 1:
            extra = ""
            if self.slam_cfg.recovery.enabled:
                extra = (
                    f", fitness {float(self.state.fitness):.3f}"
                    f", recoveries {int(self.state.recoveries)}"
                )
            print(
                f"[ndtpso] scan {self._step}: pose "
                f"({pose_np[0]:.3f}, {pose_np[1]:.3f}, {pose_np[2]:.3f}) | "
                f"avg rate {self.meter.average_rate_hz:.2f} Hz, "
                f"matching rate {self.meter.matching_rate_hz:.2f} Hz" + extra,
                file=sys.stderr,
            )
        return pose_np

    def run_log(self, log) -> np.ndarray:
        """Process a whole ScanLog; returns [T, 3] poses."""
        poses = []
        for i in range(len(log.ranges)):
            odom = log.odoms[i] if log.odoms is not None else None
            poses.append(
                self.process_scan(
                    log.ranges[i], log.angle_min, log.angle_increment,
                    log.range_max, timestamp=float(log.timestamps[i]), odom=odom,
                )
            )
        return np.array(poses)

    def shutdown(self, basename: Optional[str] = None) -> List[str]:
        """Export the map bundle (`ndtpso_slam_node.cpp:131-174`)."""
        if basename is None:
            basename = "ndtpso-" + time.strftime("%Y%m%d-%H%M%S")
        if self.cfg.ring_rows > 0:
            overflow = int(self.state.map.ring_overflow)
            if overflow > 0:
                print(
                    f"[ndtpso] ring overflow at shutdown: {overflow} distinct "
                    f"cell(s) never built (ring_rows={self.cfg.ring_rows} too "
                    f"small — {self.cfg.ring_rows + overflow} rows would have "
                    "sufficed)",
                    file=sys.stderr,
                )
        og = None
        og_bbox = None
        if self.state.og is not None:
            og = np.asarray(self.state.og.og)
            og_bbox = (
                int(self.state.og.min_x), int(self.state.og.max_x),
                int(self.state.og.min_y), int(self.state.og.max_y),
            )
        return export_mod.dump_map(
            basename,
            global_map=self.global_map,
            save_poses=True,
            save_points=True,
            save_image=self.cfg.save_map_images,
            map_cfg=self.slam_cfg.map,
            pso_cfg=self.slam_cfg.pso,
            og=og,
            og_bbox=og_bbox,
            og_cfg=self.slam_cfg.og,
            map_state=self.state.map,
        )

    def save_checkpoint(self, path: str) -> None:
        from ndtpso_slam.utils import checkpoint

        checkpoint.save(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        from ndtpso_slam.utils import checkpoint

        self.state = checkpoint.restore(path, self.state)


def _load_log(path: str):
    from ndtpso_slam.io.importers import load_log

    return load_log(path)


class MultiSessionNode:
    """N concurrent SLAM sessions on one chip — the reference's dual-LiDAR
    deployment (one OS process per sensor, `launch/lidar_front.launch` +
    `lidar_back.launch`) as ONE process and one compiled program.

    Sessions share one ``SlamConfig`` (one compile covers the pool — the
    reference's front/back configs differ only in topics/outputs too);
    per-session mount transforms and start poses come from the per-session
    ``NodeConfig``s.  Scans are dispatched through
    :class:`~ndtpso_slam.parallel.sessions.SlamSessionPool`, so sensors
    at different rates interleave freely and each session's trajectory is
    identical to running it alone (tests/test_sessions.py).
    """

    def __init__(self, node_cfgs: List[NodeConfig], verbose: bool = True):
        from ndtpso_slam.parallel.sessions import SlamSessionPool

        assert node_cfgs, "need at least one session config"
        ref = node_cfgs[0].slam_config()
        for c in node_cfgs[1:]:
            if c.slam_config() != ref:
                raise ValueError(
                    "multi-session mode needs shape-identical SLAM configs "
                    "(sessions share one compiled program); per-session "
                    "init_pose / mount_trans may differ"
                )
        self.cfgs = node_cfgs
        self.slam_cfg = ref
        self.verbose = verbose
        n = len(node_cfgs)
        keys = np.stack(
            [
                np.array(
                    [c.seed + 101 * i, (c.seed + 101 * i) ^ 0x9E3779B9],
                    np.uint32,
                )
                for i, c in enumerate(node_cfgs)
            ]
        )
        self.pool = SlamSessionPool(
            ref,
            np.stack([np.float32(c.init_pose) for c in node_cfgs]),
            keys,
        )
        self._mounts = [
            np.asarray(c.mount_trans, np.float32)
            if any(abs(v) > 1e-9 for v in c.mount_trans) else None
            for c in node_cfgs
        ]
        self.global_maps = [
            export_mod.GlobalMap(keep_every=c.save_every) for c in node_cfgs
        ]
        self._pending_meta: List[List] = [[] for _ in range(n)]
        self._steps = np.zeros(n, np.int64)

    def submit_scan(self, session: int, ranges, angle_min, angle_increment,
                    range_max, timestamp: float = 0.0, odom=None) -> None:
        sc = scan_mod.load_laser(
            np.asarray(ranges, np.float32), angle_min, angle_increment,
            range_max, self.slam_cfg.scan, self.slam_cfg.map,
            mount=self._mounts[session],
        )
        self.pool.submit(session, sc)
        self._pending_meta[session].append((timestamp, odom, sc))

    def poll(self):
        """One pooled step; returns {session: (timestamp, pose [3])}."""
        res = self.pool.poll()
        out = {}
        for sid, (pose, _cost) in res.items():
            ts, odom, sc = self._pending_meta[sid].pop(0)
            pose64 = np.asarray(pose, np.float64)
            self.global_maps[sid].add_scan(
                np.asarray(sc.points), np.asarray(sc.valid), pose64
            )
            self.global_maps[sid].add_pose(ts, pose64, odom)
            self._steps[sid] += 1
            out[sid] = (ts, pose64)
            if self.verbose:
                print(
                    f"[ndtpso s{sid}] scan {self._steps[sid]}: pose "
                    f"({pose64[0]:.3f}, {pose64[1]:.3f}, {pose64[2]:.3f})",
                    file=sys.stderr,
                )
        return out

    def run_logs(self, logs) -> List[np.ndarray]:
        """Interleave N ScanLogs by timestamp (true async rates) and run to
        completion.  Returns per-session [T_i, 3] pose arrays."""
        n = len(logs)
        assert n == len(self.cfgs)
        events = sorted(
            (float(lg.timestamps[i]), s, i)
            for s, lg in enumerate(logs)
            for i in range(len(lg.ranges))
        )
        poses: List[List[np.ndarray]] = [[] for _ in range(n)]

        def drain_poll():
            for sid, (_ts, pose) in self.poll().items():
                poses[sid].append(pose)

        last_ts = None
        for ts, s, i in events:
            if last_ts is not None and ts != last_ts:
                drain_poll()
            lg = logs[s]
            odom = lg.odoms[i] if lg.odoms is not None else None
            self.submit_scan(
                s, lg.ranges[i], lg.angle_min, lg.angle_increment,
                lg.range_max, timestamp=ts, odom=odom,
            )
            last_ts = ts
        while self.pool.pending():
            drain_poll()
        return [np.array(p) for p in poses]

    def shutdown(self, basename: Optional[str] = None) -> List[str]:
        """Per-session export bundles: <basename>-s<i>.*"""
        if basename is None:
            basename = "ndtpso-" + time.strftime("%Y%m%d-%H%M%S")
        files: List[str] = []
        for sid, cfg in enumerate(self.cfgs):
            st = self.pool.session_state(sid)
            og = None
            og_bbox = None
            if st.og is not None:
                og = np.asarray(st.og.og)
                og_bbox = (
                    int(st.og.min_x), int(st.og.max_x),
                    int(st.og.min_y), int(st.og.max_y),
                )
            files += export_mod.dump_map(
                f"{basename}-s{sid}",
                global_map=self.global_maps[sid],
                save_poses=True,
                save_points=True,
                save_image=cfg.save_map_images,
                map_cfg=self.slam_cfg.map,
                pso_cfg=self.slam_cfg.pso,
                og=og,
                og_bbox=og_bbox,
                og_cfg=self.slam_cfg.og,
                map_state=st.map,
            )
        return files


def main(argv=None):
    from ndtpso_slam.utils import compile_cache

    compile_cache.enable()
    ap = argparse.ArgumentParser(
        description="ndtpso SLAM node: run SLAM over a recorded scan log"
    )
    ap.add_argument(
        "--scanlog", required=True, action="append",
        help=".ndtlog or .npz scan log; repeat the flag to run several "
        "sensors' logs as concurrent sessions on one chip (the reference's "
        "lidar_front + lidar_back two-process deployment in one program)",
    )
    ap.add_argument(
        "--config", action="append",
        help="launch JSON (see launch/); with multiple --scanlog, either one "
        "shared config or one per log (shapes must match; init_pose / "
        "mount_trans may differ)",
    )
    ap.add_argument("--out", default=None, help="export basename")
    ap.add_argument("--checkpoint", help="save final SLAM state here (.npz)")
    ap.add_argument("--resume", help="restore SLAM state before running")
    ap.add_argument(
        "--cost-mode",
        choices=list(slam.SLAM_COST_MODES),
        default=None,
        help="exact | fast | fast_local | local_exact | rollout (the "
        "whole-solve kernel of fast_local)",
    )
    ap.add_argument(
        "--optimizer", choices=["pso", "glir"], default=None,
        help="pso (deployed, core.cpp:50-116) | glir (GLIR-PSO variant, "
        "core.h:21-23; XLA cost modes only)",
    )
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--population", type=int, default=None)
    ap.add_argument("--frame-size", type=float, default=None)
    ap.add_argument("--cell-side", type=float, default=None)
    ap.add_argument("--max-beams", type=int, default=None,
                    help="padded beam count (static shape)")
    ap.add_argument("--og", action="store_true", help="build the occupancy grid")
    ap.add_argument(
        "--recovery", action="store_true",
        help="enable tracking-loss detection + multi-swarm relocalization",
    )
    ap.add_argument(
        "--prefer-frontal-points", action="store_true",
        help="the reference's PREFER_FRONTAL_POINTS beam decimation "
        "(config.h:11; off upstream) — lossy, see ScanConfig")
    ap.add_argument("--save-images", action="store_true")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    overrides = dict(
        cost_mode=args.cost_mode,
        optimizer=args.optimizer,
        pso_iterations=args.iterations,
        pso_population=args.population,
        frame_size_m=args.frame_size,
        cell_side_m=args.cell_side,
        max_beams=args.max_beams,
        seed=args.seed,
    )
    if args.og:
        overrides["build_og"] = True
    if args.recovery:
        overrides["recovery"] = True
    if args.prefer_frontal_points:
        overrides["prefer_frontal_points"] = True
    if args.save_images:
        overrides["save_map_images"] = True
    def build_cfg(config_path):
        if config_path:
            return NodeConfig.from_json(config_path, **overrides)
        return dataclasses.replace(
            NodeConfig(), **{k: v for k, v in overrides.items() if v is not None}
        )

    configs = args.config or [None]
    if len(args.scanlog) > 1:
        # Multi-session mode: N logs through one pooled program.
        if args.resume or args.checkpoint:
            ap.error("--resume/--checkpoint are single-session only")
        if len(configs) == 1:
            configs = configs * len(args.scanlog)
        if len(configs) != len(args.scanlog):
            ap.error("--config count must be 1 or match --scanlog count")
        node_cfgs = [build_cfg(c) for c in configs]
        logs = [_load_log(p) for p in args.scanlog]
        mnode = MultiSessionNode(node_cfgs, verbose=not args.quiet)
        t0 = time.time()
        poses = mnode.run_logs(logs)
        dt = time.time() - t0
        total = sum(len(p) for p in poses)
        print(
            f"[ndtpso] processed {total} scans over {len(logs)} sessions in "
            f"{dt:.2f}s ({total / dt:.2f} Hz aggregate)",
            file=sys.stderr,
        )
        for f in mnode.shutdown(args.out):
            print(f"[ndtpso] wrote {f}", file=sys.stderr)
        return 0
    if len(configs) != 1:
        ap.error("one --scanlog takes at most one --config")
    node_cfg = build_cfg(configs[0])

    log = _load_log(args.scanlog[0])
    node = SlamNode(node_cfg, verbose=not args.quiet)
    if args.resume:
        node.load_checkpoint(args.resume)
        print(f"[ndtpso] resumed from {args.resume}", file=sys.stderr)
    t0 = time.time()
    poses = node.run_log(log)
    dt = time.time() - t0
    print(
        f"[ndtpso] processed {len(poses)} scans in {dt:.2f}s "
        f"({len(poses) / dt:.2f} Hz)",
        file=sys.stderr,
    )
    if args.checkpoint:
        node.save_checkpoint(args.checkpoint)
        print(f"[ndtpso] checkpoint -> {args.checkpoint}", file=sys.stderr)
    files = node.shutdown(args.out)
    for f in files:
        print(f"[ndtpso] wrote {f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
