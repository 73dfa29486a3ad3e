"""Configuration dataclasses for the NDT-PSO engine.

The reference (`/root/reference`) has a three-tier config system: compile-time
defines (`include/ndtpso_slam/config.h:5-25`), runtime structs
`PSOConfig`/`NDTPSOConfig` (`config.h:27-45`), and ROS params overriding them
(`src/ndtpso_slam_node.cpp:15-39`). Here everything collapses into frozen,
hashable dataclasses that are consumed at `jit`-trace time: every field that
affects array shapes or compiled control flow is static by construction.

Note: the reference node has a param bug where ``pso_c2`` is read into
``coeff.c1`` (`ndtpso_slam_node.cpp:34`), making c2 unsettable from ROS.  We do
not replicate that node-level bug: :attr:`PSOConfig.c2` is a real knob.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax.numpy as jnp

# Defaults mirroring /root/reference/include/ndtpso_slam/config.h:5-25
NDT_MAX_POINTS_PER_CELL = 50
NDT_WINDOW_SIZE = 100
LASER_IGNORE_EPSILON = 0.1
PSO_ITERATIONS = 50
PSO_POPULATION_SIZE = 30
PSO_W = 0.8
PSO_C1 = 2.0
PSO_C2 = 2.0
PSO_W_DAMPING = 1.0  # "w_dumping" in the reference

# Defaults mirroring /root/reference/include/ndtpso_slam_node.hpp:17-34 and
# launch/scan.launch:10-16
DEFAULT_FRAME_SIZE_M = 300
DEFAULT_CELL_SIZE_M = 0.5
DEFAULT_OG_CELL_SIZE_M = 0.1
DEFAULT_RATE_HZ = 10

# NDTFrame::align's cold-start particle deviation (`ndtframe.cpp:253`).
FIRST_DEVIATION: Tuple[float, float, float] = (0.1, 0.1, 3.1415e-3)
# Near-zero deviation used to seed the initial global best (`core.cpp:53`).
ZERO_DEVIATION: Tuple[float, float, float] = (1e-4, 1e-4, 1e-5)


@dataclasses.dataclass(frozen=True)
class PSOConfig:
    """Particle swarm hyper-parameters (reference `config.h:27-38`).

    ``num_threads`` from the reference has no analogue: particle parallelism is
    a ``vmap`` axis, the chip decides the schedule.
    """

    iterations: int = PSO_ITERATIONS
    population: int = PSO_POPULATION_SIZE
    w: float = PSO_W
    c1: float = PSO_C1
    c2: float = PSO_C2
    w_damping: float = PSO_W_DAMPING


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Geometry + sliding-window budget of the NDT grid map.

    Mirrors `NDTFrame` construction (`ndtframe.cpp:19-66`) and the per-cell
    window macros (`ndtcell.h:13-18`, `config.h:5-8`).  The map is always a
    square, origin-centred frame, like every frame the reference node builds
    (`ndtpso_slam_node.cpp:64-78`).
    """

    size_m: float = float(DEFAULT_FRAME_SIZE_M)
    cell_side_m: float = DEFAULT_CELL_SIZE_M
    window_slots: int = NDT_WINDOW_SIZE
    slot_capacity: int = NDT_MAX_POINTS_PER_CELL
    # Stencil-binding patch side in cells (0 = whole grid).  The stencil
    # binders (`models/cost.py:bind_neighborhood`) pre-roll a packed cell
    # table by every stencil offset; on large maps that table dwarfs the
    # span of one scan (216 MB vs ~600 KB at the 300 m / 0.5 m defaults), so
    # a dynamic-slice patch around the solve's anchor pose is rolled
    # instead.  Must cover the scan: >= 2*range_max/cell_side + 2*radius,
    # see `patch_cells_for_range`.  Scores outside the patch are 0 (the
    # out-of-map convention), bit-identical otherwise.
    stencil_patch_cells: int = 0
    # Sparse sliding-window storage: number of ring-buffer ROWS to allocate
    # (0 = dense, one row per cell — the bit-parity default).  The reference
    # stores cells in a sparse structure and only *touched* cells ever own
    # window state; dense [C, S] rings at the 300 m deployment scale are
    # 849 MB of which a deployment touches a few percent, and XLA's
    # scatter-in-carry lowering pays a full ring copy per scan
    # (experiments/batched_scatter_ab.py), so ring bytes are the fleet's
    # throughput AND memory ceiling.  With ring_rows = R > 0, ring arrays
    # are [R, S, ...] plus a [C] cell->row indirection assigned on first
    # build; once R rows are exhausted every NEWLY visited cell permanently
    # never builds (scores as out-of-map 0), so size R to the deployment's
    # visited-cell count.  Overflow is observable via the state's
    # `ring_overflow` counter (the number of DISTINCT cells that could not
    # get a row — use it directly to size R: R + ring_overflow rows would
    # have sufficed); `SlamNode` warns at runtime when it goes positive.
    # Only the `build_touched` path supports R > 0.
    ring_rows: int = 0

    @property
    def cells_per_side(self) -> int:
        # uint16(ceil(width / cell_side)), ndtframe.cpp:27-28
        return int(math.ceil(self.size_m / self.cell_side_m))

    @property
    def num_cells(self) -> int:
        return self.cells_per_side * self.cells_per_side

    @property
    def half_size_m(self) -> float:
        # s_x_min/s_x_max = ∓width/2 (ndtframe.cpp:57-65)
        return self.size_m / 2.0

    def patch_cells_for_range(self, range_max_m: float, radius: int = 2,
                              margin_cells: int = 8) -> int:
        """Smallest stencil patch (multiple of 8) covering a scan of
        ``range_max_m`` around its anchor, incl. stencil radius and a motion
        margin; capped at the grid side (cap = whole-grid semantics)."""
        need = int(math.ceil(2.0 * range_max_m / self.cell_side_m)) + 2 * radius + margin_cells
        need = (need + 7) // 8 * 8
        return min(need, self.cells_per_side)


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Laser-scan ingestion parameters (`ndtframe.cpp:144-185`).

    ``max_beams`` is the static padded beam count; real scans are masked.
    """

    max_beams: int = 1024
    ignore_epsilon: float = LASER_IGNORE_EPSILON
    # `PREFER_FRONTAL_POINTS` (`config.h:11`, `ndtframe.cpp:157-182`):
    # decimate side-looking beams by a running Σcos(θ) > 0.5 threshold at
    # load.  Compile-time OFF upstream and off here; the knob exists for
    # parity (it solved a CPU-era point-budget problem that the fixed
    # padded beam axis makes free — see PARITY.md), implemented in
    # models/scan.py:_frontal_keep_mask with the reference's exact
    # accumulate-test-reset semantics.  It is lossy by design: on the
    # 30-scan test fixture it drops ~20% of beams and roughly triples
    # mean trajectory drift (0.09 -> 0.26 m) — leave it off unless
    # reproducing upstream-with-the-flag behavior.
    prefer_frontal_points: bool = False


@dataclasses.dataclass(frozen=True)
class OccupancyGridConfig:
    """Occupancy-grid raster config (`ndtframe.cpp:32-45`, node hpp:34)."""

    cell_size_m: float = DEFAULT_OG_CELL_SIZE_M
    enabled: bool = True


# RecoveryConfig.grid_beam_stride = 0 (auto) resolves to 2 at/above this
# many map cells (the reference's 300 m / 0.5 m deployment is 360k), 1 below.
RECOVERY_AUTO_STRIDE_MIN_CELLS = 65536


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Tracking-loss detection + multi-swarm relocalization.

    The reference has no recovery at all: a bad align silently corrupts the
    map and the node only ever dies on exceptions (`main.cpp:21-26`; SURVEY
    §5 "failure detection: none").  This is a new capability: per-scan match
    fitness (mean exact NDT score per valid beam, in [0, 1]) gates a
    K-hypothesis multi-swarm relocalization (`parallel/multi_swarm.py`)
    around the last trusted pose; the relocalized pose is adopted only if
    its exact cost beats the failed align AND its fitness lands inside
    the sane band [``accept_fitness``, 1] (a merely-less-terrible pose is
    rejected — an unrecoverable kidnap stays observable rather than
    corrupting the map — and so is the indefinite-inverse score blow-up,
    see ``accept_fitness``).  Off by default — enabling it compiles
    the recovery branch into `slam_step` (executed only when triggered, via
    `lax.cond`).
    """

    enabled: bool = False
    # Mean per-valid-beam NDT score below which tracking is declared lost.
    # Healthy indoor tracking measures ~0.4-0.7; a teleported/diverged pose
    # scores <0.05.
    fitness_threshold: float = 0.15
    # Acceptance floor for a RELOCALIZED pose's fitness.  Deliberately
    # below fitness_threshold: a correct recovery against a thinly-mapped
    # region legitimately scores under the healthy bar (measured 0.092 at
    # deployment scale for a 5 cm-accurate relocalization vs 0.242 for
    # the same pose at test scale), while garbage "recoveries" measure
    # ≲0.02.  The accept bar also rejects fitness > 1.0: a sane mean
    # per-beam score cannot exceed exp(0) = 1, so anything above it is
    # the reference's indefinite-regularized-inverse pathology
    # (`ndtcell.cpp:93-111` fabricates a positive determinant around an
    # adjugate that can be indefinite, so exp(-q/2) can blow up far from
    # the mean — replicated faithfully in ops/gaussian.py for parity, but
    # it must not win an accept decision).
    accept_fitness: float = 0.05
    # Stage 1: exact-cost scoring of a dense (nx, ny, ntheta) pose grid over
    # +-spread around the last trusted pose — brute-force basin search is one
    # big batched eval, exactly what the chip is good at.  Grid spacing at the
    # defaults: 0.25 m x 0.25 m x 0.39 rad.
    spread: Tuple[float, float, float] = (3.0, 3.0, math.pi)
    grid: Tuple[int, int, int] = (24, 24, 32)
    # Coarse-to-fine: map Gaussians are ~1 cm thin across surfaces (the
    # eigenvalue floor, `ndtcell.cpp:104-108`), far narrower than any grid
    # spacing — stage 1 scores against a Σ+σ²I-inflated snapshot so grid
    # nodes half a spacing away still see the basin; stage 2 refines on a
    # lightly inflated one; a final exact-cost polish solve nails the pose.
    grid_sigma: float = 0.5
    refine_sigma: float = 0.1
    # Stage-1 sweep beam stride: score the coarse grid with every k-th
    # beam.  The sweep's cost is gather-row-bound (grid_poses x beams
    # rows); thinning only affects the σ-inflated basin RANKING — stages
    # 2/3 rescore hypotheses with every beam and the accept decision is
    # always the full exact cost.  Default 0 = AUTO: stride 1 (exhaustive)
    # below RECOVERY_AUTO_STRIDE_MIN_CELLS map cells, stride 2 at
    # deployment scale, to keep the event inside one 10 Hz period; the
    # full-scale recovery bench's in-bench accuracy gate validates the
    # thinned ranking per run.  The crossover is not yet measured on the
    # GPU (ROADMAP D8).  Explicit 1 forces exhaustive everywhere: in
    # beam-sparse worlds a thinned sweep can rank a false basin first
    # (observed on the 6-box test fixture — small maps keep stride 1
    # under auto for exactly that reason).
    grid_beam_stride: int = 0
    # Stage 2: the top-K grid candidates (plus the last pose and the failed
    # align) are refined by a multi-swarm PSO with a sub-grid-spacing radius.
    k_hypotheses: int = 8
    deviation: Tuple[float, float, float] = (0.3, 0.3, 0.3)
    # Stage-2/3 binder window side, in cells (0 = full map table).  The
    # refine/polish swarms bind through the one-hot matmul binder, whose work
    # is O(N·C): fine at relocalization-map sizes, a 553 MB/rebind wall at
    # the deployment default (360k cells).  A relocalization only looks
    # within ``spread`` of the last trusted pose, so the binder reads a
    # patch_cells² dynamic-slice window centred there instead
    # (cost.py:bind_points_matmul_window — bit-identical inside the window,
    # out-of-window points score 0).  Size it to cover
    # 2·(spread_xy + sensor range)/cell_side; the 192-cell default spans
    # 96 m at the 0.5 m deployment cell side (range ≤ ~44 m).  Windows
    # at least as large as the grid fall back to the full table.
    patch_cells: int = 192
    pso: PSOConfig = PSOConfig(iterations=20, population=128)
    exchange_every: int = 5
    # Scans with fewer valid beams than this are treated as sensor dropouts:
    # dead-reckon (constant velocity) and do NOT ingest them into the map.
    min_valid_beams: int = 8


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Full sequential-SLAM configuration: the `scan.launch` analogue."""

    pso: PSOConfig = PSOConfig()
    map: MapConfig = MapConfig()
    scan: ScanConfig = ScanConfig()
    og: OccupancyGridConfig = OccupancyGridConfig(enabled=False)
    recovery: RecoveryConfig = RecoveryConfig()
    first_deviation: Tuple[float, float, float] = FIRST_DEVIATION
    # align() widens the search to twice the last inter-scan motion
    # (ndtframe.cpp:253).
    deviation_scale: float = 2.0
    # 'exact' = reference gather cost; 'fast' = frozen-correspondence
    # matmul cost; 'fast_local' = gather-free stencil rebind; 'local_exact'
    # = per-particle stencil rebind; 'rollout' = 'fast_local' as one
    # whole-solve kernel (ops/pallas_rollout.py).  See
    # models/slam.py:SLAM_COST_MODES.
    cost_mode: str = "exact"
    # 'pso' = the reference's deployed optimizer (`pso_optimization`,
    # core.cpp:50-116); 'glir' = the GLIR-PSO alternative the reference
    # carries as API surface (`core.h:21-23`, untested upstream —
    # models/pso.py:glir_pso_solve documents the divergences).  GLIR runs
    # through the XLA cost modes only (the rollout kernel implements the
    # deployed PSO update rule).
    optimizer: str = "pso"
    # Rollout cost mode only: stop a solve once its global best has
    # stalled this many consecutive iterations (0 = the reference's fixed
    # budget, `core.cpp:78`).  Deterministic per key; the solve can only
    # return the same or an earlier-stalled best, never a different one.
    solver_early_exit: int = 0
    dtype: object = jnp.float32


def scan_launch_config() -> SlamConfig:
    """The canonical `launch/scan.launch:10-16` configuration."""
    return SlamConfig(
        pso=PSOConfig(iterations=30, population=50),
        map=MapConfig(size_m=300.0, cell_side_m=0.5),
        og=OccupancyGridConfig(cell_size_m=0.1, enabled=True),
    )
