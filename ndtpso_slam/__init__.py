"""ndtpso_slam: NDT scan-matching / pose-trajectory optimization in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`abougouffa/ndtpso_slam` (see SURVEY.md): NDT grid maps as dense batched
arrays, PSO scan-matching as vmapped swarms with matmul-formulated scoring, and
multi-chip scaling through `jax.sharding` meshes.
"""

from ndtpso_slam.config import (
    MapConfig,
    OccupancyGridConfig,
    PSOConfig,
    RecoveryConfig,
    ScanConfig,
    SlamConfig,
    scan_launch_config,
)
from ndtpso_slam.models.cost import bind_points, bound_cost, ndt_cost
from ndtpso_slam.models.ndt_map import (
    MapSnapshot,
    NdtMapState,
    add_points,
    build,
    init_map,
    snapshot,
    update,
)
from ndtpso_slam.models.pso import PsoResult, glir_pso_solve, pso_solve
from ndtpso_slam.models.scan import Scan, load_laser
from ndtpso_slam.models.slam import (
    SlamState,
    align,
    init_slam,
    init_slam_batch,
    run_offline,
    run_offline_batch,
    slam_step,
)

__version__ = "0.1.0"
