"""Worker process for the multi-host integration test.

Launched (twice) by tests/test_distributed_runtime.py with NDTPSO_* env vars;
runs real gloo collectives across the process boundary: dp-sharded solves
over the hierarchical (hosts, cards) mesh, multi-swarm global-best exchange
crossing hosts, and a psum map merge — then checks every result against a
locally-computed single-process reference (bit-identical expectations, since
all randomness is keyed).
"""

import os
import sys

# 4 virtual CPU devices per process => a 2x4 (hosts, cards) global mesh.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

from ndtpso_slam.parallel import runtime

assert runtime.initialize_distributed(), "env-driven init must engage"

import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ndtpso_slam import config as cfgm
from ndtpso_slam.models import cost as cost_mod, ndt_map
from ndtpso_slam.parallel import distributed, mesh as mesh_mod
from ndtpso_slam.parallel.multi_swarm import multi_swarm_solve

PID = jax.process_index()
NPROC = jax.process_count()
assert NPROC == 2, f"expected 2 processes, got {NPROC}"

MAP_CFG = cfgm.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
PSO_CFG = cfgm.PSOConfig(iterations=8, population=64)

mesh = runtime.make_hier_mesh()
assert mesh.devices.shape == (2, 4), mesh.devices.shape
# Host axis must follow process boundaries: every device in row p belongs to
# process p (that is what keeps card-axis collectives host-local).
for h in range(2):
    assert all(d.process_index == h for d in mesh.devices[h]), "host axis broken"

# --- shared world (same on both processes: same seed)
rs = np.random.RandomState(0)
t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
pts = (
    np.stack([9 * np.cos(t), 6 * np.sin(t)], -1) + rs.normal(0, 0.05, (200, 2))
).astype(np.float32)
state = ndt_map.init_map(MAP_CFG)
for _ in range(2):
    state = ndt_map.add_points(
        state, MAP_CFG, pts + rs.normal(0, 0.02, pts.shape).astype(np.float32),
        np.ones(200, bool),
    )
    state = ndt_map.build(state, MAP_CFG)
snap = ndt_map.snapshot(state, MAP_CFG)

# === 1. dp solves sharded over the whole (hosts, cards) hierarchy =========
B = 16
rs2 = np.random.RandomState(1)
keys = rs2.randint(0, 2**31, (B, 2)).astype(np.uint32)
guesses = np.zeros((B, 3), np.float32)
devs = np.tile(np.float32([0.2, 0.2, 0.05]), (B, 1))
points = np.tile(pts[None], (B, 1, 1))
valid = np.ones((B, 200), bool)
snaps = jax.tree_util.tree_map(
    lambda x: np.tile(np.asarray(x)[None], (B,) + (1,) * x.ndim), snap
)

lo, hi = PID * (B // 2), (PID + 1) * (B // 2)
g_args = runtime.shard_global(
    mesh, P(runtime.SOLVE_AXES),
    (keys[lo:hi], guesses[lo:hi], devs[lo:hi],
     jax.tree_util.tree_map(lambda x: x[lo:hi], snaps),
     points[lo:hi], valid[lo:hi]),
)
solver = runtime.make_hier_solver(mesh, MAP_CFG, PSO_CFG, cost_mode="fast")
res = solver(*g_args)

# Local single-process reference on the full batch (vmap) — sharding must
# not change the math (keyed randomness, deterministic reductions).
ref = mesh_mod.solve_batch(
    keys, guesses, devs, snaps, points, valid, MAP_CFG, PSO_CFG, "fast"
)
local_rows = np.concatenate(
    [np.asarray(s.data) for s in sorted(
        res.pose.addressable_shards, key=lambda s: s.index[0].start or 0)]
)
np.testing.assert_allclose(
    local_rows, np.asarray(ref.pose)[lo:hi], rtol=0, atol=1e-6,
    err_msg="hier-sharded dp solves diverged from the local reference",
)
print(f"[p{PID}] dp solves over 2x4 mesh match local reference", flush=True)

# === 2. multi-swarm with the gbest exchange crossing hosts ==================
K = 8  # one swarm per device
sw_keys = rs2.randint(0, 2**31, (K, 2)).astype(np.uint32)
sw_guess = rs2.uniform(-0.3, 0.3, (K, 3)).astype(np.float32)

cost_fn = lambda poses, bind: cost_mod.bound_cost(
    poses, cost_mod.bind_points(bind, snap, pts, np.ones(200, bool), MAP_CFG)
)


def ms_step(k, g):
    # swarm axis sharded over BOTH mesh axes, one swarm per device; full
    # merges every 2 iterations so the result is comparable to the local
    # full-K run with the same cadence.
    r = multi_swarm_solve(
        k, g, jnp.float32([0.2, 0.2, 0.05]), cost_fn, PSO_CFG,
        exchange_every=2, axis_name=runtime.CARD_AXIS,
        host_axis_name=runtime.HOST_AXIS, host_exchange_every=2,
    )
    return r.pose, r.cost  # plain tuple to match out_specs


shmapped = jax.jit(
    jax.shard_map(
        ms_step, mesh=mesh,
        in_specs=(P(runtime.SOLVE_AXES), P(runtime.SOLVE_AXES)),
        out_specs=(P(), P()),
        check_vma=False,
    )
)
lo_k, hi_k = PID * (K // 2), (PID + 1) * (K // 2)
gk, gg = runtime.shard_global(
    mesh, P(runtime.SOLVE_AXES), (sw_keys[lo_k:hi_k], sw_guess[lo_k:hi_k])
)
ms = shmapped(gk, gg)
ms_pose = np.asarray(ms[0].addressable_shards[0].data)
ms_cost = float(np.asarray(ms[1].addressable_shards[0].data))

ref_ms = multi_swarm_solve(
    sw_keys, sw_guess, jnp.float32([0.2, 0.2, 0.05]), cost_fn, PSO_CFG,
    exchange_every=2,
)
np.testing.assert_allclose(
    ms_pose, np.asarray(ref_ms.pose), rtol=0, atol=1e-5,
    err_msg="cross-host multi-swarm diverged from the local full-K reference",
)
np.testing.assert_allclose(ms_cost, float(np.asarray(ref_ms.cost)), atol=1e-5)
print(f"[p{PID}] multi-swarm gbest exchange crossed hosts correctly", flush=True)

# === 3. psum map merge across the process boundary ========================
# Each DEVICE ingests a different shard of a new scan into the replicated
# map; the merged result must equal serial ingestion of all points.
n_new = 160
new_pts = (
    np.stack([7 * np.cos(t[:n_new]), 5 * np.sin(t[:n_new])], -1)
    + rs.normal(0, 0.03, (n_new, 2))
).astype(np.float32)
new_valid = np.ones(n_new, bool)


def ingest(map_state, p_shard, v_shard):
    merged = distributed.sharded_update(
        map_state, MAP_CFG, jnp.zeros(3, jnp.float32), p_shard, v_shard,
        runtime.SOLVE_AXES,
    )
    return ndt_map.build(merged, MAP_CFG)


ing = jax.jit(
    jax.shard_map(
        ingest, mesh=mesh,
        in_specs=(P(), P(runtime.SOLVE_AXES), P(runtime.SOLVE_AXES)),
        out_specs=P(),
        check_vma=False,
    )
)
per_proc = n_new // 2
gp, gv = runtime.shard_global(
    mesh, P(runtime.SOLVE_AXES),
    (new_pts[PID * per_proc:(PID + 1) * per_proc],
     new_valid[PID * per_proc:(PID + 1) * per_proc]),
)
g_state = runtime.replicate_global(mesh, state)
merged = ing(g_state, gp, gv)

ref_state = ndt_map.add_points(state, MAP_CFG, new_pts, new_valid)
ref_state = ndt_map.build(ref_state, MAP_CFG)
got_count = np.asarray(merged.g_count.addressable_shards[0].data)
np.testing.assert_array_equal(got_count, np.asarray(ref_state.g_count))
got_sum = np.asarray(merged.g_sum.addressable_shards[0].data)
np.testing.assert_allclose(got_sum, np.asarray(ref_state.g_sum), atol=1e-5)
print(f"[p{PID}] psum map merge across processes equals serial ingestion",
      flush=True)

print(f"[p{PID}] WORKER OK", flush=True)
