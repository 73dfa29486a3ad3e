"""Streaming multi-session scheduler: K live SLAM sessions on one chip.

The reference scales to multiple sensors by launching one OS process per
LiDAR with remapped topics, each consuming its own `sensor_msgs/LaserScan`
stream at its own rate (`launch/lidar_front.launch:2,11-14`,
`launch/lidar_back.launch`) — asynchronous deployment data-parallelism.

`run_offline_batch` (models/slam.py) already batches B *recorded* logs, but
it is lockstep: every robot must advance every step.  This module is the
true streaming analogue: a :class:`SlamSessionPool` holds B independent
session states stacked on a device-resident batch axis and dispatches ONE
vmapped, masked `slam_step` per `poll()` — sessions with a queued scan
advance, idle sessions pass through bit-identically (their new state is
discarded by a per-session `where`).  Arrival patterns can be arbitrary
(two LiDARs at different rates, dropouts, a robot joining late): the chip
always executes the same static-shape program, so there is exactly one
compile, and per-session results are independent of the other sessions'
clocks.

Per-session PRNG keys derive from the session's own step counter inside the
jitted step (`threefry(base_key, step)`), exactly the stream `run_offline`
uses — so a pooled session replays a solo `run_offline` of the same log
bit-for-bit on a given backend (asserted by
tests/test_sessions.py::test_interleaved_sessions_match_solo_runs on the
test backend; no state is shared between sessions by construction).
"""

from __future__ import annotations

from collections import deque
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ndtpso_slam.config import SlamConfig
from ndtpso_slam.models import slam as slam_mod
from ndtpso_slam.models.scan import Scan
from ndtpso_slam.ops import rng


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def pool_step(
    states: slam_mod.SlamState,  # stacked [B] leading axis
    scans: Scan,  # [B, N, ...]
    base_keys: jnp.ndarray,  # [B, 2] uint32
    active: jnp.ndarray,  # [B] bool
    cfg: SlamConfig,
):
    """One masked, vmapped SLAM step over the whole pool.

    Inactive sessions compute a throwaway step on a dummy scan and keep
    their prior state bitwise (scalar-condition `where` over every leaf).
    Returns (new_states, poses [B, 3], costs [B]).

    ``states`` is DONATED: the pool replaces its handle with the returned
    state every poll, and donation lets XLA update the multi-GiB ring
    buffers in place across calls — without it, a batched fleet at
    deployment scale pays a full ring copy per step (the vmap
    carry-aliasing wall; the pooled per-step dispatch with donation is the
    fast path for big fleets).
    """

    def one(state, scan, bk, act):
        key = rng.threefry2x32(
            (bk[0], bk[1]), state.step.astype(jnp.uint32),
            jnp.asarray(0, jnp.uint32),
        )
        new_state, pose, cost = slam_mod.slam_step(state, scan, key, cfg)
        merged = jax.tree_util.tree_map(
            lambda n, o: jnp.where(act, n, o), new_state, state
        )
        return merged, jnp.where(act, pose, state.pose), jnp.where(act, cost, 0)

    return jax.vmap(one)(states, scans, jnp.asarray(base_keys, jnp.uint32), active)


class SlamSessionPool:
    """B live SLAM sessions multiplexed onto one chip, one program.

    Args:
      cfg: shared session config (one compile covers the pool; per-sensor
        configs that differ in *values* but not shapes — e.g. mount
        transforms — are applied at scan load time, as the reference's node
        does, `ndtframe.cpp:174-177`).
      initial_poses: [B, 3] array-like, one start pose per session.
      base_keys: [B, 2] uint32, one PRNG stream per session (a solo
        `run_offline` with the same key replays the session exactly).
    """

    def __init__(self, cfg: SlamConfig, initial_poses, base_keys):
        self.cfg = cfg
        poses = np.asarray(initial_poses, np.float32)
        self.n_sessions = poses.shape[0]
        keys = np.asarray(base_keys, np.uint32)
        assert keys.shape == (self.n_sessions, 2)
        self.base_keys = jnp.asarray(keys)
        # Flat-fleet fast path (parallel/fleet.py): eligible configs route
        # the pooled step through unbatched flat scatters, which donation
        # really does update in place — the vmapped step's batched
        # scatters copy the whole map state per poll at deployment scale.
        # Rollout modes run as one B=robots kernel call in the flat step;
        # recovery runs flat with in-step quarantine + host-escalated
        # relocalization of flagged robots (fleet.relocalize_fleet_robot).
        # Only OG pools keep the vmapped step (the flat step does not
        # raster occupancy grids).
        self._use_flat = not cfg.og.enabled
        # Eager per-leaf copies: the jitted init can alias identical
        # all-zero leaves to ONE buffer, which pool_step's donation then
        # rejects ("attempt to donate the same buffer twice").  Unique
        # buffers here stay unique forever (each poll's outputs reuse the
        # donated inputs 1:1).
        self.states = jax.tree_util.tree_map(
            jnp.copy, slam_mod.init_slam_batch(cfg, poses)
        )
        self._queues: List[deque] = [deque() for _ in range(self.n_sessions)]
        self._dummy = np.zeros((cfg.scan.max_beams, 2), np.float32)
        self._dummy_valid = np.zeros((cfg.scan.max_beams,), bool)
        self.steps = np.zeros(self.n_sessions, np.int64)  # host-side clocks

    def submit(self, session: int, scan: Scan) -> None:
        """Queue a loaded scan (models/scan.py:load_laser) for a session."""
        self._queues[session].append(scan)

    def pending(self) -> int:
        return sum(len(q) for q in self._queues)

    def poll(self) -> Dict[int, Tuple[np.ndarray, float]]:
        """Dispatch one batched step; advance every session with a queued
        scan.  Returns {session: (pose [3], cost)} for the sessions that
        advanced (empty dict if nothing was pending)."""
        active = np.array([len(q) > 0 for q in self._queues])
        if not active.any():
            return {}
        pts, vld = [], []
        for sid, q in enumerate(self._queues):
            if q:
                s = q.popleft()
                pts.append(np.asarray(s.points))
                vld.append(np.asarray(s.valid))
            else:
                pts.append(self._dummy)
                vld.append(self._dummy_valid)
        scans = Scan(
            points=jnp.asarray(np.stack(pts)), valid=jnp.asarray(np.stack(vld))
        )
        if self._use_flat:
            from ndtpso_slam.parallel.fleet import fleet_pool_step

            self.states, poses, costs, lost = fleet_pool_step(
                self.states, scans, self.base_keys, jnp.asarray(active),
                self.cfg,
            )
        else:
            self.states, poses, costs = pool_step(
                self.states, scans, self.base_keys, jnp.asarray(active),
                self.cfg,
            )
            lost = None
        out: Dict[int, Tuple[np.ndarray, float]] = {}
        poses_h = np.array(poses)  # writable copy: escalation rewrites rows
        costs_h = np.array(costs)
        if lost is not None and self.cfg.recovery.enabled:
            # Host-side escalation: the flat step only FLAGS lost robots
            # (quarantining their scans); each one relocalizes here through
            # the solo 3-stage sweep on its own state slice — the other
            # robots' rows stay untouched bitwise
            # (fleet.relocalize_fleet_robot).
            from ndtpso_slam.parallel.fleet import relocalize_fleet_robot

            for sid in np.nonzero(np.asarray(lost))[0]:
                # Same per-step key the step's solves drew from (the solo
                # recovery branch reuses the step key too).
                key = jnp.stack(
                    rng.threefry2x32(
                        (self.base_keys[sid, 0], self.base_keys[sid, 1]),
                        jnp.asarray(self.steps[sid], jnp.uint32),
                        jnp.asarray(0, jnp.uint32),
                    )
                )
                scan_i = Scan(points=scans.points[sid], valid=scans.valid[sid])
                self.states, pose_i, cost_i, _acc = relocalize_fleet_robot(
                    self.states, jnp.asarray(sid, jnp.int32), scan_i, key,
                    self.cfg,
                )
                poses_h[sid] = np.asarray(pose_i)
                costs_h[sid] = float(cost_i)
        for sid in np.nonzero(active)[0]:
            self.steps[sid] += 1
            out[int(sid)] = (poses_h[sid], float(costs_h[sid]))
        return out

    def drain(self) -> Dict[int, List[Tuple[np.ndarray, float]]]:
        """Poll until every queue is empty; per-session ordered results."""
        hist: Dict[int, List[Tuple[np.ndarray, float]]] = {
            i: [] for i in range(self.n_sessions)
        }
        while self.pending():
            for sid, res in self.poll().items():
                hist[sid].append(res)
        return hist

    def session_state(self, session: int) -> slam_mod.SlamState:
        """Slice one session's state out of the stacked pool (for export /
        checkpoint via utils.checkpoint, utils.export)."""
        return jax.tree_util.tree_map(lambda x: x[session], self.states)
