"""Whole-solve PSO scan-match kernel for the GPU (Pallas, Triton route).

One program runs one solve from start to end (reference semantics:
`pso_optimization`, `core.cpp:50-116`, with the synchronous global-best rule
of models/pso.py), so the global-best reduction never crosses programs and
the ``[P, N]`` score field never reaches device memory.  Each iteration:

* builds the ``[16, N]`` quadratic-form coefficient block once, at the
  incumbent global best (models/cost.py:bind_points_local +
  `_quadform_bound`): every point picks its cell from the stencil gathered
  once per solve at the initial guess, by one masked gather per statistic;
* walks the swarm in particle tiles: Threefry draws, velocity and position
  update, then the score of the tile against every point tile
  (``z = w·phi`` as 15 unrolled float32 FMAs, ``exp``, sum over points),
  then the pbest update and the tile's share of the global-best reduction.

Swarm state (pos, vel, pbest, pbest cost) and the coefficient block live in
per-solve scratch outputs in global memory, which stay in L2 at these sizes;
``debug_barrier`` orders one phase's writes before the next phase's reads
inside the program.

What the kernel reproduces exactly from its XLA counterpart (`fast_local`
under models/pso.py:pso_solve): the Threefry-2x32 draw protocol of
ops/rng.py (counter = 3 + 3P + i*3P + 3j + k), the stencil selection, the
first-argmin global-best tie-break.  Sums are taken in another order, so
costs agree to float32 rounding, not bitwise.

Any population and any beam count run: particles and points are tiled with
masked tails (padded particles are pinned to cost BIG, padded points get a
zero score through the BIG constant coefficient).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ndtpso_slam.config import MapConfig, PSOConfig, ZERO_DEVIATION

_U32 = jnp.uint32
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_U01 = float(np.float32(1.0 / (1 << 24)))
# Index pairs (a<=b) of the 15 monomials u_a u_b, as in models/cost.py.
_IJ = [(a, b) for a in range(5) for b in range(a, 5)]
_BIG = 1e9  # masked-point coefficient / padded-particle cost

# Tiling and launch parameters at full population, chosen by a sweep on an
# H100 (PERF.md).  Smaller swarms get a particle tile of their own size
# rounded up to a power of two, and proportionally fewer warps.
TILE_P = 1024
TILE_N = 16
NUM_WARPS = 16
NUM_STAGES = 1


def _tiling(population: int, n_points: int):
    """(tile_p, p_tiles, tile_n, n_tiles, num_warps) for one launch."""
    tile_p = min(TILE_P, pl.next_power_of_2(population))
    num_warps = max(4, NUM_WARPS * tile_p // TILE_P)
    return (tile_p, -(-population // tile_p), TILE_N, -(-n_points // TILE_N),
            num_warps)


def interpret_mode() -> bool:
    """The one place that picks how Pallas kernels run: compiled through
    Triton on a GPU, in the Pallas interpreter on the CPU (the test
    platform).  Any other backend has no kernel route."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise NotImplementedError(f"no Pallas kernel route for backend {backend!r}")


def _rotl(x, r):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def _threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, on uint32 arrays (ops/rng.py protocol)."""
    k2 = k0 ^ k1 ^ _U32(_PARITY)
    ks = (k0, k1, k2)
    x0 = c0 + k0
    x1 = c1 + k1
    for block in range(5):
        rots = _ROT_A if block % 2 == 0 else _ROT_B
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + _U32(block + 1)
    return x0, x1


def _uniform_pairs(k0, k1, ctr):
    """(u_lo, u_hi) in [0,1) f32 for a uint32 counter array."""
    x0, x1 = _threefry2x32(k0, k1, ctr, jnp.zeros_like(ctr))
    # After >>8 the value fits in 24 bits, so the int32 detour is
    # bit-identical to ops/rng.py's direct unsigned cast.
    u0 = (x0 >> _U32(8)).astype(jnp.int32).astype(jnp.float32) * jnp.float32(_U01)
    u1 = (x1 >> _U32(8)).astype(jnp.int32).astype(jnp.float32) * jnp.float32(_U01)
    return u0, u1


def _build_coeffs(pts_ref, sten_ref, w_ref, bind, *, half, cell, radius,
                  n_tiles, tile_n):
    """Write the [16, NP] coefficient block of every point bound at ``bind``
    (three scalars) into ``w_ref``.  Mirrors bind_points_local +
    _quadform_bound; masked points get w = 0 except the constant monomial's
    coefficient, BIG, so their score exp(-BIG/2) is exactly 0."""
    bx, by, bt = bind
    c0 = jnp.cos(bt)
    s0 = jnp.sin(bt)
    side = 2 * radius + 1
    f32 = jnp.float32

    def tile(t, carry):
        sl = pl.ds(t * tile_n, tile_n)
        nidx = t * tile_n + jax.lax.iota(jnp.int32, tile_n)
        px = pts_ref[0, sl]
        py = pts_ref[1, sl]
        ax = pts_ref[2, sl].astype(jnp.int32)
        ay = pts_ref[3, sl].astype(jnp.int32)
        valid = pts_ref[4, sl]
        rx = px * c0 - py * s0
        ry = px * s0 + py * c0
        qx = rx + bx
        qy = ry + by
        inb = (qx > -half) & (qx < half) & (qy > -half) & (qy < half)
        di = jnp.floor((qx + half) / cell).astype(jnp.int32) - ax
        dj = jnp.floor((qy + half) / cell).astype(jnp.int32) - ay
        in_st = (jnp.abs(di) <= radius) & (jnp.abs(dj) <= radius)
        kk = jnp.where(in_st, (dj + radius) * side + (di + radius), 0)
        mx, my, la, lb, lc, built = (
            plgpu.load(sten_ref.at[kk, c, nidx], mask=in_st, other=0.0)
            for c in range(6)
        )
        mask = (built > 0.5) & inb & (valid > 0.5)
        gx = rx + bx - mx
        gy = ry + by - my
        one = jnp.ones_like(gx)
        zero = jnp.zeros_like(gx)
        brx = (rx, -ry, one, zero, gx)  # B-matrix rows, each [tile_n]
        bry = (ry, rx, zero, one, gy)
        lbx = [la * brx[a] + lb * bry[a] for a in range(5)]
        lby = [lb * brx[a] + lc * bry[a] for a in range(5)]
        for f, (a, b) in enumerate(_IJ):
            m_ab = brx[a] * lbx[b] + bry[a] * lby[b]
            w = m_ab if a == b else 2.0 * m_ab
            masked = f32(_BIG) if f == 14 else f32(0.0)
            w_ref[f, sl] = jnp.where(mask, w, masked)
        return carry

    jax.lax.fori_loop(0, n_tiles, tile, 0)


def _score_tile(w_ref, pose, bind, *, n_tiles, tile_n):
    """Cost [tile_p] of one particle tile (pose: three [tile_p] rows) under
    the coefficient block in ``w_ref`` (built at ``bind``)."""
    px, py, pt = pose
    bx, by, bt = bind
    dth = pt - bt
    u = (jnp.cos(dth) - 1.0, jnp.sin(dth), px - bx, py - by, None)
    # u_4 == 1: monomials with b == 4 are u_a itself, (4, 4) is the constant.
    phi = [u[a] if b == 4 else u[a] * u[b] for a, b in _IJ[:14]]

    def tile(t, acc):
        sl = pl.ds(t * tile_n, tile_n)
        z = jnp.broadcast_to(w_ref[14, sl][:, None], (tile_n, px.shape[0]))
        for f in range(14):
            z = z + w_ref[f, sl][:, None] * phi[f][None, :]
        s = jnp.exp(-0.5 * jnp.maximum(z, 0.0))
        return acc + jnp.sum(s, axis=0)

    return -jax.lax.fori_loop(0, n_tiles, tile, jnp.zeros_like(px))


def _tile_min(cost, rows, cols, ppad):
    """First-argmin select within a tile (models/pso.py:_select_min):
    (min cost, the three pose rows at its first index)."""
    m = jnp.min(cost)
    first = jnp.min(jnp.where(cost == m, cols, ppad))
    sel = cols == first
    return m, tuple(jnp.sum(jnp.where(sel, r, 0.0)) for r in rows)


def _merge_min(best, cand):
    """Keep ``best`` unless ``cand`` is strictly lower: tiles are visited in
    particle order, so this keeps the global first argmin."""
    take = cand[0] < best[0]
    return (jnp.where(take, cand[0], best[0]),
            tuple(jnp.where(take, c, b) for c, b in zip(cand[1], best[1])))


def _rollout_kernel(
    keys_ref,  # [2] uint32
    par_ref,  # [8] f32: guess x, y, theta, deviation x, y, theta, 0, 0
    pts_ref,  # [8, NP] f32 rows: px, py, anchor_ix, anchor_iy, valid
    sten_ref,  # [K2, 8, NP] f32 rows: mx, my, la, lb, lc, built
    out_ref,  # [4] f32: x, y, theta, cost
    w_ref,  # [16, NP] f32 scratch: coefficient block
    st_ref,  # [16, PP] f32 scratch: pos 0-2, vel 3-5, pbest 6-8, pbest cost 9
    *,
    cfg: PSOConfig,
    geo: dict,
    n_tiles: int,
    tile_n: int,
    p_tiles: int,
    tile_p: int,
    early_exit: int,
    interpret: bool,
):
    f32 = jnp.float32
    p_real = cfg.population
    ppad = p_tiles * tile_p
    k0 = keys_ref[0]
    k1 = keys_ref[1]
    guess = (par_ref[0], par_ref[1], par_ref[2])
    dev = (par_ref[3], par_ref[4], par_ref[5])
    build = functools.partial(_build_coeffs, pts_ref, sten_ref, w_ref,
                              n_tiles=n_tiles, tile_n=tile_n, **geo)
    score = functools.partial(_score_tile, w_ref, n_tiles=n_tiles,
                              tile_n=tile_n)
    barrier = (lambda: None) if interpret else plgpu.debug_barrier

    def cols_of(j):
        return j * tile_p + jax.lax.iota(jnp.int32, tile_p)

    def finish_tile(j, cols, pos, vel, pbest, pbest_cost, best):
        sl = pl.ds(j * tile_p, tile_p)
        for k in range(3):
            st_ref[k, sl] = pos[k]
            st_ref[3 + k, sl] = vel[k]
            st_ref[6 + k, sl] = pbest[k]
        st_ref[9, sl] = pbest_cost
        return _merge_min(best, _tile_min(pbest_cost, pbest, cols, ppad))

    def masked(cost, cols):
        return jnp.where(cols < p_real, cost, f32(_BIG))

    none_yet = (f32(np.inf), (f32(0.0),) * 3)

    # --- init (core.cpp:53-69 semantics, ops/rng.py counters) ---
    build(guess)
    barrier()
    zd = ZERO_DEVIATION
    g_seed = tuple(
        guess[k] + (2.0 * _uniform_pairs(k0, k1, _U32(k))[0] - 1.0) * f32(zd[k])
        for k in range(3)
    )
    seed_rows = tuple(jnp.full((tile_p,), g, f32) for g in g_seed)
    g_cost = jnp.min(score(seed_rows, guess))

    def init_tile(j, best):
        cols = cols_of(j)
        ctr = _U32(3) + 3 * cols.astype(_U32)
        pos = tuple(
            guess[k] + (2.0 * _uniform_pairs(k0, k1, ctr + _U32(k))[0] - 1.0)
            * dev[k]
            for k in range(3)
        )
        cost = masked(score(pos, guess), cols)
        zeros = tuple(jnp.zeros_like(p) for p in pos)
        return finish_tile(j, cols, pos, zeros, pos, cost, best)

    bc, bp = jax.lax.fori_loop(0, p_tiles, init_tile, none_yet)
    imp = bc < g_cost
    gbest = tuple(jnp.where(imp, b, g) for b, g in zip(bp, g_seed))
    gcost = jnp.where(imp, bc, g_cost)
    barrier()

    c1 = f32(cfg.c1)
    c2 = f32(cfg.c2)
    iter_base = _U32(3 + 3 * p_real)
    iter_stride = _U32(3 * p_real)

    def iteration(carry):
        i, stale, gbest, gcost, w = carry
        build(gbest)
        barrier()

        def swarm_tile(j, best):
            cols = cols_of(j)
            sl = pl.ds(j * tile_p, tile_p)
            ctr = iter_base + i.astype(_U32) * iter_stride + 3 * cols.astype(_U32)
            pos, vel, pbest = [], [], []
            for k in range(3):
                r1, r2 = _uniform_pairs(k0, k1, ctr + _U32(k))
                x = st_ref[k, sl]
                pb = st_ref[6 + k, sl]
                v = (w * st_ref[3 + k, sl] + c1 * r1 * (pb - x)
                     + c2 * r2 * (gbest[k] - x))
                pos.append(x + v)
                vel.append(v)
                pbest.append(pb)
            cost = masked(score(pos, gbest), cols)
            pbest_cost = st_ref[9, sl]
            better = cost < pbest_cost
            pbest = [jnp.where(better, x, pb) for x, pb in zip(pos, pbest)]
            pbest_cost = jnp.where(better, cost, pbest_cost)
            return finish_tile(j, cols, pos, vel, pbest, pbest_cost, best)

        bc, bp = jax.lax.fori_loop(0, p_tiles, swarm_tile, none_yet)
        gimp = bc < gcost
        gbest = tuple(jnp.where(gimp, b, g) for b, g in zip(bp, gbest))
        gcost = jnp.where(gimp, bc, gcost)
        stale = jnp.where(gimp, 0, stale + 1)
        barrier()
        return i + 1, stale, gbest, gcost, w * f32(cfg.w_damping)

    def running(carry):
        i, stale = carry[0], carry[1]
        if early_exit > 0:
            # Converged-swarm early exit: the reference's fixed iteration
            # count (`core.cpp:78`) becomes a cap once the global best has
            # not improved for `early_exit` consecutive iterations.
            return (i < cfg.iterations) & (stale < early_exit)
        return i < cfg.iterations

    _, _, gbest, gcost, _ = jax.lax.while_loop(
        running, iteration, (jnp.int32(0), jnp.int32(0), gbest, gcost, f32(cfg.w))
    )
    lane = jax.lax.iota(jnp.int32, 4)
    out_ref[...] = jnp.where(
        lane == 0, gbest[0],
        jnp.where(lane == 1, gbest[1], jnp.where(lane == 2, gbest[2], gcost)),
    )


def _score_kernel(bind_ref, pts_ref, sten_ref, poses_ref, out_ref, w_ref, *,
                  geo, n_tiles, tile_n, p_tiles, tile_p, interpret):
    """Costs of given poses under one binding: the rollout kernel's
    coefficient build and tile score, without the swarm around them."""
    bind = (bind_ref[0], bind_ref[1], bind_ref[2])
    _build_coeffs(pts_ref, sten_ref, w_ref, bind, n_tiles=n_tiles,
                  tile_n=tile_n, **geo)
    if not interpret:
        plgpu.debug_barrier()

    def tile(j, carry):
        sl = pl.ds(j * tile_p, tile_p)
        pose = tuple(poses_ref[k, sl] for k in range(3))
        out_ref[sl] = _score_tile(w_ref, pose, bind, n_tiles=n_tiles,
                                  tile_n=tile_n)
        return carry

    jax.lax.fori_loop(0, p_tiles, tile, 0)


def pack_rollout_inputs(nbr, points):
    """Repack a NeighborhoodBind + points into the kernel's row layouts.

    nbr fields are [N, K2, ...] (models/cost.py:bind_neighborhood); the kernel
    wants points on the minor axis: stencil [K2, 8, N] and points [8, N].
    Pure transposes, run once per solve in XLA."""
    f32 = jnp.float32
    n = points.shape[0]
    mean = jnp.moveaxis(nbr.mean.astype(f32), 0, -1)  # [K2, 2, N]
    icov = jnp.moveaxis(nbr.icov.astype(f32), 0, -1)  # [K2, 3, N]
    built = jnp.moveaxis(nbr.built.astype(f32), 0, -1)[:, None, :]  # [K2, 1, N]
    k2 = mean.shape[0]
    sten = jnp.concatenate(
        [mean, icov, built, jnp.zeros((k2, 2, n), f32)], axis=1
    )  # [K2, 8, N]
    pts = jnp.concatenate(
        [
            jnp.stack(
                [
                    points[:, 0].astype(f32),
                    points[:, 1].astype(f32),
                    nbr.anchor_ix.astype(f32),
                    nbr.anchor_iy.astype(f32),
                    nbr.valid.astype(f32),
                ],
                axis=0,
            ),
            jnp.zeros((3, n), f32),
        ],
        axis=0,
    )  # [8, N]
    return sten, pts


def _pad_last(x, size):
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, size - x.shape[-1])])


def _geometry(map_cfg: MapConfig, radius: int) -> dict:
    return dict(half=map_cfg.size_m / 2.0, cell=map_cfg.cell_side_m,
                radius=radius)


def _launch(kernel, out_shape, in_specs, out_specs, b, num_warps, interpret,
            name):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(b,),
        in_specs=in_specs,
        out_specs=out_specs,
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=NUM_STAGES
        ),
        name=name,
    )


def _per_solve(*shape):
    """BlockSpec handing each program its own solve's slice."""
    return pl.BlockSpec((None,) + shape, lambda b: (b,) + (0,) * len(shape))


def _rollout_call(keys, guesses, deviations, sten, pts, cfg, map_cfg, radius,
                  early_exit, interpret):
    b, k2, _, n = sten.shape
    assert k2 == (2 * radius + 1) ** 2
    tile_p, p_tiles, tile_n, n_tiles, num_warps = _tiling(cfg.population, n)
    npad, ppad = n_tiles * tile_n, p_tiles * tile_p
    f32 = jnp.float32
    par = jnp.concatenate(
        [guesses.astype(f32), deviations.astype(f32), jnp.zeros((b, 2), f32)],
        axis=1,
    )
    kernel = functools.partial(
        _rollout_kernel, cfg=cfg, geo=_geometry(map_cfg, radius),
        n_tiles=n_tiles, tile_n=tile_n, p_tiles=p_tiles, tile_p=tile_p,
        early_exit=early_exit, interpret=interpret,
    )
    out, _, _ = _launch(
        kernel,
        (
            jax.ShapeDtypeStruct((b, 4), f32),
            jax.ShapeDtypeStruct((b, 16, npad), f32),
            jax.ShapeDtypeStruct((b, 16, ppad), f32),
        ),
        [_per_solve(2), _per_solve(8), _per_solve(8, npad),
         _per_solve(k2, 8, npad)],
        (_per_solve(4), _per_solve(16, npad), _per_solve(16, ppad)),
        b, num_warps, interpret, "pso_rollout",
    )(keys.astype(jnp.uint32), par, _pad_last(pts, npad), _pad_last(sten, npad))
    return out[:, 0:3], out[:, 3]


@functools.partial(
    jax.jit, static_argnames=("cfg", "map_cfg", "radius", "early_exit")
)
def pso_rollout(
    keys: jnp.ndarray,  # [B, 2] uint32
    guesses: jnp.ndarray,  # [B, 3] f32
    deviations: jnp.ndarray,  # [B, 3] f32
    sten: jnp.ndarray,  # [B, K2, 8, N] f32 (pack_rollout_inputs)
    pts: jnp.ndarray,  # [B, 8, N] f32
    cfg: PSOConfig,
    map_cfg: MapConfig,
    radius: int = 2,
    early_exit: int = 0,
):
    """B independent whole-solve PSO rollouts.  Returns (pose [B,3], cost [B]).

    ``early_exit=K`` (0 = off) stops a solve once its global best has not
    improved for K consecutive iterations — `cfg.iterations` becomes a cap
    (the reference's fixed budget, `core.cpp:78`, is the K=0 behavior).
    Deterministic per key; not a parity mode."""
    return _rollout_call(keys, guesses, deviations, sten, pts, cfg, map_cfg,
                         radius, early_exit, interpret_mode())


def _scores_call(poses, binds, sten, pts, map_cfg, radius, interpret):
    b, k2, _, n = sten.shape
    p = poses.shape[1]
    tile_p, p_tiles, tile_n, n_tiles, num_warps = _tiling(p, n)
    npad, ppad = n_tiles * tile_n, p_tiles * tile_p
    f32 = jnp.float32
    kernel = functools.partial(
        _score_kernel, geo=_geometry(map_cfg, radius), n_tiles=n_tiles,
        tile_n=tile_n, p_tiles=p_tiles, tile_p=tile_p, interpret=interpret,
    )
    rows = _pad_last(
        jnp.concatenate([jnp.swapaxes(poses.astype(f32), 1, 2),
                         jnp.zeros((b, 1, p), f32)], axis=1),
        ppad,
    )  # [B, 4, PP]
    bind4 = jnp.concatenate([binds.astype(f32), jnp.zeros((b, 1), f32)], 1)
    out, _ = _launch(
        kernel,
        (jax.ShapeDtypeStruct((b, ppad), f32),
         jax.ShapeDtypeStruct((b, 16, npad), f32)),
        [_per_solve(4), _per_solve(8, npad), _per_solve(k2, 8, npad),
         _per_solve(4, ppad)],
        (_per_solve(ppad), _per_solve(16, npad)),
        b, num_warps, interpret, "rollout_scores",
    )(bind4, _pad_last(pts, npad), _pad_last(sten, npad), rows)
    return out[:, :p]


@functools.partial(jax.jit, static_argnames=("map_cfg", "radius"))
def rollout_scores(
    poses: jnp.ndarray,  # [B, P, 3] f32
    binds: jnp.ndarray,  # [B, 3] f32
    sten: jnp.ndarray,  # [B, K2, 8, N] f32 (pack_rollout_inputs)
    pts: jnp.ndarray,  # [B, 8, N] f32
    map_cfg: MapConfig,
    radius: int = 2,
):
    """Costs [B, P] of given poses, each solve's points bound at its
    ``binds`` row, through the rollout kernel's own coefficient build and
    scoring: the kernel's half of
    ``bound_cost(poses, bind_points_local(bind, ...))``."""
    return _scores_call(poses, binds, sten, pts, map_cfg, radius,
                        interpret_mode())
