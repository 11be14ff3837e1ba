"""Explicit z-sharded simulation substep — one ``shard_map`` over the mesh.

GSPMD propagation through the dense substep (annotate inputs, let the
partitioner figure it out) reshards the dp-sharded particles against the
z-sharded grid at every scatter/gather/sort. This module avoids that: the
whole substep runs *inside* ``jax.shard_map``, every stage is local-per-tile
by construction, and the only communication is what the physics needs:

- particle exchange after advection: fixed-capacity ±1 ``ppermute`` ring
  (CFL-bounded motion < one slab, ``simulation.cpp:31-41``),
- one ghost slot-layer exchange feeding P2G / position correction
  (replacing the reference's shared-memory neighborhood reads,
  ``simulation.h:212-223``),
- width-1 halo exchanges inside the pressure MG-PCG (the shardable
  replacement for the reference's serial MIC(0), ``pressure_solver.cpp:
  244-332``) with ``psum`` dot products,
- one ghost face-layer exchange feeding G2P trilerp.

Grid layout: z is the sharded axis (minor dim — halo layers are contiguous).
Each device owns cells z in [d*nzl, (d+1)*nzl) and particle rows
[d*Nl, (d+1)*Nl); particles live on the device owning their cell.

The local math is the SAME code as the dense path (binning/slots/transfers/
correction modules called on a local cfg with z-shifted positions), so
sharded-vs-dense equivalence holds to reduction order and is tested
(``tests/test_zshard.py``).

Scaling envelope (design note): the 1D z decomposition is sized for
single-host meshes (<= ~16 devices). Useful parallelism caps at
nz / (ceil(cfl_number)+1) slabs — a 256^3 grid on 64 devices would leave
4-cell slabs where the width-1 halos touch half the cells and a CFL-bounded
substep can cross a whole slab. Scaling past that calls for a 2D/3D tile
decomposition of the same structure (exchange rings per axis); the stage
semantics here carry over unchanged, only ghost bookkeeping widens.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libfluid_tpu import grids
from libfluid_tpu.config import CellType, SimConfig, TransferScheme
from libfluid_tpu.sim import binning as binning_mod
from libfluid_tpu.sim import collisions as collisions_mod
from libfluid_tpu.sim import correction as correction_mod
from libfluid_tpu.sim import jitterhash
from libfluid_tpu.sim import multigrid
from libfluid_tpu.sim import pressure as pressure_mod
from libfluid_tpu.sim import slots as slots_mod
from libfluid_tpu.sim import sources as sources_mod
from libfluid_tpu.sim import transfers
from libfluid_tpu.sim.state import SimState
from libfluid_tpu.sim.step import Diagnostics

AXIS = "dp"


# ---------------------------------------------------------------------------
# Halo exchange primitives (z minor axis)
# ---------------------------------------------------------------------------


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_rev(n):
    return [(i, (i - 1) % n) for i in range(n)]


def ghosts_z(x: jnp.ndarray, fill=0.0, width: int = 1):
    """(ghost_lo, ghost_hi) layers of a local (..., nzl) tile from the z
    neighbors; domain ends read `fill`. Each ghost is (..., width)."""
    n = lax.psum(1, AXIS)
    i = lax.axis_index(AXIS)
    from_below = lax.ppermute(x[..., -width:], AXIS, _ring(n))
    from_above = lax.ppermute(x[..., :width], AXIS, _ring_rev(n))
    lo = jnp.where(i == 0, jnp.full_like(from_below, fill), from_below)
    hi = jnp.where(i == n - 1, jnp.full_like(from_above, fill), from_above)
    return lo, hi


def pad_z(x: jnp.ndarray, fill=0.0, width: int = 1) -> jnp.ndarray:
    """Local tile extended with `width` ghost layers on each z side."""
    lo, hi = ghosts_z(x, fill, width)
    return jnp.concatenate([lo, x, hi], axis=-1)


# ---------------------------------------------------------------------------
# Sharded multigrid-preconditioned CG (pressure)
# ---------------------------------------------------------------------------

# Levels with global z below this run replicated (one all_gather, then the
# dense multigrid code verbatim) — the coarse 24-iteration smoother would
# otherwise cost 24 halo exchanges per V-cycle for trivial compute.
_REPLICATE_Z = 16


class ZLevel(NamedTuple):
    """One z-sharded multigrid level (local tiles; cf. multigrid.MGLevel)."""

    fluid: jnp.ndarray  # (nx, ny, nzl)
    diag: jnp.ndarray
    inv_diag: jnp.ndarray
    couple_u: jnp.ndarray  # (nx+1, ny, nzl)
    couple_v: jnp.ndarray  # (nx, ny+1, nzl)
    couple_w_lo: jnp.ndarray  # (nx, ny, nzl): cell couples to its -z neighbor
    couple_w_hi: jnp.ndarray  # (nx, ny, nzl): cell couples to its +z neighbor
    scale: float


def _zlevel_from_types(ct_local: jnp.ndarray, scale: float, dtype) -> ZLevel:
    """Build a level's masks from local cell types + one ghost type layer.

    Same discretization as ``multigrid._operator_from_types``: diag counts
    non-solid 6-neighbors (out-of-domain = solid), couplings join fluid
    pairs."""
    cte = pad_z(ct_local, fill=CellType.SOLID)  # (nx, ny, nzl+2)
    solid = cte == CellType.SOLID
    fluid_b = cte == CellType.FLUID
    sp = jnp.pad(solid, ((1, 1), (1, 1), (0, 0)), constant_values=True)
    nonsolid = (
        (~sp[:-2, 1:-1, 1:-1]).astype(dtype)
        + (~sp[2:, 1:-1, 1:-1]).astype(dtype)
        + (~sp[1:-1, :-2, 1:-1]).astype(dtype)
        + (~sp[1:-1, 2:, 1:-1]).astype(dtype)
        + (~solid[:, :, :-2]).astype(dtype)
        + (~solid[:, :, 2:]).astype(dtype)
    )
    fp = jnp.pad(fluid_b, ((1, 1), (1, 1), (0, 0)), constant_values=False)
    cu = (fp[:-1, 1:-1, 1:-1] & fp[1:, 1:-1, 1:-1]).astype(dtype)
    cv = (fp[1:-1, :-1, 1:-1] & fp[1:-1, 1:, 1:-1]).astype(dtype)
    f_in = fluid_b[:, :, 1:-1]
    cw_lo = (f_in & fluid_b[:, :, :-2]).astype(dtype)
    cw_hi = (f_in & fluid_b[:, :, 2:]).astype(dtype)
    fluid = f_in.astype(dtype)
    diag = nonsolid * fluid
    inv_diag = jnp.where(diag > 0, 1.0 / jnp.maximum(diag * scale, 1e-30), 0.0)
    return ZLevel(fluid, diag, inv_diag, cu, cv, cw_lo, cw_hi, scale)


def _apply_zlevel(level: ZLevel, p: jnp.ndarray) -> jnp.ndarray:
    """A_l p on a local tile — one halo exchange for the z-neighbor terms."""
    p = p * level.fluid
    ph = pad_z(p)
    nbr = (
        level.couple_u[:-1] * jnp.pad(p, ((1, 0), (0, 0), (0, 0)))[:-1]
        + level.couple_u[1:] * jnp.pad(p, ((0, 1), (0, 0), (0, 0)))[1:]
        + level.couple_v[:, :-1] * jnp.pad(p, ((0, 0), (1, 0), (0, 0)))[:, :-1]
        + level.couple_v[:, 1:] * jnp.pad(p, ((0, 0), (0, 1), (0, 0)))[:, 1:]
        + level.couple_w_lo * ph[:, :, :-2]
        + level.couple_w_hi * ph[:, :, 2:]
    )
    return level.scale * (level.diag * p - nbr) * level.fluid


def _smooth_z(level: ZLevel, x, b, iters: int):
    for _ in range(iters):
        r = b - _apply_zlevel(level, x)
        x = x + multigrid._SMOOTH_DAMP * level.inv_diag * r
    return x * level.fluid


def _restrict_z(level_c: ZLevel, r: jnp.ndarray) -> jnp.ndarray:
    """Local 2x restriction (z tile sizes stay even until the replicated
    transition, so the blocks never straddle a tile boundary)."""
    nx, ny, nz = r.shape
    px, py = nx % 2, ny % 2
    if px or py:
        r = jnp.pad(r, ((0, px), (0, py), (0, 0)))
    c = r.reshape(r.shape[0] // 2, 2, r.shape[1] // 2, 2, nz // 2, 2)
    return c.sum(axis=(1, 3, 5)) * 0.125 * level_c.fluid


def _prolong_z(e_c: jnp.ndarray, fine_shape) -> jnp.ndarray:
    e = jnp.repeat(jnp.repeat(jnp.repeat(e_c, 2, 0), 2, 1), 2, 2)
    return e[: fine_shape[0], : fine_shape[1], :]


class ZLevels(NamedTuple):
    """The full preconditioner: sharded fine levels + replicated coarse tail.

    ``dense`` levels (plain :class:`multigrid.MGLevel`, replicated compute on
    every device) take over once the global z size drops below
    ``_REPLICATE_Z`` — one all_gather moves the residual across."""

    sharded: Tuple[ZLevel, ...]
    dense: Tuple[multigrid.MGLevel, ...]


def build_zlevels(ct_local: jnp.ndarray, nz_global: int, dtype) -> ZLevels:
    """Mirror of ``multigrid.build_levels``: same stopping rule, same
    coarsening, split into sharded/replicated by global z extent."""
    n_dev = nz_global // ct_local.shape[2]
    sharded = []
    dense = []
    ct = ct_local
    scale = 1.0
    nlev = 0
    gathered = False
    while True:
        gx, gy = ct.shape[0], ct.shape[1]
        gz = ct.shape[2] * (1 if gathered else n_dev)
        if not gathered and (gz < _REPLICATE_Z or ct.shape[2] % 2 != 0):
            ct = lax.all_gather(ct, AXIS, axis=2, tiled=True)
            gathered = True
            gz = ct.shape[2]
        if gathered:
            dense.append(multigrid._operator_from_types(ct, scale, dtype))
        else:
            sharded.append(_zlevel_from_types(ct, scale, dtype))
        nlev += 1
        if min(gx, gy, gz) <= multigrid._MIN_SIZE or nlev >= 6:
            break
        ct = multigrid._coarsen_types(ct)
        scale *= 0.25
    return ZLevels(tuple(sharded), tuple(dense))


def _v_cycle_z(levels: ZLevels, b: jnp.ndarray, l: int = 0) -> jnp.ndarray:
    ns = len(levels.sharded)
    if l >= ns:
        # replicated tail: gather the (local) rhs once, run the dense
        # V-cycle identically on every device, slice the local part back
        i = lax.axis_index(AXIS)
        bg = lax.all_gather(b, AXIS, axis=2, tiled=True)
        eg = multigrid.v_cycle(levels.dense, bg, l - ns)
        nzl = b.shape[2]
        return lax.dynamic_slice_in_dim(eg, i * nzl, nzl, 2)
    level = levels.sharded[l]
    last = (l == ns - 1) and not levels.dense
    if last:
        return _smooth_z(level, jnp.zeros_like(b), b, multigrid._COARSE_ITERS)
    x = _smooth_z(level, jnp.zeros_like(b), b, multigrid._PRE_SMOOTH)
    r = (b - _apply_zlevel(level, x)) * level.fluid
    if l + 1 < ns:
        rc = _restrict_z(levels.sharded[l + 1], r)
    else:
        # next level is replicated: restrict without the coarse mask (the
        # dense V-cycle is invariant to rhs values outside fluid — inv_diag
        # is zero there, so the correction never leaves the fluid set)
        nxf, nyf, nzf = r.shape
        px, py = nxf % 2, nyf % 2
        rr = jnp.pad(r, ((0, px), (0, py), (0, 0))) if (px or py) else r
        c = rr.reshape(rr.shape[0] // 2, 2, rr.shape[1] // 2, 2, nzf // 2, 2)
        rc = c.sum(axis=(1, 3, 5)) * 0.125
    ec = _v_cycle_z(levels, rc, l + 1)
    x = x + _prolong_z(ec, b.shape) * level.fluid
    x = _smooth_z(level, x, b, multigrid._POST_SMOOTH)
    return x


def _zdot(a, b):
    return lax.psum(jnp.sum(a * b), AXIS)


def _cg_z(levels: ZLevels, b: jnp.ndarray, a_scale, tol, max_iters, precond, x0=None):
    """Sharded mirror of ``pressure._cg``: psum dots, pmax residual."""
    lvl0 = levels.sharded[0] if levels.sharded else None

    if lvl0 is None:
        # degenerate: whole grid replicated (tiny z) — fall back to dense CG
        bg = lax.all_gather(b, AXIS, axis=2, tiled=True)
        x0g = None if x0 is None else lax.all_gather(x0, AXIS, axis=2, tiled=True)
        res = pressure_mod._cg(levels.dense, bg, a_scale, tol, max_iters, precond,
                               x0=x0g)
        i = lax.axis_index(AXIS)
        nzl = b.shape[2]
        return res._replace(
            pressure=lax.dynamic_slice_in_dim(res.pressure, i * nzl, nzl, 2)
        )

    if precond == "mg16":
        # bf16 preconditioner hierarchy (mirror of pressure._cg's mg16)
        def _cast(lev):
            return type(lev)(
                *[f.astype(jnp.bfloat16) for f in lev[:-1]], lev.scale
            )

        levels16 = ZLevels(
            sharded=tuple(_cast(l) for l in levels.sharded),
            dense=tuple(_cast(l) for l in levels.dense),
        )

    def apply_M(r):
        if precond == "mg16":
            return (
                _v_cycle_z(levels16, r.astype(jnp.bfloat16)).astype(r.dtype)
                / a_scale
            )
        if precond == "mg":
            return _v_cycle_z(levels, r) / a_scale
        return lvl0.inv_diag / a_scale * r

    def apply_A1(p):
        return _apply_zlevel(lvl0, p) * a_scale

    b2 = _zdot(b, b)
    nontrivial = b2 >= 1e-6
    if x0 is None:
        p0 = jnp.zeros_like(b)
        r0 = b
    else:
        # gated on `nontrivial` — the early-out must return the cold start's
        # zero pressure, not the stale x0 (mirrors pressure._cg).
        p0 = jnp.where(nontrivial, x0 * lvl0.fluid, 0.0)
        r0 = b - apply_A1(p0)
    z0 = apply_M(r0)
    sigma0 = _zdot(z0, r0)
    res0 = lax.pmax(jnp.max(jnp.abs(r0)), AXIS)

    def cond(carry):
        _, _, _, _, res, it = carry
        return nontrivial & (res >= tol) & (it < max_iters)

    def body(carry):
        p, r, s, sigma, _, it = carry
        z = apply_A1(s)
        denom = _zdot(z, s)
        alpha = sigma / jnp.where(denom != 0.0, denom, 1.0)
        p = p + alpha * s
        r = r - alpha * z
        res = lax.pmax(jnp.max(jnp.abs(r)), AXIS)
        z = apply_M(r)
        sigma_new = _zdot(z, r)
        beta = sigma_new / jnp.where(sigma != 0.0, sigma, 1.0)
        s = z + beta * s
        return p, r, s, sigma_new, res, it + 1

    p, r, _, _, res, iters = lax.while_loop(
        cond,
        body,
        (p0, r0, z0, sigma0, jnp.where(nontrivial, res0, 0.0), jnp.int32(0)),
    )
    return pressure_mod.PressureResult(
        pressure=p * lvl0.fluid, residual=res, iterations=iters
    )


# ---------------------------------------------------------------------------
# Local grid stages (RHS / apply_pressure / extrapolation with ghosts)
# ---------------------------------------------------------------------------


class LocalGrid(NamedTuple):
    """Per-tile face arrays. w carries its nzl+1 local faces (the top face is
    the next tile's bottom face — both tiles compute it identically)."""

    u: jnp.ndarray  # (nx+1, ny, nzl)
    v: jnp.ndarray  # (nx, ny+1, nzl)
    w: jnp.ndarray  # (nx, ny, nzl+1)
    cell_type: jnp.ndarray  # (nx, ny, nzl) int8


def _open_face_masks_local(ct_local, dtype):
    """Faces whose two adjacent cells (out-of-domain = solid) are non-solid;
    z needs the ghost type layers."""
    cte = pad_z(ct_local, fill=CellType.SOLID)
    solid = cte == CellType.SOLID
    sp = jnp.pad(solid, ((1, 1), (1, 1), (0, 0)), constant_values=True)
    open_u = (~sp[:-1, 1:-1, 1:-1] & ~sp[1:, 1:-1, 1:-1]).astype(dtype)
    open_v = (~sp[1:-1, :-1, 1:-1] & ~sp[1:-1, 1:, 1:-1]).astype(dtype)
    open_w = (~solid[:, :, :-1] & ~solid[:, :, 1:]).astype(dtype)  # nzl+1 faces
    return open_u, open_v, open_w


def _rhs_local(g: LocalGrid, cfg: SimConfig) -> jnp.ndarray:
    open_u, open_v, open_w = _open_face_masks_local(g.cell_type, cfg.dtype)
    ue = g.u * open_u
    ve = g.v * open_v
    we = g.w * open_w
    div = (ue[1:] - ue[:-1]) + (ve[:, 1:] - ve[:, :-1]) + (we[:, :, 1:] - we[:, :, :-1])
    fluid = (g.cell_type == CellType.FLUID).astype(cfg.dtype)
    return -div / cfg.cell_size * fluid


def _apply_pressure_local(g: LocalGrid, p: jnp.ndarray, cfg: SimConfig, dt) -> LocalGrid:
    """``pressure.apply_pressure`` on a tile: one ghost layer of pressure and
    of cell types covers the z-face updates (incl. the shared top face)."""
    coeff = dt / (cfg.density * cfg.cell_size)
    ct = g.cell_type
    fluid_local = (ct == CellType.FLUID).astype(jnp.int8)
    fe = pad_z(fluid_local, fill=0) > 0  # (nx, ny, nzl+2) bool
    pe = pad_z(p * fluid_local.astype(p.dtype), fill=0.0)
    open_u, open_v, open_w = _open_face_masks_local(ct, cfg.dtype)

    fp_xy = jnp.pad(fe, ((1, 1), (1, 1), (0, 0)), constant_values=False)
    pp_xy = jnp.pad(pe, ((1, 1), (1, 1), (0, 0)))

    def upd(face_vel, p_l, p_r, f_l, f_r, open_m):
        touched = f_l | f_r
        updated = face_vel - coeff * (p_r - p_l)
        new_vel = jnp.where(open_m > 0, updated, 0.0)
        return jnp.where(touched, new_vel, face_vel)

    u = upd(
        g.u,
        pp_xy[:-1, 1:-1, 1:-1],
        pp_xy[1:, 1:-1, 1:-1],
        fp_xy[:-1, 1:-1, 1:-1],
        fp_xy[1:, 1:-1, 1:-1],
        open_u,
    )
    v = upd(
        g.v,
        pp_xy[1:-1, :-1, 1:-1],
        pp_xy[1:-1, 1:, 1:-1],
        fp_xy[1:-1, :-1, 1:-1],
        fp_xy[1:-1, 1:, 1:-1],
        open_v,
    )
    w = upd(g.w, pe[:, :, :-1], pe[:, :, 1:], fe[:, :, :-1], fe[:, :, 1:], open_w)
    return g._replace(u=u, v=v, w=w)


def _extrapolate_local(g: LocalGrid, cfg: SimConfig) -> LocalGrid:
    """``extrapolation.extrapolate`` on a tile: ghost (vel, valid) layers per
    sweep, ghost types once (fill SOLID at domain ends)."""
    iters = cfg.velocity_extrapolation_iterations
    if iters <= 0:
        return g
    ct = g.cell_type
    cte = pad_z(ct, fill=CellType.SOLID)  # (nx, ny, nzl+2)
    vel_pf = jnp.stack([g.u[1:], g.v[:, 1:], g.w[:, :, 1:]], axis=-1)
    valid = (ct == CellType.FLUID).astype(cfg.dtype)

    def nsum_ext(xe):
        """Sum of 6 neighbors; input already z-extended, x/y zero-padded.
        Input (nx+2?, no: (nx, ny, nzl+2, ...)); crops back to local z."""
        pad = [(1, 1), (1, 1), (0, 0)] + [(0, 0)] * (xe.ndim - 3)
        xp = jnp.pad(xe, pad)
        return (
            xp[:-2, 1:-1, 1:-1]
            + xp[2:, 1:-1, 1:-1]
            + xp[1:-1, :-2, 1:-1]
            + xp[1:-1, 2:, 1:-1]
            + xp[1:-1, 1:-1, :-2]
            + xp[1:-1, 1:-1, 2:]
        )

    def shift_neg_ext(xe, axis, fill):
        """Positive-neighbor value; z-extended input, crop to local z."""
        if axis == 2:
            return xe[:, :, 2:]
        pad = [(0, 0)] * xe.ndim
        pad[axis] = (0, 1)
        sl = [slice(None)] * xe.ndim
        sl[axis] = slice(1, None)
        out = jnp.pad(xe, pad, constant_values=fill)[tuple(sl)]
        return out[:, :, 1:-1]

    def body(_, carry):
        vel, valid = carry
        # z-extend the mutable fields (vel is (nx, ny, nzl, 3): move z last
        # for the ghost helper, then back)
        ve = jnp.moveaxis(pad_z(jnp.moveaxis(vel, 2, -1)), -1, 2)
        va = pad_z(valid)
        nsum = nsum_ext(ve * va[..., None])
        ncount = nsum_ext(va)
        has = ncount > 0
        avg = nsum / jnp.maximum(ncount, 1.0)[..., None]
        newly = (valid == 0) & has
        writes = []
        for dim in range(3):
            nb_valid = shift_neg_ext(va, dim, 0.0) > 0
            nb_type = shift_neg_ext(cte, dim, jnp.int8(CellType.SOLID))
            writes.append(newly & nb_valid & (nb_type == ct))
        write = jnp.stack(writes, axis=-1)
        vel = jnp.where(write, avg, vel)
        valid = jnp.where(newly, 1.0, valid)
        return vel, valid

    vel_pf, _ = lax.fori_loop(0, iters, body, (vel_pf, valid))
    u = g.u.at[1:].set(vel_pf[..., 0])
    v = g.v.at[:, 1:].set(vel_pf[..., 1])
    w = g.w.at[:, :, 1:].set(vel_pf[..., 2])
    return g._replace(u=u, v=v, w=w)


# ---------------------------------------------------------------------------
# Particle exchange
# ---------------------------------------------------------------------------


def _exchange_particles(pos, vel, aff, act, cfg: SimConfig, nzl: int, cap: int):
    """Re-home particles to the device owning their z-slab (ring ±1).

    Motion is CFL-bounded well under one slab width, so |owner - self| <= 1;
    anything further (cannot happen under the CFL driver) is deactivated and
    counted. Returns (pos, vel, aff, act, lost_count)."""
    n = pos.shape[0]
    d = lax.axis_index(AXIS)
    ndev = lax.psum(1, AXIS)
    h = cfg.cell_size
    offz = cfg.grid_offset[2]

    zc = jnp.clip(
        jnp.floor((pos[:, 2] - offz) / h).astype(jnp.int32), 0, cfg.nz - 1
    )
    owner = zc // nzl
    rel = owner - d

    payload = jnp.concatenate(
        [pos, vel, aff.reshape(n, 9), act[:, None].astype(pos.dtype)], axis=1
    )  # (N, 16)

    def pack(mask):
        idx = jnp.nonzero(mask, size=cap, fill_value=n)[0]
        ok = (idx < n)[:, None].astype(payload.dtype)
        buf = payload[jnp.minimum(idx, n - 1)] * ok
        sent = jnp.sum((idx < n).astype(jnp.int32))
        return buf, sent

    up_mask = act & (rel == 1)
    dn_mask = act & (rel == -1)
    buf_up, sent_up = pack(up_mask)
    buf_dn, sent_dn = pack(dn_mask)
    # overflow past the buffer, or |rel| > 1: deactivated, counted as lost
    lost = (
        jnp.sum(up_mask.astype(jnp.int32))
        - sent_up
        + jnp.sum(dn_mask.astype(jnp.int32))
        - sent_dn
        + jnp.sum((act & (jnp.abs(rel) > 1)).astype(jnp.int32))
    )

    recv_lo = lax.ppermute(buf_up, AXIS, _ring(ndev))  # from d-1
    recv_hi = lax.ppermute(buf_dn, AXIS, _ring_rev(ndev))  # from d+1
    recv_lo = jnp.where(d == 0, jnp.zeros_like(recv_lo), recv_lo)
    recv_hi = jnp.where(d == ndev - 1, jnp.zeros_like(recv_hi), recv_hi)
    recv = jnp.concatenate([recv_lo, recv_hi], axis=0)  # (2cap, 16)
    # received particles first: the free slots go to them, not to the empty
    # tail of the lower buffer (which otherwise pushed every row received
    # from above past a nearly full block's free slots)
    recv = recv[jnp.argsort(recv[:, 15] <= 0.5, stable=True)]

    keep = act & (rel == 0)
    kept = payload * keep[:, None].astype(payload.dtype)
    free_idx = jnp.nonzero(~keep, size=2 * cap, fill_value=n)[0]
    merged = kept.at[free_idx].set(recv, mode="drop", unique_indices=True)
    # received rows that found no free slot are lost; count them
    recv_act = recv[:, 15] > 0.5
    dropped = jnp.sum((recv_act & (free_idx >= n)).astype(jnp.int32))
    lost = lax.psum(lost + dropped, AXIS)

    return (
        merged[:, 0:3],
        merged[:, 3:6],
        merged[:, 6:15].reshape(n, 3, 3),
        merged[:, 15] > 0.5,
        lost,
    )


# ---------------------------------------------------------------------------
# The sharded substep
# ---------------------------------------------------------------------------


def _local_cfg(cfg: SimConfig, nzl: int, nl: int, extra_z: int = 0) -> SimConfig:
    return dataclasses.replace(
        cfg, grid_size=(cfg.nx, cfg.ny, nzl + extra_z), particle_capacity=nl
    )


def _local_substep(state: SimState, w_top, cfg: SimConfig, dt, ndev: int):
    """The per-device substep body (runs under shard_map). `state` holds the
    device-local particle rows and z-tile grid arrays; w_top is the replicated
    global top w plane (kept only for state-shape fidelity — every face array
    is rebuilt by P2G before use)."""
    nx, ny = cfg.nx, cfg.ny
    nzl = cfg.nz // ndev
    nl = state.position.shape[0]
    d = lax.axis_index(AXIS)
    h = cfg.cell_size
    dt = jnp.asarray(dt, cfg.dtype)
    cfg_l = _local_cfg(cfg, nzl, nl)
    cfg_e = _local_cfg(cfg, nzl, nl, extra_z=2)
    zshift = (d * nzl).astype(cfg.dtype) * h  # world-z offset of this tile

    # --- source velocity coercion (world coords; source cells replicated) ---
    if state.sources.cells.shape[0] > 0:
        state = sources_mod.coerce_velocities(state, cfg)
    pos, vel, aff, act = state.position, state.velocity, state.affine, state.active
    old_pos = pos

    # --- advection (+ clamp into the skin-shrunk global domain) ---
    skin = cfg.boundary_skin_width
    lo = jnp.asarray(cfg.domain_min, cfg.dtype) + skin
    hi = jnp.asarray(cfg.domain_max, cfg.dtype) - skin
    newp = jnp.clip(pos + vel * dt, lo, hi)
    pos = jnp.where(act[:, None], newp, pos)

    # --- collisions (global world coords; solid mask is replicated) ---
    if cfg.enable_collisions:
        cp = collisions_mod.resolve_collisions(old_pos, pos, state.solid, cfg)
        pos = jnp.where(act[:, None], cp, pos)

    # --- particle exchange: re-home to the owning z-slab. Buffer capacity is
    # half the block (the most the free-slot merge can absorb): a CFL-bounded
    # substep can march a whole boundary layer across at once ---
    pos, vel, aff, act, lost = _exchange_particles(
        pos, vel, aff, act, cfg, nzl,
        cap=cfg.exchange_capacity or max(64, nl // 2),
    )

    # --- local binning + physical sort (z-shifted positions) ---
    zoff = jnp.asarray([0.0, 0.0, 1.0], cfg.dtype) * zshift
    pos_l = pos - zoff
    st_l = state._replace(position=pos_l, velocity=vel, affine=aff, active=act)

    # --- sources: seed the owning slab's cells back to target density
    # (``_update_sources``, ``simulation.cpp:756-765``). Seeding is per-cell
    # and local: each source cell belongs to exactly one z-slab, so the
    # owner seeds it into its local rows with a device-folded key (VERDICT
    # r3 missing #3 / next #6). Statically skipped when no sources exist. ---
    if state.sources.cells.shape[0] > 0:
        src = state.sources
        owner = src.cells[:, 2] // nzl
        local_cells = src.cells.at[:, 2].add(-d * nzl)
        local_cells = local_cells.at[:, 2].set(
            jnp.clip(local_cells[:, 2], 0, nzl - 1)
        )
        src_l = src._replace(
            cells=local_cells, active=src.active & (owner == d)
        )
        occ0 = binning_mod.bin_particles(st_l.position, st_l.active, cfg_l).occupancy
        key0, kseed = jax.random.split(state.key)
        st_seed = st_l._replace(
            sources=src_l, key=jax.random.fold_in(kseed, d)
        )
        st_seed = sources_mod.seed_sources(st_seed, occ0, cfg_l)
        st_l = st_seed._replace(key=key0, sources=state.sources)
        act = st_l.active
        state = state._replace(key=key0)  # later stages split from key0
    st_l, bins = binning_mod.sort_by_cell(st_l, cfg_l)
    pos_l, vel, aff, act = st_l.position, st_l.velocity, st_l.affine, st_l.active
    old_pos_l = pos_l

    # --- slot grid + ghost slot layers (ONE payload exchange both ways) ---
    slot_grid = slots_mod.build(
        pos_l,
        vel,
        aff if cfg.scheme == TransferScheme.APIC else None,
        bins,
        cfg_l,
    )
    # The P2G/correction passes run on a ghost-EXTENDED tile whose cell 0 is
    # the neighbor-below's last layer ("ext frame": local z + h). Stored slot
    # positions must be re-expressed in that frame: own cells shift by +h,
    # ghost layers additionally by ∓ nzl*h (the neighbors' local frames).
    data = slot_grid.data  # (16, K, nx, ny, nzl)
    glo, ghi = ghosts_z(data)  # (16, K, nx, ny, 1) each
    zrow = jnp.zeros((16,), cfg.dtype).at[2].set(1.0).reshape(16, 1, 1, 1, 1)
    glo = glo + zrow * (h - nzl * h) * glo[3:4]
    ghi = ghi + zrow * (h + nzl * h) * ghi[3:4]
    data_c = data + zrow * h * data[3:4]
    data_ext = jnp.concatenate([glo, data_c, ghi], axis=-1)  # (16,K,nx,ny,nzl+2)

    # --- P2G on the ghost-extended tile (exact for slot-resident particles:
    # every owned face sees all contributing cells; a NEIGHBOR's overflow
    # particles in its edge layer are not carried by the ghost exchange, so
    # hyper-compressed cells at tile seams degrade like the dense path's
    # past-capacity case — Diagnostics.overflow_count reports it) ---
    pos_e = pos_l + jnp.asarray([0.0, 0.0, 1.0], cfg.dtype) * h  # ext frame
    num, den = transfers._p2g_slots_jnp(data_ext, cfg_e)
    n_o, d_o = _p2g_overflow(slot_grid, pos_e, vel, aff, act, cfg_e)
    u = transfers._normalize(num[0][:, :, 1:-1] + n_o[0][:, :, 1:-1],
                             den[0][:, :, 1:-1] + d_o[0][:, :, 1:-1])
    v = transfers._normalize(num[1][:, :, 1:-1] + n_o[1][:, :, 1:-1],
                             den[1][:, :, 1:-1] + d_o[1][:, :, 1:-1])
    w = transfers._normalize(num[2][:, :, 1:-1] + n_o[2][:, :, 1:-1],
                             den[2][:, :, 1:-1] + d_o[2][:, :, 1:-1])
    # u/v: crop the ghost cell layers; w (ext faces 0..nzl+2): ext face j is
    # local face j-1, keep local faces 0..nzl -> ext 1..nzl+1 == [1:-1]

    # --- mark cells ---
    solid_l = lax.dynamic_slice_in_dim(state.solid, d * nzl, nzl, 2)
    occ = bins.occupancy
    fluid_b = (occ > 0) & ~solid_l
    ct = jnp.where(
        solid_l,
        jnp.int8(CellType.SOLID),
        jnp.where(fluid_b, jnp.int8(CellType.FLUID), jnp.int8(CellType.AIR)),
    )
    g = LocalGrid(u=u, v=v, w=w, cell_type=ct)

    old_g = None
    if cfg.scheme == TransferScheme.APIC:
        g = _remove_boundary_normals_local(g, d, ndev)
    elif cfg.scheme == TransferScheme.FLIP:
        old_g = _remove_boundary_normals_local(g, d, ndev)

    # --- gravity (all faces except the global min-wall layers) ---
    gvec = jnp.asarray(cfg.gravity, cfg.dtype) * dt
    u2 = g.u.at[1:].add(gvec[0])
    v2 = g.v.at[:, 1:].add(gvec[1])
    w2 = g.w + gvec[2]
    w2 = jnp.where(
        (d == 0)
        & (jax.lax.broadcasted_iota(jnp.int32, w2.shape, 2) == 0),
        g.w,
        w2,
    )
    g = g._replace(u=u2, v=v2, w=w2)

    # --- pressure projection (sharded MG-PCG) ---
    levels = build_zlevels(g.cell_type, cfg.nz, cfg.dtype)
    a_scale = dt / (cfg.density * cfg.cell_size * cfg.cell_size)
    b = _rhs_local(g, cfg)
    pres = _cg_z(
        levels, b, a_scale, cfg.solver.tolerance, cfg.solver.max_iterations,
        pressure_mod._precond_tag(cfg), x0=state.pressure,
    )
    g = _apply_pressure_local(g, pres.pressure, cfg, dt)

    # --- position correction on the ghost-extended slot grid ---
    key = state.key
    corr_unc = jnp.int32(0)
    if cfg.enable_position_correction:
        key, sub = jax.random.split(key)
        kc_l = min(cfg.correction_capacity, slot_grid.capacity)
        ncl = cfg.nx * cfg.ny * slot_grid.data.shape[-1]
        corr_unc = jnp.maximum(
            0,
            jnp.sum((act & (slot_grid.slot_of >= kc_l * ncl)).astype(jnp.int32))
            - cfg.correction_overflow_capacity,
        )
        pos_l = _correct_positions_local(
            pos_l, act, slot_grid, data_ext, cfg, cfg_e, dt, sub, zshift,
            z0=d * nzl,
        )
    if cfg.enable_collisions:
        cp = collisions_mod.resolve_collisions(
            old_pos_l + zoff, pos_l + zoff, state.solid, cfg
        )
        pos_l = jnp.where(act[:, None], cp - zoff, pos_l)

    # --- velocity extrapolation ---
    g = _extrapolate_local(g, cfg)

    # --- G2P from the ghost-extended face arrays ---
    ge_u = pad_z(g.u)
    ge_v = pad_z(g.v)
    w_lo_ghost, _ = ghosts_z(g.w[:, :, :-1])  # neighbor-below's face nzl-1
    _, w_hi_ghost = ghosts_z(g.w[:, :, 1:], fill=0.0)  # neighbor-above's face 1
    ge_w = jnp.concatenate([w_lo_ghost, g.w, w_hi_ghost], axis=-1)
    grid_e = grids.MacGrid(u=ge_u, v=ge_v, w=ge_w, cell_type=None)
    pos_e2 = pos_l + jnp.asarray([0.0, 0.0, 1.0], cfg.dtype) * h
    if cfg.scheme == TransferScheme.PIC:
        nvel, _ = transfers.g2p_pic(grid_e, pos_e2, cfg_e)
        naff = aff
    elif cfg.scheme == TransferScheme.FLIP:
        oe = grids.MacGrid(
            u=pad_z(old_g.u), v=pad_z(old_g.v),
            w=jnp.concatenate(
                [ghosts_z(old_g.w[:, :, :-1])[0], old_g.w,
                 ghosts_z(old_g.w[:, :, 1:])[1]], axis=-1),
            cell_type=None,
        )
        nvel = transfers.g2p_flip(grid_e, oe, pos_e2, vel, cfg_e)
        naff = aff
    else:
        nvel, naff = transfers.g2p_pic(grid_e, pos_e2, cfg_e)
    nvel = jnp.where(act[:, None], nvel, vel)
    naff = jnp.where(act[:, None, None], naff, aff)

    pos = pos_l + zoff

    # --- diagnostics (global reductions) ---
    active_f = act.astype(cfg.dtype)
    vsq = jnp.sum(nvel**2, axis=-1) * active_f
    gv = jnp.asarray(cfg.gravity, cfg.dtype)
    diag = Diagnostics(
        kinetic_energy=lax.psum(0.5 * jnp.sum(vsq), AXIS),
        potential_energy=lax.psum(
            -jnp.sum(jnp.sum(pos * gv, axis=-1) * active_f), AXIS
        ),
        max_velocity=jnp.sqrt(lax.pmax(jnp.max(vsq), AXIS)),
        pressure_iterations=pres.iterations,
        pressure_residual=pres.residual,
        max_pressure=lax.pmax(jnp.max(jnp.abs(pres.pressure)), AXIS),
        max_divergence=lax.pmax(
            jnp.max(jnp.abs(_rhs_local(g, cfg) * cfg.cell_size)), AXIS
        ),
        particle_count=lax.psum(jnp.sum(act.astype(jnp.int32)), AXIS),
        substeps=jnp.int32(1),
        overflow_count=lax.psum(
            jnp.sum(slot_grid.overflow.astype(jnp.int32)), AXIS
        ),
        particles_lost=lost,
        correction_uncorrected=lax.psum(corr_unc, AXIS),
    )

    new_state = state._replace(
        position=pos,
        velocity=nvel,
        affine=naff,
        active=act,
        grid=grids.MacGrid(
            u=g.u, v=g.v, w=g.w[:, :, :-1], cell_type=g.cell_type
        ),
        key=key,
        time=state.time + dt,
        pressure=pres.pressure,
    )
    return new_state, g.w[:, :, -1:], diag


def _p2g_overflow(slot_grid, pos_e, vel, aff, act, cfg_e: SimConfig):
    """Scatter-add the slot-overflow particles into ext-frame accumulators
    (the tail of ``transfers.p2g_slots``, compacted)."""
    n = pos_e.shape[0]
    cap = min(max(256, cfg_e.p2g_overflow_capacity), n)
    use_affine = cfg_e.scheme == TransferScheme.APIC
    idx = jnp.nonzero(slot_grid.overflow, size=cap, fill_value=n)[0]
    ok = idx < n
    safe = jnp.minimum(idx, n - 1)
    pos_o = pos_e[safe]
    vel_o = vel[safe]
    aff_o = aff[safe] if use_affine else None
    act_o = ok & act[safe]
    nums, dens = [], []
    for axis in range(3):
        n_o, d_o = transfers._p2g_axis(
            pos_o,
            vel_o[:, axis],
            aff_o[:, axis, :] if use_affine else None,
            act_o,
            cfg_e,
            axis,
        )
        nums.append(n_o)
        dens.append(d_o)
    return nums, dens


def _remove_boundary_normals_local(g: LocalGrid, d, ndev) -> LocalGrid:
    u = g.u.at[0].set(0.0).at[-1].set(0.0)
    v = g.v.at[:, 0].set(0.0).at[:, -1].set(0.0)
    zidx = jax.lax.broadcasted_iota(jnp.int32, g.w.shape, 2)
    wall = ((d == 0) & (zidx == 0)) | ((d == ndev - 1) & (zidx == g.w.shape[2] - 1))
    w = jnp.where(wall, 0.0, g.w)
    return g._replace(u=u, v=v, w=w)


def _correct_positions_local(
    pos_l, act, slot_grid, data_ext, cfg: SimConfig, cfg_e: SimConfig, dt,
    key, zshift, z0=0,
):
    """``correction.correct_positions`` against the ghost-extended slot grid;
    springs for the owned cells are cropped back out. ``z0`` is the global z
    cell coordinate of local cell 0 (the jitter hashes GLOBAL coordinates so
    the sharded springs agree bit-for-bit with the dense path's — the ghost
    layer at ext z=0 is global z0-1, i.e. the neighbor-below's edge layer,
    and both sides hash it identically)."""
    kc = min(cfg.correction_capacity, slot_grid.capacity)
    res_pos = data_ext[slots_mod.COL_POS][:, :kc]  # (3, KC, nx, ny, nzl+2)
    res_mask = data_ext[slots_mod.COL_MASK][:kc]
    re2 = cfg.cell_size * cfg.cell_size / 2.0
    seed = jitterhash.seed_from_key(key)
    springs = correction_mod._springs_jnp(
        res_pos, res_mask, re2, seed, cfg_e, origin=(0, 0, z0 - 1)
    )
    springs = springs[..., 1:-1]  # crop ghosts -> (3, KC, nx, ny, nzl)

    num_cells = cfg.nx * cfg.ny * (slot_grid.data.shape[-1])
    slot_of = jnp.where(
        slot_grid.slot_of < kc * num_cells, slot_grid.slot_of, kc * num_cells
    )
    spring = slots_mod.gather_per_particle(
        springs, slot_grid._replace(slot_of=slot_of)
    )

    # truncated/overflow particles: compacted pass vs the ext resident field
    h = cfg.cell_size
    pos_e = pos_l + jnp.asarray([0.0, 0.0, 1.0], cfg.dtype) * h
    truncated = act & (slot_grid.slot_of >= kc * num_cells)
    oidx, ospring = correction_mod.overflow_springs(
        pos_e, truncated, res_pos, res_mask, re2, cfg_e,
        cfg.correction_overflow_capacity,
    )
    n = pos_l.shape[0]
    spring = spring.at[jnp.minimum(oidx, n - 1)].add(
        jnp.where((oidx < n)[:, None], ospring, 0.0)
    )
    re = cfg.cell_size / jnp.sqrt(jnp.asarray(2.0, cfg.dtype))
    new_pos = pos_l + spring * (dt * cfg.correction_stiffness * re)
    zoff = jnp.asarray([0.0, 0.0, 1.0], cfg.dtype) * zshift
    lo = jnp.asarray(cfg.domain_min, cfg.dtype) - zoff
    hi = jnp.asarray(cfg.domain_max, cfg.dtype) - zoff
    new_pos = jnp.clip(new_pos, lo, hi)
    return jnp.where(act[:, None], new_pos, pos_l)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _check(cfg: SimConfig, state: SimState, ndev: int):
    if cfg.nz % ndev != 0:
        raise ValueError(f"nz={cfg.nz} not divisible by {ndev} devices")
    if state.position.shape[0] % ndev != 0:
        raise ValueError("particle capacity not divisible by device count")
    if cfg.nz // ndev < int(np.ceil(cfg.cfl_number)) + 1:
        raise ValueError(
            f"z-slab width {cfg.nz // ndev} too thin for CFL {cfg.cfl_number} "
            "(particles could skip a slab)"
        )


def substep_z(state: SimState, cfg: SimConfig, dt, mesh: Mesh):
    """One explicitly sharded substep. `state`'s particle rows must already be
    owner-distributed (see :func:`zshard_state`); returns (state, diagnostics)
    with the same layout."""
    ndev = mesh.devices.size
    _check(cfg, state, ndev)

    def run(st: SimState, w_top):
        return _local_substep(st, w_top, cfg, dt, ndev)

    pspec = P(AXIS)
    gspec = P(None, None, AXIS)
    state_in_specs = SimState(
        position=pspec, velocity=pspec, affine=pspec, active=pspec,
        grid=grids.MacGrid(u=gspec, v=gspec, w=gspec, cell_type=gspec),
        solid=P(), sources=jax.tree_util.tree_map(lambda _: P(), state.sources),
        key=P(), time=P(), pressure=gspec,
    )

    mapped = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(state_in_specs, P()),
        out_specs=(state_in_specs, gspec, P()),
        check_vma=False,
    )

    w = state.grid.w
    w_lo = w[:, :, : cfg.nz]
    w_top = w[:, :, cfg.nz :]
    st_in = state._replace(grid=state.grid._replace(w=w_lo))
    new_st, w_top_all, diag = mapped(st_in, w_top)
    w_full = jnp.concatenate(
        [new_st.grid.w, w_top_all[:, :, -1:]], axis=2
    )
    return new_st._replace(grid=new_st.grid._replace(w=w_full)), diag


def zshard_state(
    state: SimState,
    cfg: SimConfig,
    mesh: Mesh,
    per_device_capacity: int | None = None,
    slack: float = 1.5,
) -> SimState:
    """Host-side: distribute particle rows so device d's block holds exactly
    the particles in its z-slab, and device_put with the sharded layout.

    Spatial decomposition is load-imbalanced for concentrated seeds (a corner
    dam break lives in a few slabs) — exactly like the reference's OpenMP
    z-slice loops (``mesher.cpp:345``). Each device block therefore gets
    ``per_device_capacity`` rows (default: `slack` x the busiest slab's
    current count, 256-aligned); the returned state's particle capacity is
    ``ndev * per_device_capacity``, padded with inactive rows. If a slab
    later outgrows its block, the excess is dropped and counted in
    ``Diagnostics.particles_lost`` (mass loss — distinct from the benign
    slot-capacity warning ``overflow_count``)."""
    ndev = mesh.devices.size
    if cfg.nz % ndev != 0:
        raise ValueError(f"nz={cfg.nz} not divisible by {ndev} devices")
    nzl = cfg.nz // ndev

    pos = np.asarray(state.position)
    act = np.asarray(state.active)
    zc = np.clip(
        np.floor((pos[:, 2] - cfg.grid_offset[2]) / cfg.cell_size).astype(int),
        0,
        cfg.nz - 1,
    )
    owner = np.where(act, zc // nzl, -1)
    counts = np.bincount(owner[owner >= 0], minlength=ndev)
    if per_device_capacity is None:
        n_even = -(-int(act.sum()) // ndev)
        nl = int(max(counts.max(), n_even, 256) * slack)
        nl = -(-nl // 256) * 256
    else:
        nl = per_device_capacity
        if counts.max() > nl:
            raise ValueError(
                f"busiest slab holds {counts.max()} particles > "
                f"per_device_capacity {nl}"
            )

    vel = np.asarray(state.velocity)
    aff = np.asarray(state.affine)
    npos = np.zeros((nl * ndev, 3), pos.dtype)
    nvel = np.zeros((nl * ndev, 3), vel.dtype)
    naff = np.zeros((nl * ndev, 3, 3), aff.dtype)
    nact = np.zeros((nl * ndev,), bool)
    for d in range(ndev):
        ids = np.flatnonzero(owner == d)
        blk = slice(d * nl, d * nl + ids.size)
        npos[blk] = pos[ids]
        nvel[blk] = vel[ids]
        naff[blk] = aff[ids]
        nact[blk] = True

    psh = NamedSharding(mesh, P(AXIS))
    gsh = NamedSharding(mesh, P(None, None, AXIS))
    rep = NamedSharding(mesh, P())

    return state._replace(
        position=jax.device_put(jnp.asarray(npos), psh),
        velocity=jax.device_put(jnp.asarray(nvel), psh),
        affine=jax.device_put(jnp.asarray(naff), psh),
        active=jax.device_put(jnp.asarray(nact), psh),
        grid=state.grid._replace(
            u=jax.device_put(state.grid.u, gsh),
            v=jax.device_put(state.grid.v, gsh),
            w=jax.device_put(state.grid.w, rep),
            cell_type=jax.device_put(state.grid.cell_type, gsh),
        ),
        solid=jax.device_put(state.solid, rep),
        sources=jax.tree_util.tree_map(
            lambda x: jax.device_put(x, rep), state.sources
        ),
        key=jax.device_put(state.key, rep),
        time=jax.device_put(state.time, rep),
    )


def step_z(state: SimState, cfg: SimConfig, dt, mesh: Mesh):
    """CFL-substepped driver over :func:`substep_z` (cf. ``sim.step.step``)."""
    from libfluid_tpu.sim.step import cfl_dt

    dt = jnp.asarray(dt, cfg.dtype)

    def cond(carry):
        _, remaining, _, _ = carry
        return remaining > 0.0

    def body(carry):
        st, remaining, prev, nsub = carry
        ts = jnp.minimum(cfg.cfl_number * cfl_dt(st, cfg), remaining)
        st, diag = substep_z(st, cfg, ts, mesh)
        # mass loss accumulates over substeps (other fields report the last)
        diag = diag._replace(
            particles_lost=prev.particles_lost + diag.particles_lost
        )
        return st, remaining - ts, diag, nsub + 1

    _, dummy = jax.eval_shape(lambda s: substep_z(s, cfg, dt, mesh), state)
    zero_diag = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), dummy)
    state, _, diag, nsub = lax.while_loop(
        cond, body, (state, dt, zero_diag, jnp.int32(0))
    )
    return state, diag._replace(substeps=nsub)
