"""Geometric multigrid preconditioner for the pressure Poisson solve.

The reference preconditions CG with MIC(0) (``pressure_solver.cpp:244-332``)
— two *sequential* triangular sweeps, unshardable and O(n) serial depth. The
replacement is a matrix-free geometric V-cycle in the style of McAdams,
Sifakis & Teran 2010 ("A parallel multigrid Poisson solver for fluids
simulation on large grids"):

- coarsening by 2 with cell-type rediscretization (coarse cell is FLUID if
  any child is fluid, SOLID if all children are solid, else AIR),
- damped-Jacobi smoothing (order-free stencil, shardable with halos),
- cell-centred trilinear prolongation and its transpose / 8 as restriction,
  equal pre/post smoothing — making the V-cycle a symmetric positive
  operator, as CG requires of its preconditioner,
- per-level operator scale 4^-l (the 1/h^2 of the rediscretized Laplacian).

Iteration counts at 128^3 drop from ~400 (diagonal) to the tens, and every
operation inside is a dense masked stencil.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from libfluid_tpu.config import CellType

_SMOOTH_DAMP = 0.8  # damped-Jacobi weight
# V(2,2) + 12 coarse iterations with the separable trilinear transfer
# operators below
_PRE_SMOOTH = 2
_POST_SMOOTH = 2
_COARSE_ITERS = 12  # Jacobi iterations on the coarsest level
_MIN_SIZE = 8  # stop coarsening at <= this many cells per axis


class MGLevel(NamedTuple):
    fluid: jnp.ndarray  # (nx, ny, nz) 1.0 on fluid
    diag: jnp.ndarray  # #non-solid neighbors on fluid cells
    inv_diag: jnp.ndarray  # 1 / (scale * diag) on fluid cells
    couple_u: jnp.ndarray  # (nx+1, ny, nz)
    couple_v: jnp.ndarray
    couple_w: jnp.ndarray
    scale: float  # 4^-l relative to the finest level's a_scale=1


def _operator_from_types(ct: jnp.ndarray, scale: float, dtype) -> MGLevel:
    solid = ct == CellType.SOLID
    fluid_b = ct == CellType.FLUID
    sp = jnp.pad(solid, 1, constant_values=True)
    nonsolid = (
        (~sp[:-2, 1:-1, 1:-1]).astype(dtype)
        + (~sp[2:, 1:-1, 1:-1]).astype(dtype)
        + (~sp[1:-1, :-2, 1:-1]).astype(dtype)
        + (~sp[1:-1, 2:, 1:-1]).astype(dtype)
        + (~sp[1:-1, 1:-1, :-2]).astype(dtype)
        + (~sp[1:-1, 1:-1, 2:]).astype(dtype)
    )
    fp = jnp.pad(fluid_b, 1, constant_values=False)
    cu = (fp[:-1, 1:-1, 1:-1] & fp[1:, 1:-1, 1:-1]).astype(dtype)
    cv = (fp[1:-1, :-1, 1:-1] & fp[1:-1, 1:, 1:-1]).astype(dtype)
    cw = (fp[1:-1, 1:-1, :-1] & fp[1:-1, 1:-1, 1:]).astype(dtype)
    fluid = fluid_b.astype(dtype)
    diag = nonsolid * fluid
    inv_diag = jnp.where(diag > 0, 1.0 / jnp.maximum(diag * scale, 1e-30), 0.0)
    return MGLevel(fluid, diag, inv_diag, cu, cv, cw, scale)


def _coarsen_types(ct: jnp.ndarray) -> jnp.ndarray:
    """2x coarsening of cell types (any-fluid > all-solid > air)."""
    nx, ny, nz = ct.shape
    # pad odd axes with SOLID (out-of-bounds is solid)
    px, py, pz = nx % 2, ny % 2, nz % 2
    if px or py or pz:
        ct = jnp.pad(ct, ((0, px), (0, py), (0, pz)), constant_values=CellType.SOLID)
    c = ct.reshape(ct.shape[0] // 2, 2, ct.shape[1] // 2, 2, ct.shape[2] // 2, 2)
    c = c.transpose(0, 2, 4, 1, 3, 5).reshape(c.shape[0], c.shape[2], c.shape[4], 8)
    any_fluid = jnp.any(c == CellType.FLUID, axis=-1)
    all_solid = jnp.all(c == CellType.SOLID, axis=-1)
    return jnp.where(
        any_fluid,
        jnp.int8(CellType.FLUID),
        jnp.where(all_solid, jnp.int8(CellType.SOLID), jnp.int8(CellType.AIR)),
    )


def build_levels(cell_type: jnp.ndarray, dtype=jnp.float32) -> Tuple[MGLevel, ...]:
    levels: List[MGLevel] = []
    ct = cell_type
    scale = 1.0
    while True:
        levels.append(_operator_from_types(ct, scale, dtype))
        if min(ct.shape) <= _MIN_SIZE or len(levels) >= 6:
            break
        ct = _coarsen_types(ct)
        scale *= 0.25
    return tuple(levels)


def apply_level(level: MGLevel, p: jnp.ndarray) -> jnp.ndarray:
    """A_l p as static-slice adds."""
    p = p * level.fluid
    nbr = jnp.zeros_like(p)
    nbr = nbr.at[1:].add(level.couple_u[1:-1] * p[:-1])
    nbr = nbr.at[:-1].add(level.couple_u[1:-1] * p[1:])
    nbr = nbr.at[:, 1:].add(level.couple_v[:, 1:-1] * p[:, :-1])
    nbr = nbr.at[:, :-1].add(level.couple_v[:, 1:-1] * p[:, 1:])
    nbr = nbr.at[:, :, 1:].add(level.couple_w[:, :, 1:-1] * p[:, :, :-1])
    nbr = nbr.at[:, :, :-1].add(level.couple_w[:, :, 1:-1] * p[:, :, 1:])
    return level.scale * (level.diag * p - nbr) * level.fluid


def residual(level: MGLevel, x: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(b - A x) * fluid."""
    return (b - apply_level(level, x)) * level.fluid


def _smooth(level: MGLevel, x: jnp.ndarray, b: jnp.ndarray, iters: int) -> jnp.ndarray:
    for _ in range(iters):
        r = b - apply_level(level, x)
        x = x + _SMOOTH_DAMP * level.inv_diag * r
    return x * level.fluid


# cell-centered trilinear transfer operators (vs the old piecewise-constant
# repeat/sum): P interpolates, R = P^T / 8 — the V-cycle stays a symmetric
# operator (CG's requirement) because restriction is the EXACT transpose of
# prolongation including the edge clamp.


def _interleave(lo: jnp.ndarray, hi: jnp.ndarray, axis: int) -> jnp.ndarray:
    st = jnp.stack([lo, hi], axis=axis + 1)
    shape = list(lo.shape)
    shape[axis] *= 2
    return st.reshape(shape)


def _prolong_axis(c: jnp.ndarray, axis: int) -> jnp.ndarray:
    """n -> 2n along axis: F[2j] = .75 C[j] + .25 C[j-1] (edge-clamped),
    F[2j+1] = .75 C[j] + .25 C[j+1]."""
    pad = [(0, 0)] * c.ndim
    pad[axis] = (1, 1)
    cp = jnp.pad(c, pad, mode="edge")

    def sl(start, stop):
        idx = [slice(None)] * c.ndim
        idx[axis] = slice(start, stop)
        return cp[tuple(idx)]

    ctr = sl(1, -1)
    lo = 0.75 * ctr + 0.25 * sl(0, -2)
    hi = 0.75 * ctr + 0.25 * sl(2, None)
    return _interleave(lo, hi, axis)


def _restrict_axis(f: jnp.ndarray, axis: int) -> jnp.ndarray:
    """EXACT transpose of :func:`_prolong_axis` (2n -> n along axis),
    including the fold of the edge-clamp contributions."""
    def sl(arr, start, stop, step=None):
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(start, stop, step)
        return arr[tuple(idx)]

    a = sl(f, 0, None, 2)  # even rows: .75 -> C[j], .25 -> C[j-1]
    b = sl(f, 1, None, 2)  # odd rows: .75 -> C[j], .25 -> C[j+1]
    c = 0.75 * (a + b)
    mless = 0.25 * a
    mplus = 0.25 * b
    # C[j-1] += mless[j] for j >= 1; the j = 0 clamp folds into C[0], and
    # symmetrically for mplus at the high edge
    c_shift_down = jnp.concatenate([sl(mless, 1, None), jnp.zeros_like(sl(mless, 0, 1))], axis=axis)
    c_fold_lo = jnp.zeros_like(c).at[tuple(
        [slice(None)] * axis + [slice(0, 1)]
    )].set(sl(mless, 0, 1))
    c_shift_up = jnp.concatenate([jnp.zeros_like(sl(mplus, 0, 1)), sl(mplus, 0, -1)], axis=axis)
    c_fold_hi = jnp.zeros_like(c).at[tuple(
        [slice(None)] * axis + [slice(-1, None)]
    )].set(sl(mplus, -1, None))
    return c + c_shift_down + c_fold_lo + c_shift_up + c_fold_hi


def _restrict(level_c: MGLevel, r: jnp.ndarray) -> jnp.ndarray:
    """R = P^T / 8 (trilinear), masked to coarse fluid cells."""
    nx, ny, nz = r.shape
    px, py, pz = nx % 2, ny % 2, nz % 2
    if px or py or pz:
        # transpose of _prolong's crop is a zero-pad
        r = jnp.pad(r, ((0, px), (0, py), (0, pz)))
    out = r
    for axis in range(3):
        out = _restrict_axis(out, axis)
    return out * 0.125 * level_c.fluid


def _prolong(e_c: jnp.ndarray, fine_shape) -> jnp.ndarray:
    e = e_c
    for axis in range(3):
        e = _prolong_axis(e, axis)
    return e[: fine_shape[0], : fine_shape[1], : fine_shape[2]]


def v_cycle(levels: Tuple[MGLevel, ...], b: jnp.ndarray, l: int = 0) -> jnp.ndarray:
    level = levels[l]
    if l == len(levels) - 1:
        return _smooth(level, jnp.zeros_like(b), b, _COARSE_ITERS)
    x = _smooth(level, jnp.zeros_like(b), b, _PRE_SMOOTH)
    r = residual(level, x, b)
    rc = _restrict(levels[l + 1], r)
    ec = v_cycle(levels, rc, l + 1)
    x = x + _prolong(ec, b.shape) * level.fluid
    x = _smooth(level, x, b, _POST_SMOOTH)
    return x
