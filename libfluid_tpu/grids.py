"""MAC (marker-and-cell) staggered grid as a pytree of dense arrays.

Replaces the reference's ``mac_grid`` (``mac_grid.h``/``mac_grid.cpp``) which
stores per-cell *positive-face* velocities in an array-of-structs grid. Here
the layout is three standard face-centered arrays:

    u: (nx+1, ny, nz)   x-face normal velocities; u[i] is the face between
                        cells i-1 and i (u[0]/u[nx] are the domain walls)
    v: (nx, ny+1, nz)
    w: (nx, ny, nz+1)
    cell_type: (nx, ny, nz) int8, values from :class:`~libfluid_tpu.config.CellType`

Mapping to the reference: ``cell(i,j,k).velocities_posface.x == u[i+1,j,k]``.
Out-of-bounds cells are SOLID (``mac_grid.cpp:26-38``) and out-of-bounds
velocity samples are zero (``mac_grid.cpp:51-112`` clamps them to 0), which the
zero-padded trilinear gather below reproduces exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from libfluid_tpu.config import CellType, SimConfig


class MacGrid(NamedTuple):
    u: jnp.ndarray
    v: jnp.ndarray
    w: jnp.ndarray
    cell_type: jnp.ndarray

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return self.cell_type.shape


def zeros(cfg: SimConfig) -> MacGrid:
    nx, ny, nz = cfg.grid_size
    dt = cfg.dtype
    return MacGrid(
        u=jnp.zeros((nx + 1, ny, nz), dt),
        v=jnp.zeros((nx, ny + 1, nz), dt),
        w=jnp.zeros((nx, ny, nz + 1), dt),
        cell_type=jnp.full((nx, ny, nz), CellType.AIR, jnp.int8),
    )


def _gather_trilerp_zero_pad(arr: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Trilinear sample of `arr` at float index coordinates, zero outside.

    `coords` is (..., 3) in the array's own index space. Samples whose integer
    index falls outside the array read as 0 — the reference's boundary
    convention for face velocities (``mac_grid.cpp:66-76``).
    """
    base = jnp.floor(coords)
    frac = coords - base
    base = base.astype(jnp.int32)
    out = 0.0
    shape = arr.shape
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = base[..., 0] + dx
                iy = base[..., 1] + dy
                iz = base[..., 2] + dz
                inb = (
                    (ix >= 0) & (ix < shape[0])
                    & (iy >= 0) & (iy < shape[1])
                    & (iz >= 0) & (iz < shape[2])
                )
                cx = jnp.clip(ix, 0, shape[0] - 1)
                cy = jnp.clip(iy, 0, shape[1] - 1)
                cz = jnp.clip(iz, 0, shape[2] - 1)
                wgt = (
                    jnp.where(dx == 1, frac[..., 0], 1.0 - frac[..., 0])
                    * jnp.where(dy == 1, frac[..., 1], 1.0 - frac[..., 1])
                    * jnp.where(dz == 1, frac[..., 2], 1.0 - frac[..., 2])
                )
                out = out + jnp.where(inb, wgt, 0.0) * arr[cx, cy, cz]
    return out


def face_index_coords(pos: jnp.ndarray, cfg: SimConfig, axis: int) -> jnp.ndarray:
    """World position -> float index coordinates into the `axis` face array.

    A u-face sample (axis 0) at index (i,j,k) sits at world position
    offset + h*(i, j+0.5, k+0.5); analogous for v/w.
    """
    g = (pos - jnp.asarray(cfg.grid_offset, pos.dtype)) / cfg.cell_size
    shift = jnp.full((3,), 0.5, pos.dtype).at[axis].set(0.0)
    return g - shift


def velocity_at(grid: MacGrid, pos: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """Trilinearly interpolated velocity at world positions (..., 3).

    Equivalent to ``mac_grid::get_face_samples`` + the three ``trilerp`` calls
    in ``simulation.cpp:447-460``, expressed as three zero-padded staggered
    gathers.
    """
    out = [
        _gather_trilerp_zero_pad(arr, face_index_coords(pos, cfg, axis))
        for axis, arr in enumerate((grid.u, grid.v, grid.w))
    ]
    return jnp.stack(out, axis=-1)


def divergence(grid: MacGrid, cfg: SimConfig) -> jnp.ndarray:
    """Per-cell velocity divergence, (nx, ny, nz)."""
    du = grid.u[1:, :, :] - grid.u[:-1, :, :]
    dv = grid.v[:, 1:, :] - grid.v[:, :-1, :]
    dw = grid.w[:, :, 1:] - grid.w[:, :, :-1]
    return (du + dv + dw) / cfg.cell_size


def cell_index_of(pos: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """World position -> clamped integer cell index (..., 3) int32.

    Mirrors ``simulation::world_position_to_cell_index`` (``simulation.cpp:172-197``):
    floor of (pos-offset)/h clamped into [0, n-1].
    """
    g = (pos - jnp.asarray(cfg.grid_offset, pos.dtype)) / cfg.cell_size
    idx = jnp.floor(g).astype(jnp.int32)
    return jnp.clip(idx, 0, jnp.asarray(cfg.grid_size, jnp.int32) - 1)


def flat_cell_index(idx3: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    """(..., 3) int cell index -> flat raw index in C order (z fastest), so
    ``flat.reshape(grid_size)[x, y, z]`` round-trips. (The reference flattens
    x-fastest, ``grid.h:212-222`` — only internal consistency matters, and C
    order matches every ``reshape(nx, ny, nz)`` in this package.)"""
    _, ny, nz = cfg.grid_size
    return (idx3[..., 0] * ny + idx3[..., 1]) * nz + idx3[..., 2]


def unflatten_cell_index(raw: jnp.ndarray, cfg: SimConfig) -> jnp.ndarray:
    _, ny, nz = cfg.grid_size
    z = raw % nz
    y = (raw // nz) % ny
    x = raw // (ny * nz)
    return jnp.stack([x, y, z], axis=-1)


def remove_boundary_normal_velocities(grid: MacGrid) -> MacGrid:
    """Zero the normal velocity on all six domain wall face layers.

    Reference ``_remove_boundary_velocities`` (``simulation.cpp:428-445``)
    zeroes the max-side posface layers; the min-side faces do not exist in its
    storage (implicitly zero). In the standard layout both wall layers are
    explicit, so both are zeroed.
    """
    u = grid.u.at[0].set(0.0).at[-1].set(0.0)
    v = grid.v.at[:, 0].set(0.0).at[:, -1].set(0.0)
    w = grid.w.at[:, :, 0].set(0.0).at[:, :, -1].set(0.0)
    return grid._replace(u=u, v=v, w=w)


def mark_cells(grid: MacGrid, occupancy: jnp.ndarray) -> MacGrid:
    """Set cell types from particle occupancy: non-solid cells become FLUID
    where `occupancy` > 0, else AIR (``simulation.cpp:330-336``)."""
    solid = grid.cell_type == CellType.SOLID
    fluid = (occupancy > 0) & ~solid
    ct = jnp.where(
        solid,
        jnp.int8(CellType.SOLID),
        jnp.where(fluid, jnp.int8(CellType.FLUID), jnp.int8(CellType.AIR)),
    )
    return grid._replace(cell_type=ct)
