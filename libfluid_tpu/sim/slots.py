"""Dense per-cell particle slot grid — the simulator's neighbor structure.

The reference's neighborhood queries (``_for_all_nearby_particles``,
``simulation.h:212-223``) walk linked per-cell index ranges. Here the layout
is a *dense* grid of fixed-capacity particle slots built once per substep,
which avoids scatters and gathers with millions of independent addresses.
Every neighborhood consumer (P2G transfers, position correction) then reads
neighbor cells as *statically shifted slices* of this array — streaming work
that XLA fuses per offset.

Layout: the payload lives in ONE array

    data: (C, K, nx, ny, nz)     C payload columns, K slots per cell

so the minor dims are grid axes and each slot plane is contiguous.
Accordingly the per-particle slot index is plane-major: ``slot = rank * num_cells +
cell`` (rank = index within the cell's sorted run).

Payload columns: position xyz (0:3), mask (3), velocity xyz (4:7), APIC
affine rows row-major (7:16).

Particles beyond the K-th in a cell ("overflow") get no slot; callers read
:attr:`SlotGrid.overflow` to handle them (the step counts them as a
diagnostic; K defaults to ``cfg.max_neighbors_per_cell`` = 12 — 1.5x the
default 8-particles/cell seeding — and the e2e tests assert the count stays
zero on the standard scenes).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from libfluid_tpu.config import SimConfig
from libfluid_tpu.sim.binning import Binning

COL_POS = slice(0, 3)
COL_MASK = 3
COL_VEL = slice(4, 7)
COL_AFFINE = slice(7, 16)
WIDTH = 16


class SlotGrid(NamedTuple):
    data: jnp.ndarray  # (C, K, nx, ny, nz) payload
    slot_of: jnp.ndarray  # (N,) int32 plane-major slot index or sentinel K*num_cells
    overflow: jnp.ndarray  # (N,) bool — active particle with rank >= K

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    @property
    def position(self) -> jnp.ndarray:
        return self.data[COL_POS]  # (3, K, nx, ny, nz)

    @property
    def mask(self) -> jnp.ndarray:
        return self.data[COL_MASK]  # (K, nx, ny, nz)

    @property
    def velocity(self) -> jnp.ndarray:
        return self.data[COL_VEL]

    def affine_row(self, axis: int) -> jnp.ndarray:
        """(3, K, nx, ny, nz) APIC affine row `axis` (the reference's
        c-vector, ``simulation.h:33-35``)."""
        return self.data[7 + 3 * axis : 10 + 3 * axis]


def build(
    position: jnp.ndarray,
    velocity: jnp.ndarray,
    affine: jnp.ndarray | None,
    bins: Binning,
    cfg: SimConfig,
) -> SlotGrid:
    """Build the slot grid from CELL-SORTED particle arrays.

    The inputs must be in ``bins`` sorted order (``binning.sort_by_cell``):
    each cell's particles are then a contiguous run and the slot indices are
    unique by construction — one scatter of one contiguous payload row per
    particle.
    """
    k = cfg.max_neighbors_per_cell
    n = position.shape[0]
    num_cells = cfg.num_cells

    cell = bins.cell_of  # sorted; sentinel num_cells for inactive
    in_grid = cell < num_cells
    rank = jnp.arange(n, dtype=jnp.int32) - bins.cell_start[
        jnp.minimum(cell, num_cells - 1)
    ]
    ok = in_grid & (rank < k)
    slot = jnp.where(ok, rank * num_cells + cell, num_cells * k)

    cols = [position, jnp.ones((n, 1), cfg.dtype), velocity]
    if affine is not None:
        cols.append(affine.reshape(n, 9))
    else:
        cols.append(jnp.zeros((n, 9), cfg.dtype))
    payload = jnp.concatenate(cols, axis=1)  # (N, 16)

    grid = jnp.zeros((num_cells * k + 1, WIDTH), cfg.dtype)
    grid = grid.at[slot].set(payload, mode="drop", unique_indices=True)
    nx, ny, nz = cfg.grid_size
    return SlotGrid(
        data=grid[:-1].T.reshape(WIDTH, k, nx, ny, nz),
        slot_of=slot,
        overflow=in_grid & (rank >= k),
    )


def gather_per_particle(values: jnp.ndarray, slots: SlotGrid) -> jnp.ndarray:
    """Read per-slot values back into per-particle (cell-sorted) order.

    `values` is (..., K, nx, ny, nz); returns (N, ...). Overflow/inactive
    particles read zeros.
    """
    lead = values.shape[:-4]
    kn = values.shape[-4] * values.shape[-1] * values.shape[-2] * values.shape[-3]
    flat = values.reshape(*lead, kn)
    flat = jnp.concatenate(
        [flat, jnp.zeros((*lead, 1), flat.dtype)], axis=-1
    )
    idx = jnp.minimum(slots.slot_of, kn)
    out = flat[..., idx]  # (..., N)
    return jnp.moveaxis(out, -1, 0) if lead else out


# The 27 cell-relative offsets shared by every dense neighborhood pass.
NEIGHBOR_OFFSETS = [
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
]


def shifted(arr: jnp.ndarray, off, cfg: SimConfig) -> jnp.ndarray:
    """Cells' view of neighbor cell ``c + off``: same-shaped array whose entry
    at c is ``arr[..., c + off]``, zero-padded at the domain boundary
    (out-of-bounds cells hold no particles). Grid dims are the LAST three."""
    nx, ny, nz = cfg.grid_size
    pads = [(0, 0)] * (arr.ndim - 3) + [(1, 1), (1, 1), (1, 1)]
    p = jnp.pad(arr, pads)
    ox, oy, oz = off
    return p[
        ...,
        1 + ox : 1 + ox + nx,
        1 + oy : 1 + oy + ny,
        1 + oz : 1 + oz + nz,
    ]
