"""Mesh voxelization: triangle mesh -> solid-cell masks on the sim grid.

Replaces the reference's ``voxelizer`` (``voxelizer.h/.cpp``) and ``obstacle``
(``obstacle.cpp:9-29``). Semantics match:

- The voxel grid is aligned to the sim grid (cells at ref offset + i*h) and
  covers the mesh bounding box padded by one cell on every side
  (``voxelizer.cpp:20-36``), so the corner cell is always outside the mesh.
- *Surface* cells are those whose cell-sized AABB overlaps any triangle by
  the Akenine-Möller SAT test (``voxelizer.cpp:54-80``).
- *Exterior* cells are found by a 6-connected flood fill from the corner
  (``voxelizer.cpp:82-126``); everything else that is not surface is
  *interior*. An obstacle contributes its interior cells to the sim's solid
  mask (``obstacle.cpp:20-28``).

Formulation: the reference's per-triangle serial scan over candidate
cells becomes a vmap over (triangle x static candidate block) with a
scatter-OR, and the stack-based flood fill becomes a ``lax.while_loop`` of
6-neighbor dilations masked by ~surface — order-free stencils instead of a
sequential DFS. Voxelization is a setup-time operation (the reference runs it
in the obstacle constructor / Maya node), so host-side bbox planning with
concrete NumPy inputs is fine; the heavy part (SAT over T x K^3 blocks,
dilation sweeps) runs jitted.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from libfluid_tpu.config import SimConfig
from libfluid_tpu.math import intersection as isect


class VoxelGrid(NamedTuple):
    """A voxelization result on a local grid aligned to a reference grid."""

    surface: jnp.ndarray  # (nx, ny, nz) bool
    exterior: jnp.ndarray  # (nx, ny, nz) bool
    interior: jnp.ndarray  # (nx, ny, nz) bool
    offset: Tuple[int, int, int]  # local cell (0,0,0) in reference-grid cells
    cell_size: float


def _triangles(positions, indices) -> np.ndarray:
    pos = np.asarray(positions, np.float64)
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    return pos[idx]  # (T, 3, 3)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _surface_mask(args, grid_size, block):
    """Scatter-OR the SAT test over every (triangle, candidate-cell) pair.

    args = (tri (T,3,3) cell-space vertices, base (T,3) int32 block origins).
    Cell c has center c + 0.5 and half-extent 0.5 in cell space.
    """
    tri, base = args
    kx, ky, kz = block
    offs = jnp.stack(
        jnp.meshgrid(
            jnp.arange(kx, dtype=jnp.int32),
            jnp.arange(ky, dtype=jnp.int32),
            jnp.arange(kz, dtype=jnp.int32),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 3)  # (K, 3)
    half = jnp.asarray([0.5, 0.5, 0.5], tri.dtype)

    def per_triangle(t, b):
        cells = b[None, :] + offs  # (K, 3)
        centers = cells.astype(tri.dtype) + 0.5
        hit = isect.aabb_triangle(centers, half[None, :], t[0], t[1], t[2])
        return cells, hit

    cells, hit = jax.vmap(per_triangle)(tri, base)  # (T, K, 3), (T, K)
    cells = cells.reshape(-1, 3)
    hit = hit.reshape(-1)
    dims = jnp.asarray(grid_size, jnp.int32)
    inb = jnp.all((cells >= 0) & (cells < dims), axis=-1)
    flat = (
        cells[:, 0] * (grid_size[1] * grid_size[2])
        + cells[:, 1] * grid_size[2]
        + cells[:, 2]
    )
    flat = jnp.where(inb & hit, flat, grid_size[0] * grid_size[1] * grid_size[2])
    occ = jnp.zeros((grid_size[0] * grid_size[1] * grid_size[2] + 1,), bool)
    occ = occ.at[flat].set(True, mode="drop")
    return occ[:-1].reshape(grid_size)


@jax.jit
def mark_exterior(surface: jnp.ndarray) -> jnp.ndarray:
    """6-connected flood fill from the (0,0,0) corner through ~surface cells.

    The reference's explicit DFS stack (``voxelizer.cpp:82-126``) becomes a
    fixpoint of 6-neighbor dilations — each sweep is a shardable stencil; the
    loop exits when a sweep changes nothing.
    """
    seed = jnp.zeros_like(surface)
    seed = seed.at[0, 0, 0].set(~surface[0, 0, 0])

    def dilate(e):
        grown = e
        grown = grown.at[1:].max(e[:-1])
        grown = grown.at[:-1].max(e[1:])
        grown = grown.at[:, 1:].max(e[:, :-1])
        grown = grown.at[:, :-1].max(e[:, 1:])
        grown = grown.at[:, :, 1:].max(e[:, :, :-1])
        grown = grown.at[:, :, :-1].max(e[:, :, 1:])
        return grown & ~surface

    def cond(carry):
        _, changed = carry
        return changed

    def body(carry):
        e, _ = carry
        # dilating k times per sweep amortizes the while_loop overhead
        new = e
        for _ in range(8):
            new = dilate(new)
        return new, jnp.any(new != e)

    ext, _ = jax.lax.while_loop(cond, body, (seed, jnp.bool_(True)))
    return ext


def voxelize(
    positions,
    indices,
    cell_size: float,
    ref_offset=(0.0, 0.0, 0.0),
) -> VoxelGrid:
    """Voxelize a mesh on a grid aligned to (ref_offset, cell_size).

    Mirrors ``resize_reposition_grid_constrained`` + ``voxelize_mesh_surface``
    + ``mark_exterior`` (``voxelizer.cpp:20-36,54-126``): the local grid spans
    the mesh bbox in reference-grid cell coordinates, padded by one cell.
    """
    tri = _triangles(positions, indices)
    if tri.shape[0] == 0:
        raise ValueError("cannot voxelize an empty mesh")
    ref_offset = np.asarray(ref_offset, np.float64)
    # cell-space vertices relative to the reference grid
    tri_c = (tri - ref_offset) / float(cell_size)

    lo = np.floor(tri_c.min(axis=(0, 1))).astype(np.int64) - 1
    hi = np.ceil(tri_c.max(axis=(0, 1))).astype(np.int64) + 1
    grid_size = tuple(int(x) for x in (hi - lo))

    # static candidate block: per-triangle cell extent, maxed over the mesh
    t_lo = np.floor(tri_c.min(axis=1)).astype(np.int64)
    t_hi = np.floor(tri_c.max(axis=1)).astype(np.int64)
    block = tuple(int(x) for x in (t_hi - t_lo).max(axis=0) + 1)

    tri_local = jnp.asarray(tri_c - lo, jnp.float32)
    base = jnp.asarray(t_lo - lo, jnp.int32)
    surface = _surface_mask((tri_local, base), grid_size, block)
    exterior = mark_exterior(surface)
    interior = ~surface & ~exterior
    return VoxelGrid(
        surface=surface,
        exterior=exterior,
        interior=interior,
        offset=tuple(int(x) for x in lo),
        cell_size=float(cell_size),
    )


def embed(mask: jnp.ndarray, offset, grid_size) -> jnp.ndarray:
    """Place a local-grid mask into the reference grid, cropping out-of-range
    cells (``get_overlapping_cell_range``, ``voxelizer.cpp:38-52``)."""
    out = np.zeros(grid_size, bool)
    m = np.asarray(mask)
    src_lo = [max(0, -offset[a]) for a in range(3)]
    src_hi = [min(m.shape[a], grid_size[a] - offset[a]) for a in range(3)]
    if any(src_lo[a] >= src_hi[a] for a in range(3)):
        return jnp.asarray(out)
    dst_lo = [src_lo[a] + offset[a] for a in range(3)]
    dst_hi = [src_hi[a] + offset[a] for a in range(3)]
    out[dst_lo[0]:dst_hi[0], dst_lo[1]:dst_hi[1], dst_lo[2]:dst_hi[2]] = m[
        src_lo[0]:src_hi[0], src_lo[1]:src_hi[1], src_lo[2]:src_hi[2]
    ]
    return jnp.asarray(out)


def obstacle_cells(positions, indices, cfg: SimConfig) -> jnp.ndarray:
    """Solid-cell mask for a mesh obstacle, aligned to the sim grid.

    The obstacle constructor (``obstacle.cpp:9-29``) voxelizes against the
    sim grid and contributes its *interior* cells. Compose with
    :func:`libfluid_tpu.sim.state.set_solid`; union multiple obstacles with
    ``|``.
    """
    vox = voxelize(positions, indices, cfg.cell_size, cfg.grid_offset)
    return embed(vox.interior, vox.offset, cfg.grid_size)
