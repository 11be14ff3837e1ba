"""Marching cubes as a batched, differentiable table-lookup kernel.

Reference ``mesher::_marching_cubes`` (``mesher.cpp:400-515``): serial sweep
with rolling per-layer edge-midpoint caches for vertex dedup. This version
drops the inherently serial dedup structure and emits an indexed *triangle
soup* with fixed capacity:

- corner sampling, case construction (bit i set iff value < 0,
  ``mesher.cpp:416``), edge interpolation (t = v1/(v1-v2),
  ``mesher.cpp:378-392``) are batched over all cells of a z-slab,
- a ``lax.scan`` over slabs compacts valid triangles into a static
  (max_triangles, 3, 3) buffer by rank-scatter (cumsum of the valid mask),
- vertex positions are differentiable w.r.t. the SDF node values through the
  edge interpolation (the discrete topology is piecewise constant — the
  correct marching-cubes gradient under the implicit function theorem).

Vertex dedup for watertight OBJ export is a host-side post-process
(:mod:`libfluid_tpu.io.obj`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from libfluid_tpu.config import MesherConfig
from libfluid_tpu.mesher import tables
from libfluid_tpu.mesher.surface import sample_surface

MAX_TRIS_PER_CELL = 5


class MeshBuffers(NamedTuple):
    """Fixed-capacity triangle soup: `vertices[i]` is a (3, 3) triangle
    (rows = vertices, CCW as in the reference tables); entries past `count`
    are garbage."""

    vertices: jnp.ndarray  # (max_triangles, 3, 3)
    count: jnp.ndarray  # () int32

    @property
    def valid(self) -> jnp.ndarray:
        return jnp.arange(self.vertices.shape[0]) < self.count


# cells per z-block: bounds the block temporaries (~a dozen (12, Cb) f32
# arrays) while keeping the scan short; a block reads its corners with
# pure slices instead of 8 scalar-index gathers per corner per z-slab
_BLOCK_CELLS = 1 << 20


def marching_cubes(sdf: jnp.ndarray, cfg: MesherConfig) -> MeshBuffers:
    """Extract the zero level set of `sdf` sampled on (nx+1, ny+1, nz+1) nodes."""
    nx, ny, nz = cfg.grid_size
    h = cfg.cell_size
    off = jnp.asarray(cfg.grid_offset, sdf.dtype)
    tri_table = jnp.asarray(tables.TRI_TABLE)  # (256, 16)
    ntri_table = jnp.asarray(tables.NTRI_TABLE)  # (256,) tris per case
    ec_a = tables.EDGE_CORNERS[:, 0]  # host-side (12,)
    ec_b = tables.EDGE_CORNERS[:, 1]

    zb = max(1, min(nz, _BLOCK_CELLS // (nx * ny)))
    while nz % zb:
        zb -= 1
    cb = nx * ny * zb

    # per-edge endpoint cell-relative offsets (host constants)
    co = tables.CORNER_OFFSETS  # (8, 3) ints
    ax = jnp.asarray([co[c][0] for c in ec_a], sdf.dtype).reshape(12, 1)
    ay = jnp.asarray([co[c][1] for c in ec_a], sdf.dtype).reshape(12, 1)
    az = jnp.asarray([co[c][2] for c in ec_a], sdf.dtype).reshape(12, 1)
    dx = jnp.asarray([co[c][0] for c in ec_b], sdf.dtype).reshape(12, 1) - ax
    dy = jnp.asarray([co[c][1] for c in ec_b], sdf.dtype).reshape(12, 1) - ay
    dz = jnp.asarray([co[c][2] for c in ec_b], sdf.dtype).reshape(12, 1) - az

    # block-local cell coordinates, (cb,) each, order (x, y, dz) row-major
    gx = jax.lax.broadcasted_iota(jnp.int32, (nx, ny, zb), 0).reshape(-1)
    gy = jax.lax.broadcasted_iota(jnp.int32, (nx, ny, zb), 1).reshape(-1)
    gz = jax.lax.broadcasted_iota(jnp.int32, (nx, ny, zb), 2).reshape(-1)

    def block(carry, z0):
        buf, count = carry
        # corner values via pure SLICES: (8, cb), corners x-fastest bit order
        corners = []
        for ci in range(8):
            ox, oy, oz = (int(v) for v in tables.CORNER_OFFSETS[ci])
            sl = jax.lax.dynamic_slice(
                sdf, (ox, oy, z0 + oz), (nx, ny, zb)
            )
            corners.append(sl.reshape(-1))
        v = jnp.stack(corners, axis=0)  # (8, cb)

        case = jnp.sum(
            (v < 0.0).astype(jnp.int32)
            * (1 << jnp.arange(8, dtype=jnp.int32))[:, None],
            axis=0,
        )  # (cb,)

        # interpolated point on each of the 12 edges, component-major (12, cb)
        va = v[jnp.asarray(ec_a)]
        vb = v[jnp.asarray(ec_b)]
        denom = va - vb
        t = va / jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
        cx = gx.astype(sdf.dtype)[None]
        cy = gy.astype(sdf.dtype)[None]
        cz = (gz + z0).astype(sdf.dtype)[None]
        ex = off[0] + h * (cx + ax + dx * t)
        ey = off[1] + h * (cy + ay + dy * t)
        ez = off[2] + h * (cz + az + dz * t)

        # validity from the per-case triangle COUNT (tiny 256-table): the
        # full (cb, 5, 3) edge-id expansion is only ever needed for the ~1%
        # of rows that survive, so edge ids and vertex values are gathered
        # AFTER compaction at cap size, not before at cb*5 size
        ntris = ntri_table[case]  # (cb,)
        k5 = jnp.arange(MAX_TRIS_PER_CELL, dtype=jnp.int32)
        tvalid = (k5[None, :] < ntris[:, None]).reshape(-1)

        cap = buf.shape[0]
        nrows = tvalid.shape[0]
        idx = jnp.nonzero(tvalid, size=cap, fill_value=nrows)[0]
        ok = idx < nrows
        safe_i = jnp.minimum(idx, nrows - 1)
        c_i = safe_i // MAX_TRIS_PER_CELL  # (cap,) source cell
        k_i = safe_i % MAX_TRIS_PER_CELL  # tri slot within the cell
        # edge ids, with the last two swapped — with this module's x-fastest
        # corner layout the raw table winds inward; the swap makes normals
        # point outward (along +grad(sdf)), which the renderer and OBJ
        # export assume
        cols = 3 * k_i[:, None] + jnp.asarray([0, 2, 1], jnp.int32)[None]
        edges = jnp.maximum(tri_table[case[c_i][:, None], cols], 0)  # (cap, 3)
        vx = ex[edges, c_i[:, None]]  # (cap, 3)
        vy = ey[edges, c_i[:, None]]
        vz = ez[edges, c_i[:, None]]
        rows = jnp.stack([vx, vy, vz], axis=-1)  # (cap, 3, 3)

        dest = jnp.where(ok, count + jnp.arange(cap, dtype=jnp.int32), cap)
        buf = buf.at[dest].set(rows, mode="drop")
        count = count + jnp.sum(tvalid.astype(jnp.int32))
        return (buf, count), None

    buf0 = jnp.zeros((cfg.max_triangles, 3, 3), sdf.dtype)
    (buf, count), _ = jax.lax.scan(
        block, (buf0, jnp.int32(0)), jnp.arange(0, nz, zb, dtype=jnp.int32)
    )
    return MeshBuffers(vertices=buf, count=jnp.minimum(count, cfg.max_triangles))


def generate_mesh(
    position: jnp.ndarray,
    active: jnp.ndarray,
    cfg: MesherConfig,
    particle_radius: float | None = None,
) -> MeshBuffers:
    """particles -> SDF -> triangles (``mesher::generate_mesh``, ``mesher.cpp:320``)."""
    sdf = sample_surface(position, active, cfg, particle_radius)
    return marching_cubes(sdf, cfg)
