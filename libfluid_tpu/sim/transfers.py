"""Particle<->grid transfers (P2G / G2P) for PIC, FLIP and APIC.

Replaces the reference's ``_transfer_to_grid*`` / ``_transfer_from_grid*``
(``simulation.cpp:293-560``). The reference gathers over each cell's 3x3x3
particle neighborhood per face; here each particle *scatters* its 8 trilinear
(hat-kernel, ``simulation.cpp:207-213``) contributions per face array with a
weight accumulator, and faces normalize by total weight — the identical
weighted average, expressed as batched scatter-adds that XLA lowers to sorted
segment reductions, and that are differentiable by construction
(scatter-add transposes to gather).

Weights are always computed in cell units. (The reference's APIC P2G evaluates
the kernel on *world* offsets, ``simulation.cpp:371-375`` — equivalent only
when cell_size == 1; the normalized form here is the intended one.)
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from libfluid_tpu import grids
from libfluid_tpu.config import SimConfig, TransferScheme

_WEIGHT_EPS = 1e-6  # ref simulation.cpp:327 "magic number"

_OFFSETS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _face_world_shift(cfg: SimConfig, axis: int) -> jnp.ndarray:
    """World offset of face (i,j,k) of `axis` from offset + h*(i,j,k)."""
    shift = [0.5, 0.5, 0.5]
    shift[axis] = 0.0
    return jnp.asarray(shift, cfg.dtype) * cfg.cell_size


def _p2g_axis(
    position: jnp.ndarray,
    value: jnp.ndarray,
    affine_row: jnp.ndarray | None,
    active: jnp.ndarray,
    cfg: SimConfig,
    axis: int,
):
    """Scatter one velocity component to its face array; returns the
    UNNORMALIZED (momentum, weight) face arrays."""
    nx, ny, nz = cfg.grid_size
    shape = [nx, ny, nz]
    shape[axis] += 1
    dims = jnp.asarray(shape, jnp.int32)

    coords = grids.face_index_coords(position, cfg, axis)
    base = jnp.floor(coords).astype(jnp.int32)
    frac = coords - base

    num = jnp.zeros(tuple(shape), cfg.dtype).reshape(-1)
    den = jnp.zeros(tuple(shape), cfg.dtype).reshape(-1)
    world_base = (
        jnp.asarray(cfg.grid_offset, cfg.dtype)
        + _face_world_shift(cfg, axis)
    )

    for off in _OFFSETS:
        offv = jnp.asarray(off, jnp.int32)
        idx = base + offv
        w = jnp.prod(
            jnp.where(jnp.asarray(off, bool), frac, 1.0 - frac), axis=-1
        )
        inb = jnp.all((idx >= 0) & (idx < dims), axis=-1) & active
        w = jnp.where(inb, w, 0.0)
        if affine_row is not None:
            face_pos = world_base + idx.astype(cfg.dtype) * cfg.cell_size
            val = value + jnp.sum(affine_row * (face_pos - position), axis=-1)
        else:
            val = value
        flat = (idx[..., 0] * shape[1] + idx[..., 1]) * shape[2] + idx[..., 2]
        # Masked contributions are routed OUT of bounds and dropped, not
        # clipped to a shared valid address: inactive particles all sit at the
        # same position, and millions of zero-weight duplicates on one scatter
        # address serialize the whole scatter.
        flat = jnp.where(inb, flat, num.shape[0])
        num = num.at[flat].add(w * val, mode="drop")
        den = den.at[flat].add(w, mode="drop")

    return num.reshape(tuple(shape)), den.reshape(tuple(shape))


def _normalize(num, den):
    return jnp.where(
        den > _WEIGHT_EPS, num / jnp.maximum(den, _WEIGHT_EPS), 0.0
    )


def p2g(
    position: jnp.ndarray,
    velocity: jnp.ndarray,
    affine: jnp.ndarray,
    active: jnp.ndarray,
    cfg: SimConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Particle-to-grid transfer of momentum; returns (u, v, w) face arrays.

    For PIC/FLIP pass ``affine=None``-like zeros and the APIC term vanishes;
    for APIC the affine rows add the reference's ``dot(c, face - pos)`` term
    (``simulation.cpp:376-385``).
    """
    use_affine = cfg.scheme == TransferScheme.APIC
    out = []
    for axis in range(3):
        num, den = _p2g_axis(
            position,
            velocity[:, axis],
            affine[:, axis, :] if use_affine else None,
            active,
            cfg,
            axis,
        )
        out.append(_normalize(num, den))
    return tuple(out)


def _cell_offsets(axis: int):
    """The 18 face offsets relative to a particle's CELL index: along the face
    axis the staggered base equals the cell index (offsets {0,1}); along the
    other two axes the base is cell or cell-1 (offsets {-1,0,1})."""
    ranges = [(-1, 0, 1)] * 3
    ranges[axis] = (0, 1)
    return [
        (dx, dy, dz) for dx in ranges[0] for dy in ranges[1] for dz in ranges[2]
    ]


def _stacked_shifts(arr: jnp.ndarray, offsets, axis: int) -> jnp.ndarray:
    """(len(offsets), num_cells) table: row t holds arr[cell + offsets[t]]
    with zero padding outside the face array (out-of-bounds face samples
    contribute 0, like the reference's boundary clamp ``mac_grid.cpp:51-112``).
    Static slices only — no gather. Stacking on a new MAJOR axis keeps the
    grid dims minor; the single (64, C) -> (C, 64) transpose happens once,
    downstream."""
    pads = [(1, 1)] * 3
    pads[axis] = (0, 0)  # face-axis offsets {0,1} are always in bounds
    padded = jnp.pad(arr, pads)
    nx, ny, nz = [arr.shape[d] - (1 if d == axis else 0) for d in range(3)]
    cols = []
    for off in offsets:
        start = [off[d] + (0 if d == axis else 1) for d in range(3)]
        cols.append(
            jax.lax.dynamic_slice(padded, start, (nx, ny, nz))
        )
    return jnp.stack(cols, axis=0).reshape(len(offsets), nx * ny * nz)


def _face_axes_of_offset(d):
    """Axes whose staggered support includes cell-relative face offset d:
    along the face axis the hat reaches faces {cell, cell+1} (offsets {0,1}),
    along the other two axes {cell-1, cell, cell+1}. So axis a participates
    iff d[a] != -1."""
    return [a for a in range(3) if d[a] != -1]


def _add_shifted_face(acc: jnp.ndarray, ctr: jnp.ndarray, d, axis: int) -> jnp.ndarray:
    """acc[f] += ctr[c] for f = c + d, cropping f outside the face array.
    Along `axis` the face array has one extra layer and d in {0,1} is always
    in bounds; along the other axes d in {-1,0,1} crops one boundary layer."""
    acc_sl, ctr_sl = [], []
    for dim in range(3):
        n = ctr.shape[dim]
        if dim == axis:
            acc_sl.append(slice(d[dim], n + d[dim]))
            ctr_sl.append(slice(None))
        elif d[dim] == -1:
            acc_sl.append(slice(0, n - 1))
            ctr_sl.append(slice(1, n))
        elif d[dim] == 0:
            acc_sl.append(slice(None))
            ctr_sl.append(slice(None))
        else:
            acc_sl.append(slice(1, n))
            ctr_sl.append(slice(0, n - 1))
    return acc.at[tuple(acc_sl)].add(ctr[tuple(ctr_sl)])


def p2g_slots(
    slot_grid,
    position: jnp.ndarray,
    velocity: jnp.ndarray,
    affine: jnp.ndarray,
    active: jnp.ndarray,
    cfg: SimConfig,
    overflow_start=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Dense particle-to-grid transfer from the cell-slot grid — EXACT.

    Same weighted average as :func:`p2g` (reference ``simulation.cpp:293-412``)
    but with the scatter turned inside out: every face f = c + d accumulates
    the kernel-weighted momentum of cell c's K slots for the 18 cell-relative
    offsets d in its staggered support, as statically shifted dense adds — no
    scatter at all (:func:`_p2g_slots_jnp`, one fused XLA pass per
    (offset, axis) pair).

    Particles past the per-cell slot capacity ("overflow", rank >= K —
    transient compression in splashes) are NOT dropped: up to
    ``cfg.p2g_overflow_capacity`` of them are compacted into a fixed buffer
    and scatter-added into the same unnormalized momentum/weight
    accumulators, matching the reference's uncapped per-cell lists. Past the
    compaction capacity, faces in hyper-compressed cells average their first
    K (+compacted) particles — a subsample-mean approximation (P2G is a
    weight-NORMALIZED average; truncation is estimator noise, not mass
    loss).

    `position/velocity/affine/active` are the CELL-SORTED particle arrays the
    slot grid was built from.
    """
    num, den = _p2g_slots_jnp(slot_grid.data, cfg)
    num, den = list(num), list(den)

    n = position.shape[0]
    cap = min(max(256, cfg.p2g_overflow_capacity), n)
    use_affine = cfg.scheme == TransferScheme.APIC
    if overflow_start is not None:
        # slotsort parks overflow rows contiguously at [n_kept, n_kept+n_ov):
        # the compaction is a static window, no nonzero scan needed
        idx = overflow_start + jnp.arange(cap, dtype=jnp.int32)
        idx = jnp.where(
            slot_grid.overflow[jnp.minimum(idx, n - 1)] & (idx < n), idx, n
        )
    else:
        idx = jnp.nonzero(slot_grid.overflow, size=cap, fill_value=n)[0]
    ok = idx < n
    safe = jnp.minimum(idx, n - 1)
    pos_o = position[safe]
    vel_o = velocity[safe]
    aff_o = affine[safe] if use_affine else None
    act_o = ok & active[safe]
    for axis in range(3):
        n_o, d_o = _p2g_axis(
            pos_o,
            vel_o[:, axis],
            aff_o[:, axis, :] if use_affine else None,
            act_o,
            cfg,
            axis,
        )
        num[axis] = num[axis] + n_o
        den[axis] = den[axis] + d_o

    return tuple(_normalize(num[a], den[a]) for a in range(3))


def _p2g_slots_jnp(data, cfg: SimConfig):
    """Unnormalized (num[3], den[3]) face accumulators from the slot grid:
    one fused XLA pass per (offset, axis) pair."""
    from libfluid_tpu.sim import slots as slots_mod

    slot_grid = slots_mod.SlotGrid(data=data, slot_of=None, overflow=None)
    nx, ny, nz = cfg.grid_size
    h = cfg.cell_size
    use_affine = cfg.scheme == TransferScheme.APIC

    pos = slot_grid.position  # (3, K, nx, ny, nz)
    mask = slot_grid.mask  # (K, nx, ny, nz)
    vel = slot_grid.velocity

    # per-slot float face coordinates per axis: (p - offset)/h
    gpos = (
        pos - jnp.asarray(cfg.grid_offset, cfg.dtype).reshape(3, 1, 1, 1, 1)
    ) / h

    cell_iota = [
        jax.lax.broadcasted_iota(jnp.int32, (1, nx, ny, nz), 1 + dim)
        for dim in range(3)
    ]

    shapes = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]
    num = [jnp.zeros(s, cfg.dtype) for s in shapes]
    den = [jnp.zeros(s, cfg.dtype) for s in shapes]

    for d in slots_mod.NEIGHBOR_OFFSETS:
        for axis in _face_axes_of_offset(d):
            shift = [0.5, 0.5, 0.5]
            shift[axis] = 0.0
            # hat weight per slot against face f = c + d
            w = mask
            for dim in range(3):
                t = (
                    gpos[dim]
                    - jnp.asarray(shift[dim], cfg.dtype)
                    - (cell_iota[dim] + d[dim]).astype(cfg.dtype)
                )
                w = w * jnp.maximum(1.0 - jnp.abs(t), 0.0)
            val = vel[axis]
            if use_affine:
                # + affine_row . (x_face - x_p)  (ref simulation.cpp:376-385)
                arow = slot_grid.affine_row(axis)
                for dim in range(3):
                    face_dim = (
                        (cell_iota[dim] + d[dim]).astype(cfg.dtype)
                        + jnp.asarray(shift[dim], cfg.dtype)
                    ) * h + jnp.asarray(cfg.grid_offset[dim], cfg.dtype)
                    val = val + arow[dim] * (face_dim - pos[dim])
            num[axis] = _add_shifted_face(num[axis], jnp.sum(w * val, axis=0), d, axis)
            den[axis] = _add_shifted_face(den[axis], jnp.sum(w, axis=0), d, axis)

    return tuple(num), tuple(den)


def _p2g_hi_plane(data, cfg: SimConfig, axis: int):
    """The far boundary face plane (f_axis = n_axis), fed only by the last
    cell slab (b_axis = n_axis - 1) over the 9 transverse offsets. Completes
    the slab-tiled substep's lo-face arrays. Returns unnormalized (num, den)."""
    use_affine = cfg.scheme == TransferScheme.APIC
    k = data.shape[1]
    h = cfg.cell_size
    na = cfg.grid_size[axis]
    taxes = [d for d in range(3) if d != axis]

    def slab(arr):  # (..., nx, ny, nz) -> (..., nt1, nt2) at face-axis n-1
        # slice FIRST: moveaxis on the full array materializes a transpose
        # of the whole payload (1.6 GB at 128^3); on the 1-plane slab it is
        # a trivial reshape
        idx = [slice(None)] * arr.ndim
        idx[arr.ndim - 3 + axis] = slice(na - 1, na)
        a = arr[tuple(idx)]
        return jnp.moveaxis(a, axis - 3, -3)[..., 0, :, :]

    pos = slab(data[0:3])  # (3, K, nt1, nt2)
    mask = slab(data[3])
    vel_a = slab(data[4 + axis])
    if use_affine:
        aff = slab(data[7 + 3 * axis : 10 + 3 * axis])  # (3, K, nt1, nt2)

    nt1, nt2 = mask.shape[-2:]
    off = [float(o) for o in cfg.grid_offset]
    gpos = [(pos[d] - off[d]) / h for d in range(3)]
    c1 = jax.lax.broadcasted_iota(jnp.int32, (1, nt1, nt2), 1).astype(cfg.dtype)
    c2 = jax.lax.broadcasted_iota(jnp.int32, (1, nt1, nt2), 2).astype(cfg.dtype)
    ct = {taxes[0]: c1, taxes[1]: c2}

    def shift2(arr, d1, d2):
        p = jnp.pad(arr, [(0, 0)] * (arr.ndim - 2) + [(1, 1), (1, 1)])
        return p[..., 1 - d1 : 1 - d1 + nt1, 1 - d2 : 1 - d2 + nt2]

    num = jnp.zeros((nt1, nt2), cfg.dtype)
    den = jnp.zeros((nt1, nt2), cfg.dtype)
    for d1 in (-1, 0, 1):
        for d2 in (-1, 0, 1):
            w = shift2(mask, d1, d2)
            ta = shift2(gpos[axis], d1, d2) - na
            w = w * jnp.maximum(1.0 - jnp.abs(ta), 0.0)
            for t in taxes:
                tt = shift2(gpos[t], d1, d2) - (ct[t] + 0.5)
                w = w * jnp.maximum(1.0 - jnp.abs(tt), 0.0)
            val = shift2(vel_a, d1, d2)
            if use_affine:
                for jdim in range(3):
                    if jdim == axis:
                        fp = na * h + off[jdim]
                    else:
                        fp = (ct[jdim] + 0.5) * h + off[jdim]
                    val = val + shift2(aff[jdim], d1, d2) * (
                        fp - shift2(pos[jdim], d1, d2)
                    )
            num = num + jnp.sum(w * val, axis=0)
            den = den + jnp.sum(w, axis=0)
    return num, den


def g2p_pic(
    grid: grids.MacGrid, position: jnp.ndarray, cfg: SimConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """PIC/APIC grid-to-particle: interpolated velocity and the APIC affine
    matrix (rows = gradients of each component). Reference
    ``simulation.cpp:447-560``.

    Instead of 8 per-element gathers per axis, ONE (C, 64) table holds the
    statically-shifted face arrays of all 3 axes' 18 cell-relative offsets
    (54 columns, zero-padded to 64 for aligned 256-byte rows) indexed by CELL
    id, and ONE row gather per particle fetches all 54 samples;
    weights/gradients are evaluated elementwise (zero for offsets outside
    the hat support).
    """
    table = build_g2p_table(grid, cfg)
    return g2p_from_table(table, position, cfg)


def build_g2p_table(grid: grids.MacGrid, cfg: SimConfig) -> jnp.ndarray:
    """(C, 64) per-cell sample table: the 54 statically-shifted face samples
    of all 3 axes' 18 cell-relative offsets, zero-padded to 64 columns."""
    tables = [
        _stacked_shifts(arr, _cell_offsets(axis), axis)
        for axis, arr in enumerate((grid.u, grid.v, grid.w))
    ]  # 3 x (18, C)
    num_cells = tables[0].shape[1]
    table = jnp.concatenate(
        tables + [jnp.zeros((64 - 54, num_cells), cfg.dtype)], axis=0
    )  # (64, C) — grid dim minor
    return table.T  # (C, 64); rows 256B-aligned


def _g2p_weights_major(samples_T, position, cell3c, cfg: SimConfig):
    """Weight/gradient evaluation in (18, N) layout — particles minor.

    Every temp is (k, N) with the huge axis minor. The hat-weight is separable,
    w = wx (x) wy (x) wz, so the per-space-axis factors (2 or 3 rows each)
    are built once and combined per sample; the gradient substitutes the
    derivative factor one axis at a time (reference ``_grad_kernel``,
    ``simulation.cpp:215-224``), zeroed outside the support so far offsets
    contribute exactly 0. Support is the HALF-OPEN [-1, 1): the reference
    samples offsets {0,1} from floor(coords), so d = frac - off hits -1
    (kink included one-sidedly) but never +1 — particles exactly on faces
    reproduce bit-for-bit."""
    n = position.shape[0]
    h = cfg.cell_size
    posT = position.T  # (3, N)
    baseT = cell3c.T.astype(cfg.dtype)  # (3, N)
    off = jnp.asarray(cfg.grid_offset, cfg.dtype)

    vals = []
    rows = []
    for axis in range(3):
        # float face-index coords of each particle, per space axis j: (3, N)
        shift = jnp.full((3, 1), 0.5, cfg.dtype).at[axis].set(0.0)
        coordT = (posT - off[:, None]) / h - shift
        # per-space-axis factor rows: face offsets {0,1} along `axis`,
        # {-1,0,1} along the other two
        nfac = []  # hat value rows, shape (k_j, N)
        sfac = []  # derivative rows
        for j in range(3):
            offs = (0.0, 1.0) if j == axis else (-1.0, 0.0, 1.0)
            d = coordT[j][None, :] - (
                baseT[j][None, :] + jnp.asarray(offs, cfg.dtype)[:, None]
            )
            nfac.append(jnp.maximum(1.0 - jnp.abs(d), 0.0))
            sfac.append(
                jnp.where(
                    (d >= -1.0) & (d < 1.0),
                    jnp.where(d > 0.0, -1.0, 1.0),
                    0.0,
                )
                / h
            )
        sA = samples_T[18 * axis : 18 * (axis + 1)]  # (18, N)
        kx, ky, kz = (f.shape[0] for f in nfac)

        def combine(fx, fy, fz):
            # (kx,ky,kz,N) product flattened to (18, N); the offset order
            # matches _cell_offsets (x outer, z inner)
            w = (
                fx[:, None, None, :]
                * fy[None, :, None, :]
                * fz[None, None, :, :]
            )
            return w.reshape(kx * ky * kz, n)

        w18 = combine(nfac[0], nfac[1], nfac[2])
        vals.append(jnp.sum(w18 * sA, axis=0))
        g0 = combine(sfac[0], nfac[1], nfac[2])
        g1 = combine(nfac[0], sfac[1], nfac[2])
        g2 = combine(nfac[0], nfac[1], sfac[2])
        rows.append(
            jnp.stack(
                [
                    jnp.sum(g0 * sA, axis=0),
                    jnp.sum(g1 * sA, axis=0),
                    jnp.sum(g2 * sA, axis=0),
                ]
            )
        )  # (3, N)
    vel = jnp.stack(vals).T  # (N, 3)
    affine = jnp.stack(rows).transpose(2, 0, 1)  # (N, 3, 3): rows = axes
    return vel, affine


def g2p_from_table(
    table: jnp.ndarray, position: jnp.ndarray, cfg: SimConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-particle velocity + APIC affine from a prebuilt sample table:
    ONE (N, 64) row gather, then the weights in (18, N) layout."""
    cell3 = grids.cell_index_of(position, cfg)
    dims = jnp.asarray(cfg.grid_size, jnp.int32)
    cell3c = jnp.clip(cell3, 0, dims - 1)
    cell_flat = grids.flat_cell_index(cell3c, cfg)  # C order = table row order
    samples_all = table[cell_flat]  # (N, 64)
    return _g2p_weights_major(samples_all.T, position, cell3c, cfg)


def g2p_flip(
    new_grid: grids.MacGrid,
    old_grid: grids.MacGrid,
    position: jnp.ndarray,
    velocity: jnp.ndarray,
    cfg: SimConfig,
) -> jnp.ndarray:
    """FLIP blend: v_new_grid + blend * (v_particle - v_old_grid)
    (reference ``_transfer_from_grid_flip``, ``simulation.cpp:464-506``)."""
    v_new = grids.velocity_at(new_grid, position, cfg)
    v_old = grids.velocity_at(old_grid, position, cfg)
    return v_new + (velocity - v_old) * cfg.blending_factor
