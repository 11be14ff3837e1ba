"""Slab-tiled substep for grids too large for dense neighborhood structures.

At 256^3 (BASELINE config 5, the ``renders/tide.png`` hero scale) the dense
slot grid costs 16 x K x 16.7M x 4B = 12.9 GB and the G2P face table 4.3 GB —
past a 16 GB card's memory next to the particle SoA. This module runs the SAME
stage semantics as :func:`libfluid_tpu.sim.step.substep` but streams the
three neighborhood passes (P2G, position-correction springs, G2P) over
``slabs`` tiles along x (the major axis of the cell index, so every slab's
slot expansion reads contiguous windows of the rank-major sorted payload —
``slotsort.expand_range``). Each slab is expanded with one halo layer per
side; only interior faces/springs are accumulated, so overlapping
contributions are counted exactly once. P2G accumulates UNNORMALIZED
momentum/weight across slabs and normalizes once at the end — bit-equal in
exact arithmetic to the dense pass (equivalence-tested at small sizes).

The reference reaches this scale only notionally (no test or bench exists
above its interactive 50^3 default, ``testbed/main.cpp:39``); the slab loop
replaces nothing in the reference — it is the memory plan for config 5 on
a card too small for the dense slot grid.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from libfluid_tpu import grids
from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import collisions as collisions_mod
from libfluid_tpu.sim import correction as correction_mod
from libfluid_tpu.sim import extrapolation as extrapolation_mod
from libfluid_tpu.sim import jitterhash
from libfluid_tpu.sim import pressure as pressure_mod
from libfluid_tpu.sim import slots as slots_mod
from libfluid_tpu.sim import slotsort
from libfluid_tpu.sim import sources as sources_mod
from libfluid_tpu.sim import transfers
from libfluid_tpu.sim.slotsort import PAD, _pick_block
from libfluid_tpu.sim.state import SimState
from libfluid_tpu.sim.step import Diagnostics, _add_gravity, _advect

# Cells above which _g2p_tiled streams the sample table slab-by-slab instead
# of building it in one shot. Module-level so tests can lower it to force the
# tiled path on small grids (ADVICE r3: the 24x16x16 equivalence tests only
# exercised the one-shot branch).
_G2P_TILED_THRESHOLD = 1 << 21


def _slab_cfg(cfg: SimConfig, sx: int) -> SimConfig:
    """Static per-slab config: (sx+2) x-layers incl. halos, offset 0 along x
    (slab positions are shifted into local coords before the dense passes)."""
    return dataclasses.replace(
        cfg,
        grid_size=(sx + 2, cfg.ny, cfg.nz),
        grid_offset=(0.0, cfg.grid_offset[1], cfg.grid_offset[2]),
    )


def substep_tiled(
    state: SimState, cfg: SimConfig, dt, slabs: int
) -> Tuple[SimState, Diagnostics]:
    """One time step of size dt, neighborhood passes tiled over x-slabs.

    Stage semantics match :func:`libfluid_tpu.sim.step.substep` for ALL
    three transfer schemes. FLIP (``simulation.cpp:340-344,464-506``) keeps
    a dense copy of the post-P2G grid and exploits the linearity of
    interpolation: v = blend*v_p + interp(new - blend*old), so ONE combined
    sample table serves the blend (a second 4.3 GB table at 256^3 would
    not fit next to the first).
    """
    nx, ny, nz = cfg.grid_size
    assert nx % slabs == 0, "slabs must divide nx"
    sx = nx // slabs
    nynz = ny * nz
    k = cfg.max_neighbors_per_cell
    slab_c = (sx + 2) * nynz
    blk = _pick_block(slab_c) or slab_c
    use_affine = cfg.scheme == TransferScheme.APIC
    h = cfg.cell_size
    dt = jnp.asarray(dt, cfg.dtype)
    scfg = _slab_cfg(cfg, sx)

    # --- advection + collisions (elementwise; full arrays) ---
    old_position = state.position
    state = _advect(state, cfg, dt)
    if cfg.enable_collisions:
        pos = collisions_mod.resolve_collisions(
            old_position, state.position, state.solid, cfg
        )
        pos = jnp.where(state.active[:, None], pos, state.position)
        state = state._replace(position=pos)
    # --- sources: seed back to target density using the pre-sort occupancy,
    # then re-sort (mirrors step.substep's seed + re-bin; statically skipped
    # when no sources exist). Coercion already ran inside _advect. ---
    rs = slotsort.sort_rank_major(state, cfg, pad_cols=blk + 2 * PAD)
    if state.sources.cells.shape[0] > 0:
        state = sources_mod.seed_sources(
            rs.state, rs.counts.reshape(cfg.grid_size), cfg
        )
        rs = slotsort.sort_rank_major(state, cfg, pad_cols=blk + 2 * PAD)
    state = rs.state
    old_position = state.position
    n = state.position.shape[0]
    kc_full = cfg.num_cells * k
    slot_of = jnp.minimum(rs.key_sorted, kc_full)
    overflow = (rs.key_sorted >= kc_full) & (rs.key_sorted < kc_full + n)

    # pad ins/counts by one x-layer of cells on each side so every slab
    # (including the first/last) slices a full (sx+2)-layer halo window;
    # pad cells have count 0 (all-invalid) and edge-replicated insertion
    # positions (keeps the expansion deltas monotone)
    ins2 = jnp.pad(
        rs.ins.reshape(k, cfg.num_cells), ((0, 0), (nynz, nynz)), mode="edge"
    )
    cnt_p = jnp.pad(rs.counts, (nynz, nynz))
    rs_p = rs._replace(ins=ins2.reshape(-1), counts=cnt_p)
    pcfg = dataclasses.replace(cfg, grid_size=(nx + 2, ny, nz))

    kcor = min(cfg.correction_capacity, k)

    # one substep-wide jitter seed, derived EXACTLY like step.substep's
    # (split once at the correction stage): the coincident-pair jitter is a
    # hash of (seed, global cell, slot) so every slab — and the dense
    # path — evaluates the same field (ADVICE r4 high: per-slab key splits
    # broke dense<->tiled equivalence)
    key = state.key
    if cfg.enable_position_correction:
        key, sub = jax.random.split(key)
        jitter_seed = jitterhash.seed_from_key(sub)
    else:
        jitter_seed = jnp.int32(0)

    def expand_slab(s):
        c0 = s * sx * nynz  # padded coords: global layer s*sx - 1
        data = slotsort.expand_range(rs_p, pcfg, c0, slab_c, blk)
        data = data.reshape(16, k, sx + 2, ny, nz)
        # shift x into slab-local coords (local layer 0 = global s*sx - 1)
        off = (jnp.asarray(s, cfg.dtype) * sx - 1.0) * h + cfg.grid_offset[0]
        data = data.at[0].add(-off * data[3])  # only where mask = 1
        return data, off

    # --- pass 1: P2G accumulation + correction springs, slab by slab ---
    def slab_body(s, carry):
        nums, dens, springs_g = carry
        data, off = expand_slab(s)

        sg = slots_mod.SlotGrid(data=data, slot_of=None, overflow=None)
        num, den = transfers._p2g_slots_jnp(data, scfg)
        # interior faces only: u local [1, sx+1), v/w x-cells [1, sx+1)
        x0 = s * sx
        nums = (
            jax.lax.dynamic_update_slice(
                nums[0],
                jax.lax.dynamic_slice(nums[0], (x0, 0, 0), (sx, ny, nz))
                + num[0][1 : sx + 1],
                (x0, 0, 0),
            ),
            jax.lax.dynamic_update_slice(
                nums[1],
                jax.lax.dynamic_slice(nums[1], (x0, 0, 0), (sx, ny + 1, nz))
                + num[1][1 : sx + 1],
                (x0, 0, 0),
            ),
            jax.lax.dynamic_update_slice(
                nums[2],
                jax.lax.dynamic_slice(nums[2], (x0, 0, 0), (sx, ny, nz + 1))
                + num[2][1 : sx + 1],
                (x0, 0, 0),
            ),
        )
        dens = (
            jax.lax.dynamic_update_slice(
                dens[0],
                jax.lax.dynamic_slice(dens[0], (x0, 0, 0), (sx, ny, nz))
                + den[0][1 : sx + 1],
                (x0, 0, 0),
            ),
            jax.lax.dynamic_update_slice(
                dens[1],
                jax.lax.dynamic_slice(dens[1], (x0, 0, 0), (sx, ny + 1, nz))
                + den[1][1 : sx + 1],
                (x0, 0, 0),
            ),
            jax.lax.dynamic_update_slice(
                dens[2],
                jax.lax.dynamic_slice(dens[2], (x0, 0, 0), (sx, ny, nz + 1))
                + den[2][1 : sx + 1],
                (x0, 0, 0),
            ),
        )

        if cfg.enable_position_correction:
            re2 = cfg.cell_size * cfg.cell_size / 2.0
            origin = jnp.stack(
                [s * sx - 1, jnp.int32(0), jnp.int32(0)]
            )  # local plane 0 = global s*sx - 1
            spr = correction_mod._springs(
                data[0:3, :kcor], data[3, :kcor], jitter_seed, origin,
                re2, scfg,
            )  # (3, KC, sx+2, ny, nz)
            springs_g = jax.lax.dynamic_update_slice(
                springs_g, spr[:, :, 1 : sx + 1], (0, 0, x0, 0, 0)
            )
        return nums, dens, springs_g

    nums0 = (
        # u faces 0..nx-1 only: the final plane (x = nx) is appended from
        # the hi-plane pass after the loop
        jnp.zeros((nx, ny, nz), cfg.dtype),
        jnp.zeros((nx, ny + 1, nz), cfg.dtype),
        jnp.zeros((nx, ny, nz + 1), cfg.dtype),
    )
    dens0 = tuple(jnp.zeros_like(a) for a in nums0)
    springs0 = jnp.zeros((3, kcor, nx, ny, nz), cfg.dtype)

    # the last global u-face plane (x = nx) is fed only by the last cell
    # layer; fold it in by treating slab faces [1, sx+2) for the final slab.
    # Simpler: accumulate it from the dense hi-plane pass after the loop.
    nums, dens, springs_g = jax.lax.fori_loop(
        0, slabs, slab_body, (nums0, dens0, springs0)
    )

    # final u-face plane x = nx from the last slab's data (tiny, recompute)
    data_last, _ = expand_slab(jnp.int32(slabs - 1))
    hn, hd = transfers._p2g_hi_plane(
        data_last[:, :, : sx + 1], _slab_cfg(cfg, sx - 1), 0
    )
    num_u = jnp.concatenate([nums[0], hn[None]], axis=0)
    den_u = jnp.concatenate([dens[0], hd[None]], axis=0)

    # --- overflow completion (global compacted scatter, like p2g_slots) ---
    cap = min(max(256, cfg.p2g_overflow_capacity), n)
    idx = rs.n_kept + jnp.arange(cap, dtype=jnp.int32)
    ok = overflow[jnp.minimum(idx, n - 1)] & (idx < n)
    safe = jnp.minimum(idx, n - 1)
    num_list = [num_u, nums[1], nums[2]]
    den_list = [den_u, dens[1], dens[2]]
    for axis in range(3):
        n_o, d_o = transfers._p2g_axis(
            state.position[safe],
            state.velocity[safe][:, axis],
            state.affine[safe][:, axis, :] if use_affine else None,
            ok & state.active[safe],
            cfg,
            axis,
        )
        num_list[axis] = num_list[axis] + n_o
        den_list[axis] = den_list[axis] + d_o

    u, v, w = (
        transfers._normalize(num_list[a], den_list[a]) for a in range(3)
    )
    grid = state.grid._replace(u=u, v=v, w=w)
    grid = grids.mark_cells(grid, rs.counts.reshape(cfg.grid_size))
    old_grid = None
    if use_affine:
        grid = grids.remove_boundary_normal_velocities(grid)
    elif cfg.scheme == TransferScheme.FLIP:
        old_grid = grids.remove_boundary_normal_velocities(grid)

    # --- gravity + pressure (dense; the grid fits at any scale) ---
    grid = _add_gravity(grid, cfg, dt)
    pres = pressure_mod.solve(grid, cfg, dt, x0=state.pressure)
    grid = pressure_mod.apply_pressure(grid, pres.pressure, cfg, dt)

    # --- position correction from the accumulated spring field ---
    corr_uncorrected = jnp.int32(0)
    if cfg.enable_position_correction:
        re = cfg.cell_size / jnp.sqrt(jnp.asarray(2.0, cfg.dtype))
        m = kcor * cfg.num_cells
        flat = springs_g.reshape(3, m)
        flat = jnp.concatenate([flat, jnp.zeros((3, 1), flat.dtype)], axis=1)
        sid = jnp.where(slot_of < m, slot_of, m)
        spring = flat[:, sid].T  # (N, 3)
        re2 = cfg.cell_size * cfg.cell_size / 2.0
        truncated = state.active & (slot_of >= m)
        trunc_start = jnp.sum(jnp.minimum(rs.counts, kcor), dtype=jnp.int32)
        corr_uncorrected = jnp.maximum(
            0,
            jnp.sum(truncated.astype(jnp.int32))
            - cfg.correction_overflow_capacity,
        )
        oidx, ospring = _overflow_springs_lazy(
            state.position, truncated, rs, kcor, re2, cfg,
            cfg.correction_overflow_capacity, trunc_start,
        )
        spring = spring.at[jnp.minimum(oidx, n - 1)].add(
            jnp.where((oidx < n)[:, None], ospring, 0.0)
        )
        new_pos = state.position + spring * (dt * cfg.correction_stiffness * re)
        lo = jnp.asarray(cfg.domain_min, cfg.dtype)
        hi = jnp.asarray(cfg.domain_max, cfg.dtype)
        new_pos = jnp.clip(new_pos, lo, hi)
        state = state._replace(
            position=jnp.where(state.active[:, None], new_pos, state.position)
        )
    if cfg.enable_collisions:
        pos = collisions_mod.resolve_collisions(
            old_position, state.position, state.solid, cfg
        )
        pos = jnp.where(state.active[:, None], pos, state.position)
        state = state._replace(position=pos)

    # --- velocity extrapolation (dense) ---
    grid = extrapolation_mod.extrapolate(grid, cfg)

    # --- G2P, slab-tiled over faces with per-rank contiguous particle runs ---
    if cfg.scheme == TransferScheme.FLIP:
        blend = cfg.blending_factor
        if cfg.num_cells <= _G2P_TILED_THRESHOLD:
            vel = transfers.g2p_flip(
                grid, old_grid, state.position, state.velocity, cfg
            )
        else:
            # interp is linear in face values: interp(new) + blend *
            # (v_p - interp(old)) == blend*v_p + interp(new - blend*old)
            comb = grid._replace(
                u=grid.u - blend * old_grid.u,
                v=grid.v - blend * old_grid.v,
                w=grid.w - blend * old_grid.w,
            )
            vi, _ = _g2p_tiled(comb, state, rs, cfg, slabs)
            vel = blend * state.velocity + vi
        affine = state.affine
    else:
        vel, affine = _g2p_tiled(grid, state, rs, cfg, slabs)
    vel = jnp.where(state.active[:, None], vel, state.velocity)
    affine = jnp.where(state.active[:, None, None], affine, state.affine)

    state = state._replace(
        velocity=vel, affine=affine, grid=grid, key=key,
        time=state.time + dt, pressure=pres.pressure,
    )

    active_f = state.active.astype(cfg.dtype)
    vsq = jnp.sum(vel**2, axis=-1) * active_f
    g = jnp.asarray(cfg.gravity, cfg.dtype)
    diag = Diagnostics(
        kinetic_energy=0.5 * jnp.sum(vsq),
        potential_energy=-jnp.sum(jnp.sum(state.position * g, axis=-1) * active_f),
        max_velocity=jnp.sqrt(jnp.max(vsq)),
        pressure_iterations=pres.iterations,
        pressure_residual=pres.residual,
        max_pressure=jnp.max(jnp.abs(pres.pressure)),
        max_divergence=jnp.max(
            jnp.abs(pressure_mod.compute_rhs(grid, cfg) * cfg.cell_size)
        ),
        particle_count=jnp.sum(state.active.astype(jnp.int32)),
        substeps=jnp.int32(1),
        overflow_count=rs.n_overflow,
        correction_uncorrected=corr_uncorrected,
    )
    return state, diag


def _overflow_springs_lazy(
    position, truncated, rs, kcor: int, re2, cfg: SimConfig, cap: int,
    trunc_start,
):
    """``correction.overflow_springs`` without a dense slot grid: resident
    neighbor payload rows are read through the insertion table (slot (r, c)
    lives at sorted row ``ins[r*C + c]`` when ``counts[c] > r``)."""
    n = position.shape[0]
    cap = min(cap, n)
    num_cells = cfg.num_cells
    k = cfg.max_neighbors_per_cell

    idx = trunc_start + jnp.arange(cap, dtype=jnp.int32)
    idx = jnp.where(truncated[jnp.minimum(idx, n - 1)] & (idx < n), idx, n)
    ok = idx < n
    safe = jnp.minimum(idx, n - 1)
    p = position[safe]  # (cap, 3)

    cell3 = grids.cell_index_of(p, cfg)
    offs = jnp.asarray(slots_mod.NEIGHBOR_OFFSETS, jnp.int32)  # (27, 3)
    nb3 = cell3[:, None, :] + offs[None]
    dims = jnp.asarray(cfg.grid_size, jnp.int32)
    inb = jnp.all((nb3 >= 0) & (nb3 < dims), axis=-1)  # (cap, 27)
    cellflat = grids.flat_cell_index(jnp.clip(nb3, 0, dims - 1), cfg)

    ins2 = rs.ins.reshape(k, num_cells)
    cnt = rs.counts
    k_iota = jnp.arange(kcor, dtype=jnp.int32)
    rows = ins2[k_iota[None, None, :], cellflat[..., None]]  # (cap, 27, KC)
    valid = (cnt[cellflat][..., None] > k_iota[None, None, :]) & inb[..., None]
    rows = jnp.minimum(rows, rs.payT.shape[1] - 1)
    nbp = jnp.stack([rs.payT[c][rows] for c in range(3)], axis=0)
    nbm = valid.astype(p.dtype)

    pt = p.T  # (3, cap)
    d2 = sum((pt[i][:, None, None] - nbp[i]) ** 2 for i in range(3))
    degenerate = d2 < 1e-12
    kern = jnp.maximum(1.0 - d2 / re2, 0.0) ** 3
    w = kern * jax.lax.rsqrt(jnp.maximum(d2, 1e-12))
    w = jnp.where(degenerate, 0.0, w) * nbm
    spring = jnp.stack(
        [
            jnp.sum(w * (pt[i][:, None, None] - nbp[i]), axis=(1, 2))
            for i in range(3)
        ],
        axis=-1,
    )
    return idx, spring * ok[:, None].astype(spring.dtype)


def _g2p_tiled(grid, state, rs, cfg: SimConfig, slabs: int):
    """G2P for huge grids: the (C, 64) sample table is built x-slab by x-slab
    (bounding the build temporaries at ~slabC rows) and applied to the
    particles in fixed-size chunks (bounding the per-chunk gather/weight
    temporaries). Semantics identical to ``transfers.g2p_pic``."""
    nx, ny, nz = cfg.grid_size
    if cfg.num_cells <= _G2P_TILED_THRESHOLD:  # small grids: one-shot build
        return transfers.g2p_pic(grid, state.position, cfg)

    n = state.position.shape[0]
    nynz = ny * nz
    sx = nx // slabs
    h = cfg.cell_size
    scfg = _slab_cfg(cfg, sx)

    up = jnp.pad(grid.u, ((1, 1), (0, 0), (0, 0)))
    vp = jnp.pad(grid.v, ((1, 1), (0, 0), (0, 0)))
    wp = jnp.pad(grid.w, ((1, 1), (0, 0), (0, 0)))

    def build_slab(s, table):
        x0 = s * sx
        gu = jax.lax.dynamic_slice(up, (x0, 0, 0), (sx + 3, ny, nz))
        gv = jax.lax.dynamic_slice(vp, (x0, 0, 0), (sx + 2, ny + 1, nz))
        gw = jax.lax.dynamic_slice(wp, (x0, 0, 0), (sx + 2, ny, nz + 1))
        sgrid = grids.MacGrid(u=gu, v=gv, w=gw, cell_type=None)
        tab_s = transfers.build_g2p_table(sgrid, scfg)  # ((sx+2)*nynz, 64)
        # interior rows only (local x-cells [1, sx+1))
        tab_i = tab_s[nynz : (sx + 1) * nynz]
        return jax.lax.dynamic_update_slice(table, tab_i, (x0 * nynz, 0))

    table = jax.lax.fori_loop(
        0, slabs, build_slab, jnp.zeros((cfg.num_cells, 64), cfg.dtype)
    )

    chunk = 1 << 20
    npad = -(-n // chunk) * chunk
    pos_p = jnp.concatenate(
        [state.position, jnp.zeros((npad - n, 3), cfg.dtype)], axis=0
    )

    def chunk_body(i, carry):
        vel, aff = carry
        p = jax.lax.dynamic_slice(pos_p, (i * chunk, 0), (chunk, 3))
        v_c, a_c = transfers.g2p_from_table(table, p, cfg)
        vel = jax.lax.dynamic_update_slice(vel, v_c, (i * chunk, 0))
        aff = jax.lax.dynamic_update_slice(aff, a_c, (i * chunk, 0, 0))
        return vel, aff

    vel, aff = jax.lax.fori_loop(
        0, npad // chunk, chunk_body,
        (jnp.zeros((npad, 3), cfg.dtype), jnp.zeros((npad, 3, 3), cfg.dtype)),
    )
    return vel[:n], aff[:n]
