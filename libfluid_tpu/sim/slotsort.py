"""Fused particle sort + slot-grid build.

Replaces the ``binning.sort_by_cell`` + ``slots.build`` pair (reference
``hash_particles``, ``simulation.cpp:266-291``, + the dense slot grid of
:mod:`libfluid_tpu.sim.slots`) with two ``lax.sort`` calls and one gather,
without the (N, 16) row scatter into the slot grid.

The trick is the SECOND sort key: the rank-major slot id ``rank * C + cell``
(overflow and inactive rows parked past ``K*C`` in stable order). The sorted
payload is then the slot grid with the gaps (empty slots) squeezed out, in
exactly slot-grid memory order. Filling the gaps is a MONOTONE EXPANSION —
dest lane j reads compacted row S[j] with S non-decreasing, the exclusive
cumsum of the (K, C) kept-mask — computed as one column gather
(:func:`_expand_jnp`). Per dest block of ``block`` lanes the source rows are
one contiguous window of the sorted payload, described by the window start
``w0`` and the block-relative ``delta = j - S[j]``.

Everything else (counts, ranks, slot ids, expansion deltas) is dense
arithmetic: ranks come from a running segment cummax, per-slot insertion
positions from one cumsum over the (K, C) kept-mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from libfluid_tpu import grids
from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim.binning import Binning
from libfluid_tpu.sim.slots import SlotGrid, WIDTH

PAD = 128          # payload column slack past each expansion window
INV = 1 << 20      # invalid-lane flag bit carried inside the delta word
_MAX_BLOCK = 16384


def _pick_block(num_cells: int) -> int | None:
    """Largest divisor of C in [512, _MAX_BLOCK] (dest lanes per window)."""
    best = None
    for b in range(512, _MAX_BLOCK + 1):
        if num_cells % b == 0:
            best = b
    return best


def _src_of(delta: jnp.ndarray, w0: jnp.ndarray, block: int):
    """Global source row per dest lane from the block-relative deltas:
    src = w0[block] + (j - j0) - delta."""
    j = jnp.arange(delta.shape[0], dtype=jnp.int32)
    valid = delta < INV
    d = jnp.where(valid, delta, 0)
    src = w0[j // block] + (j % block) - d
    return src, valid


def _expand_jnp(payT: jnp.ndarray, delta: jnp.ndarray, w0, block: int) -> jnp.ndarray:
    """The expansion as one column gather of the sorted payload."""
    src, valid = _src_of(delta, w0, block)
    src = jnp.clip(src, 0, payT.shape[1] - 1)
    return jnp.take(payT, src, axis=1) * valid[None, :].astype(payT.dtype)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _expand(payT, delta, w0, block: int):
    """The monotone expansion as one gather, with an explicit scatter-add
    backward (the gather's transpose, without XLA's generic gather VJP)."""
    return _expand_jnp(payT, delta, w0, block)


def _expand_fwd(payT, delta, w0, block):
    return _expand(payT, delta, w0, block), (delta, w0, payT.shape[1])


def _expand_bwd(block, res, g):
    delta, w0, ncols = res
    src, valid = _src_of(delta, w0, block)
    src = jnp.where(valid, src, ncols)
    dpay = jnp.zeros((g.shape[0], ncols + 1), g.dtype)
    dpay = dpay.at[:, src].add(
        g * valid[None, :].astype(g.dtype), mode="drop"
    )
    return dpay[:, :ncols], None, None


_expand.defvjp(_expand_fwd, _expand_bwd)


class RankSorted(NamedTuple):
    """Particle SoA in rank-major slot order plus everything a (full- or
    slab-wise) slot-grid expansion needs."""

    state: object            # SimState, particle arrays permuted
    counts: jnp.ndarray      # (C,) particles per cell (uncapped)
    ins: jnp.ndarray         # (K*C,) exclusive cumsum of the kept mask —
    #                          the sorted-payload row of each (rank, cell)
    key_sorted: jnp.ndarray  # (N,) rank-major slot id; >= K*C parked
    n_kept: jnp.ndarray      # int32 scalar
    n_overflow: jnp.ndarray  # int32 scalar; overflow rows occupy
    #                          [n_kept, n_kept + n_overflow)
    payT: jnp.ndarray        # (16, N + pad) transposed sorted payload
    #                          (pos, 1, vel, affine rows)


class SortBuildResult(NamedTuple):
    state: object            # SimState with particle arrays in slot order
    bins: Binning            # occupancy/counts (cell_of in the NEW order)
    slot_grid: SlotGrid
    n_kept: jnp.ndarray      # rows with a slot (int32 scalar)
    n_overflow: jnp.ndarray  # active rows past slot capacity (contiguous
    #                          range [n_kept, n_kept + n_overflow))


def sort_rank_major(state, cfg: SimConfig, pad_cols: int) -> RankSorted:
    """Sort the particle SoA into rank-major slot order (two ``lax.sort``
    calls — see module docstring) without building any slot grid.
    `pad_cols` zero columns are appended to ``payT`` for window overrun."""
    n = state.position.shape[0]
    num_cells = cfg.num_cells
    k = cfg.max_neighbors_per_cell
    kc = num_cells * k
    iota = jnp.arange(n, dtype=jnp.int32)

    idx3 = grids.cell_index_of(state.position, cfg)
    cell = grids.flat_cell_index(idx3, cfg)
    cell = jnp.where(state.active, cell, num_cells)

    # --- light sort: ranks + counts without moving the payload ---
    cell_s, order = jax.lax.sort_key_val(cell, iota)
    run_start = jax.lax.cummax(
        jnp.where(cell_s != jnp.roll(cell_s, 1), iota, 0).at[0].set(0)
    )
    rank_s = iota - run_start
    counts = jax.ops.segment_sum(
        jnp.ones((n,), jnp.int32), cell_s, num_segments=num_cells + 1,
        indices_are_sorted=True,
    )[:num_cells]

    kept_s = (cell_s < num_cells) & (rank_s < k)
    over_s = (cell_s < num_cells) & (rank_s >= k)
    key_s = jnp.where(
        kept_s,
        rank_s * num_cells + cell_s,
        kc + jnp.where(over_s, iota, n + iota),
    )
    key = jnp.zeros((n,), jnp.int32).at[order].set(key_s, unique_indices=True)

    # --- payload sort into rank-major slot order ---
    cols = (
        [state.position[:, i] for i in range(3)]
        + [state.velocity[:, i] for i in range(3)]
        + [state.affine.reshape(n, 9)[:, i] for i in range(9)]
    )
    sorted_ops = jax.lax.sort((key,) + tuple(cols), num_keys=1)
    key_sorted = sorted_ops[0]
    pos = jnp.stack(sorted_ops[1:4], axis=1)
    vel = jnp.stack(sorted_ops[4:7], axis=1)
    aff = jnp.stack(sorted_ops[7:16], axis=1).reshape(n, 3, 3)

    n_kept = jnp.sum(kept_s.astype(jnp.int32))
    n_overflow = jnp.sum(over_s.astype(jnp.int32))
    active = iota < (n_kept + n_overflow)

    kr = (counts[None, :] > jnp.arange(k, dtype=jnp.int32)[:, None]).reshape(-1)
    ins = jnp.cumsum(kr.astype(jnp.int32)) - kr.astype(jnp.int32)  # exclusive

    use_affine = cfg.scheme == TransferScheme.APIC
    mask_col = jnp.ones((n, 1), cfg.dtype)
    aff_cols = aff.reshape(n, 9) if use_affine else jnp.zeros((n, 9), cfg.dtype)
    payT = jnp.concatenate([pos, mask_col, vel, aff_cols], axis=1).T  # (16, N)
    payT = jnp.concatenate(
        [payT, jnp.zeros((WIDTH, pad_cols), cfg.dtype)], axis=1
    )

    state = state._replace(position=pos, velocity=vel, affine=aff, active=active)
    return RankSorted(
        state=state, counts=counts, ins=ins, key_sorted=key_sorted,
        n_kept=n_kept, n_overflow=n_overflow, payT=payT,
    )


def expand_range(rs: RankSorted, cfg: SimConfig, c0, num_c: int, block: int):
    """Slot payload (16, K, num_c) for the cell range [c0, c0 + num_c)
    (c0 dynamic, num_c/block static; block | num_c). The per-rank source
    rows are contiguous windows of ``rs.payT`` given by ``rs.ins``."""
    k = cfg.max_neighbors_per_cell
    num_cells = cfg.num_cells
    ins2 = rs.ins.reshape(k, num_cells)
    ins_s = jax.lax.dynamic_slice(ins2, (0, c0), (k, num_c))  # (K, num_c)
    cnt_s = jax.lax.dynamic_slice(rs.counts, (c0,), (num_c,))
    kr_s = cnt_s[None, :] > jnp.arange(k, dtype=jnp.int32)[:, None]

    insf = ins_s.reshape(-1, block)
    delta = (
        jax.lax.broadcasted_iota(jnp.int32, insf.shape, 1)
        - (insf - insf[:, :1])
    ).reshape(-1)
    delta = jnp.where(kr_s.reshape(-1), delta, delta | INV)
    w0 = insf[:, 0].astype(jnp.int32)
    flat = _expand(rs.payT, delta, w0, block)  # (16, K*num_c)
    return flat.reshape(WIDTH, k, num_c)


def sort_and_build(state, cfg: SimConfig) -> SortBuildResult:
    """Sort the particle SoA into rank-major slot order and build the slot
    grid in one fused pass. Semantically equals ``binning.sort_by_cell``
    followed by ``slots.build`` up to the (arbitrary) particle permutation:
    the reference's sort order (``simulation.cpp:266-291``) is cell-major,
    this one is slot-major; every downstream consumer is order-independent.

    The returned ``bins.order``/``bins.cell_start`` do NOT describe
    cell-contiguous runs (the SoA is rank-major here; see the validity
    caveat on :class:`~libfluid_tpu.sim.binning.Binning`) — only
    ``cell_of``/``cell_count``/``occupancy`` are meaningful. Neighbor access
    on this path is via the returned SlotGrid.
    """
    num_cells = cfg.num_cells
    k = cfg.max_neighbors_per_cell
    kc = num_cells * k
    block = _pick_block(num_cells)
    blk = kc if block is None else block

    rs = sort_rank_major(state, cfg, pad_cols=blk + 2 * PAD)
    flat = expand_range(rs, cfg, jnp.int32(0), num_cells, blk)
    nx, ny, nz = cfg.grid_size
    data = flat.reshape(WIDTH, k, nx, ny, nz)

    n = rs.key_sorted.shape[0]
    slot_of = jnp.minimum(rs.key_sorted, kc)
    overflow = (rs.key_sorted >= kc) & (rs.key_sorted < kc + n)
    counts = rs.counts
    bins = Binning(
        order=jnp.arange(n, dtype=jnp.int32),
        cell_of=jnp.where(rs.state.active, grids.flat_cell_index(
            grids.cell_index_of(rs.state.position, cfg), cfg), num_cells),
        cell_start=jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.cumsum(counts, dtype=jnp.int32)[:-1]]
        ),
        cell_count=counts,
        occupancy=counts.reshape(cfg.grid_size),
    )
    slot_grid = SlotGrid(data=data, slot_of=slot_of, overflow=overflow)
    return SortBuildResult(
        state=rs.state, bins=bins, slot_grid=slot_grid,
        n_kept=rs.n_kept, n_overflow=rs.n_overflow,
    )
