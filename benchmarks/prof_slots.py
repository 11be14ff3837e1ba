"""Micro-breakdown of the binning + slot-grid build at 128^3 / 2M particles.

This isolates each sub-cost so layout work targets the real bottleneck.
Run: python benchmarks/prof_slots.py [grid_n]
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import jax
import jax.numpy as jnp

from libfluid_tpu.cache import enable_persistent_cache
from libfluid_tpu.profiling import timeit

from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import new_state, seed_box
from libfluid_tpu.sim import binning as binning_mod, slots as slots_mod

enable_persistent_cache()
N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
cfg = SimConfig(grid_size=(N, N, N), gravity=(0., -981., 0.),
                particle_capacity=1 << 21 if N >= 128 else 1 << 18,
                scheme=TransferScheme.APIC, has_obstacles=False)
state = new_state(cfg, jax.random.PRNGKey(0))
state = seed_box(state, cfg, (1., 1., 1.), (N // 2 - 1.,) * 3)

n = state.position.shape[0]
num_cells = cfg.num_cells
k = cfg.max_neighbors_per_cell


def bench(name, f, *args):
    g = jax.jit(f)
    dt_wall, out = timeit(g, *args)
    print(f"{name:34s} {dt_wall*1e3:8.1f} ms", flush=True)
    return out


from libfluid_tpu import grids

cell3 = grids.cell_index_of(state.position, cfg)
cell = grids.flat_cell_index(cell3, cfg)
cell = jnp.where(state.active, cell, num_cells)
iota = jnp.arange(n, dtype=jnp.int32)

bench("argsort(cell)", lambda c: jnp.argsort(c), cell)
bench("sort_key_val(cell, iota)", lambda c, i: jax.lax.sort_key_val(c, i), cell, iota)

state2, bins = bench("sort_by_cell (full)", lambda s: binning_mod.sort_by_cell(s, cfg), state)
payload = jnp.concatenate(
    [state2.position, jnp.ones((n, 1), cfg.dtype), state2.velocity,
     state2.affine.reshape(n, 9)], axis=1)
order = jnp.argsort(cell)
bench("payload gather (N,16)[order]", lambda p, o: p[o], payload, order)

# slot-grid build pieces (rank-major slot = rank*num_cells + cell)
cellS = bins.cell_of
in_grid = cellS < num_cells
rank = iota - bins.cell_start[jnp.minimum(cellS, num_cells - 1)]
ok = in_grid & (rank < k)
slot_rankmajor = jnp.where(ok, rank * num_cells + cellS, num_cells * k)
slot_cellmajor = jnp.where(ok, cellS * k + rank, num_cells * k)


def scatter_only(slot, pay):
    g = jnp.zeros((num_cells * k + 1, 16), cfg.dtype)
    return g.at[slot].set(pay, mode="drop", unique_indices=True)


g_rank = bench("scatter rows (rank-major slots)", scatter_only, slot_rankmajor, payload)
g_cell = bench("scatter rows (cell-major MONOTONIC)", scatter_only, slot_cellmajor, payload)

nx, ny, nz = cfg.grid_size
bench("transpose (CK,16)->(16,K,g)", lambda g: g[:-1].T.reshape(16, k, nx, ny, nz), g_rank)

# cell-major needs (cells,k,16) -> (16,k,cells): transpose to (k*16, cells)
# first (both minor dims merge), then split
bench("transpose cellmajor->(16,k,g)",
      lambda g: g[:-1].reshape(num_cells, k * 16).T.reshape(k, 16, num_cells)
      .swapaxes(0, 1).reshape(16, k, nx, ny, nz),
      g_cell)

bench("slots.build (full)", lambda s, b: slots_mod.build(
    s.position, s.velocity, s.affine, b, cfg), state2, bins)

# column-scatter variant: 16 scatters of (N,) into (K*C,) already-transposed
def build_T(slot, pay):
    outs = []
    for c in range(16):
        col = jnp.zeros((num_cells * k + 1,), cfg.dtype)
        outs.append(col.at[slot].set(pay[:, c], mode="drop", unique_indices=True)[:-1])
    return jnp.stack(outs).reshape(16, k, nx, ny, nz)


bench("16 column scatters (pre-T layout)", build_T, slot_rankmajor, payload)

# scatter into (K*C, 16) but only 4 columns (correction's needs)
def scatter4(slot, pay):
    g = jnp.zeros((num_cells * k + 1, 4), cfg.dtype)
    return g.at[slot].set(pay[:, :4], mode="drop", unique_indices=True)

bench("scatter rows 4-col", scatter4, slot_rankmajor, payload)
