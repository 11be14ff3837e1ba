"""Per-stage wall-clock breakdown of the 128^3 APIC substep (host-synced).

Run from anywhere: ``python benchmarks/prof_stages.py [grid_n]``. Output is
the round's profiling artifact (commit it) — perf work starts here, not from
guesses.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import jax

from libfluid_tpu.cache import enable_persistent_cache
from libfluid_tpu.profiling import timeit

from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import new_state, seed_box, substep
from libfluid_tpu.sim import binning as binning_mod, slots as slots_mod
from libfluid_tpu.sim import transfers, pressure as pressure_mod
from libfluid_tpu.sim import correction as correction_mod, collisions as collisions_mod
from libfluid_tpu.sim import extrapolation as extrapolation_mod
from libfluid_tpu import grids

enable_persistent_cache()
N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
cfg = SimConfig(grid_size=(N, N, N), gravity=(0., -981., 0.),
                particle_capacity=1 << 21 if N >= 128 else 1 << 18,
                scheme=TransferScheme.APIC, has_obstacles=False)
state = new_state(cfg, jax.random.PRNGKey(0))
state = seed_box(state, cfg, (1., 1., 1.), (N // 2 - 1.,) * 3)
dt = 0.02
fn = jax.jit(lambda s: substep(s, cfg, dt)[0])
state = fn(state)
state = fn(state)


def bench(name, f, *args):
    g = jax.jit(f)
    dt_wall, out = timeit(g, *args)
    print(f"{name:22s} {dt_wall*1e3:8.1f} ms", flush=True)
    return out


from libfluid_tpu.sim import slotsort

sb = bench("sort_and_build (fused)", lambda s: slotsort.sort_and_build(s, cfg), state)
state2, bins, slot_grid = sb.state, sb.bins, sb.slot_grid

# sub-phases of the fused pass
n = state.position.shape[0]
import jax.numpy as jnp
iota = jnp.arange(n, dtype=jnp.int32)
from libfluid_tpu import grids as grids_mod
cell = jnp.where(state.active, grids_mod.flat_cell_index(
    grids_mod.cell_index_of(state.position, cfg), cfg), cfg.num_cells)
bench("  sort1 key_val", lambda c: jax.lax.sort_key_val(c, iota), cell)
cols16 = tuple(state.position[:, i] for i in range(3)) + tuple(
    state.velocity[:, i] for i in range(3)) + tuple(
    state.affine.reshape(n, 9)[:, i] for i in range(9))
bench("  sort2 16-op", lambda c, *cs: jax.lax.sort((c,) + cs, num_keys=1), cell, *cols16)
bench("  segment_sum counts", lambda c: jax.ops.segment_sum(
    jnp.ones((n,), jnp.int32), c, num_segments=cfg.num_cells + 1,
    indices_are_sorted=True), cell)
bench("  key scatter", lambda k, o: jnp.zeros((n,), jnp.int32).at[o].set(k, unique_indices=True), cell, iota)
uvw = bench(
    "p2g_slots",
    lambda sg, s: transfers.p2g_slots(
        sg, s.position, s.velocity, s.affine, s.active, cfg
    ),
    slot_grid, state2,
)
grid = state2.grid._replace(u=uvw[0], v=uvw[1], w=uvw[2])
grid = grids.mark_cells(grid, bins.occupancy)
pres = bench("pressure.solve", lambda g: pressure_mod.solve(g, cfg, dt), grid)
bench("apply_pressure", lambda g, p: pressure_mod.apply_pressure(g, p, cfg, dt), grid, pres.pressure)
key = jax.random.PRNGKey(1)
# production passes trunc_start (slotsort rank-major order) so the overflow
# pass is a contiguous slice, not a jnp.nonzero compaction — bench the same
kc = min(cfg.correction_capacity, slot_grid.capacity)
trunc_start = jnp.sum(jnp.minimum(bins.cell_count, kc), dtype=jnp.int32)
bench(
    "correction",
    lambda s, sg, ts: correction_mod.correct_positions(
        s.position, s.active, sg, cfg, dt, key, trunc_start=ts
    ),
    state2, slot_grid, trunc_start,
)
bench("collisions", lambda s: collisions_mod.resolve_collisions(s.position, s.position + 0.1, s.solid, cfg), state2)
grid2 = bench("extrapolate", lambda g: extrapolation_mod.extrapolate(g, cfg), grid)
bench("g2p_pic", lambda g, s: transfers.g2p_pic(g, s.position, cfg), grid2, state2)
bench("FULL substep", lambda s: substep(s, cfg, dt)[0], state)
