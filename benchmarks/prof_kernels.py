"""Device time of the simulator's neighbourhood passes at the 128^3 APIC
substep shapes (2.0M particles, K=12), on the GPU.

Times what XLA compiles for the plain jnp passes (slot-grid P2G, the slot
expansion gather, the multigrid stencil, the G2P table transpose and weight
evaluation) and the Pallas correction kernel
against its jnp oracle, and counts the fusions XLA makes of
``multigrid.apply_level``. Each line names the card.

Run: ``python benchmarks/prof_kernels.py`` (about 4 minutes on a cold
compile cache). The mesher's time is in ``chip_smoke.py``'s testbed phase.
"""
import os
import re
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import jax
import jax.numpy as jnp

from libfluid_tpu.cache import enable_persistent_cache
from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.profiling import timeit
from libfluid_tpu.sim import (
    correction, multigrid, new_state, pressure, seed_box, slotsort, substep,
    transfers,
)

enable_persistent_cache()
if jax.devices()[0].platform != "gpu":
    sys.exit(f"needs a GPU, found {jax.devices()[0].platform}")
CARD = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True,
).stdout.strip()
print(f"card: {CARD}", flush=True)


def t(name, f, *args, iters=10):
    sec, out = timeit(jax.jit(f), *args, iters=iters)
    print(f"{name:44s} {sec * 1e3:9.3f} ms", flush=True)
    return out


def entry_fusions(f, *args) -> int:
    """Fusion kernels in the entry computation XLA compiles for f."""
    text = jax.jit(f).lower(*args).compile().as_text()
    entry = text[text.index("ENTRY"):]
    entry = entry[: entry.index("\n}")]
    return len(re.findall(r"= \S+ fusion\(", entry))


cfg = SimConfig(grid_size=(128, 128, 128), gravity=(0.0, -981.0, 0.0),
                particle_capacity=1 << 21, scheme=TransferScheme.APIC,
                has_obstacles=False)
DT = 0.02
state = new_state(cfg, jax.random.PRNGKey(0))
state = seed_box(state, cfg, (1.0, 1.0, 1.0), (63.0, 63.0, 63.0))
step = jax.jit(lambda s: substep(s, cfg, DT)[0])
for _ in range(3):  # a moving, compressed dam-break front
    state = step(state)

# --- slot grid: sort + expansion gather, P2G over the slots ---
sb = t("sort_and_build (sorts + expand gather)",
       lambda s: slotsort.sort_and_build(s, cfg), state)
block = slotsort._pick_block(cfg.num_cells)
rs = jax.jit(lambda s: slotsort.sort_rank_major(
    s, cfg, pad_cols=block + 2 * slotsort.PAD))(state)
t("  expand gather alone", lambda r: slotsort.expand_range(
    r, cfg, jnp.int32(0), cfg.num_cells, block), rs)
t("P2G _p2g_slots_jnp (27 offsets x axes)",
  lambda d: transfers._p2g_slots_jnp(d, cfg), sb.slot_grid.data)

# --- correction springs: Pallas kernel vs jnp oracle ---
kc = cfg.correction_capacity
res_pos, res_mask = sb.slot_grid.position[:, :kc], sb.slot_grid.mask[:kc]
seed, origin = jnp.int32(1), jnp.zeros((3,), jnp.int32)
t("springs: jnp oracle", lambda p, m: correction._springs_jnp(
    p, m, 0.5, seed, cfg, origin=origin), res_pos, res_mask)
t("springs: Pallas kernel + jnp jitter", lambda p, m: correction._springs_triton(
    p, m, 0.5, seed, cfg, origin), res_pos, res_mask)

# --- pressure: MG stencil ---
grid = state.grid
levels = jax.jit(lambda ct: multigrid.build_levels(ct, cfg.dtype))(grid.cell_type)
b = jax.jit(lambda g: pressure.compute_rhs(g, cfg))(grid)
lvl0 = levels[0]
t("MG apply_level 128^3", lambda p: multigrid.apply_level(lvl0, p), b)
t("MG smooth x2 128^3", lambda p: multigrid._smooth(lvl0, jnp.zeros_like(p), p, 2), b)
t("MG v_cycle", lambda p: multigrid.v_cycle(levels, p), b)
res = t("pressure.solve", lambda g: pressure.solve(g, cfg, DT), grid, iters=3)
print(f"  CG iterations {int(res.iterations)} residual {float(res.residual):.2e}")
print(f"apply_level fusions (compiled HLO, 128^3): "
      f"{entry_fusions(lambda p: multigrid.apply_level(lvl0, p), b)}", flush=True)

# --- G2P: table build with its (64, C) -> (C, 64) transpose, then the
# row gather and the (18, N) weight evaluation ---
table = t("G2P table build (incl. .T)",
          lambda g: transfers.build_g2p_table(g, cfg), grid)
t("G2P g2p_from_table", lambda tb, p: transfers.g2p_from_table(tb, p, cfg),
  table, state.position)
