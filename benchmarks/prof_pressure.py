"""Pressure-solve component timing at 128^3: apply_level formulations,
V-cycle settings, CG totals."""
import os
import sys
import jax, jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from libfluid_tpu.cache import enable_persistent_cache
from libfluid_tpu.profiling import timeit

from libfluid_tpu.config import SimConfig, TransferScheme, SolverConfig
from libfluid_tpu.sim import new_state, seed_box, substep
from libfluid_tpu.sim import multigrid, pressure as pressure_mod
from libfluid_tpu import grids

enable_persistent_cache()
N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
cfg = SimConfig(grid_size=(N,)*3, gravity=(0.,-981.,0.), particle_capacity=1<<21,
                scheme=TransferScheme.APIC, has_obstacles=False)
state = new_state(cfg, jax.random.PRNGKey(0))
state = seed_box(state, cfg, (1.,1.,1.), (N/2-1.,)*3)
state = jax.jit(lambda s: substep(s, cfg, 0.02)[0])(state)
grid = state.grid
dt = 0.02

def t(name, f, *a):
    wall, out = timeit(jax.jit(f), *a)
    print(f"{name:40s} {wall*1e3:8.2f} ms", flush=True)
    return out

levels = jax.jit(lambda ct: multigrid.build_levels(ct, cfg.dtype))(grid.cell_type)
t("build_levels", lambda ct: multigrid.build_levels(ct, cfg.dtype), grid.cell_type)
b = jax.jit(lambda g: pressure_mod.compute_rhs(g, cfg))(grid)

lvl0 = levels[0]
p = b
t("apply_level (slice-add)", lambda p: multigrid.apply_level(lvl0, p), p)

def apply_pad(p):
    p = p * lvl0.fluid
    nbr = (
        lvl0.couple_u[:-1] * jnp.pad(p, ((1, 0), (0, 0), (0, 0)))[:-1]
        + lvl0.couple_u[1:] * jnp.pad(p, ((0, 1), (0, 0), (0, 0)))[1:]
        + lvl0.couple_v[:, :-1] * jnp.pad(p, ((0, 0), (1, 0), (0, 0)))[:, :-1]
        + lvl0.couple_v[:, 1:] * jnp.pad(p, ((0, 0), (0, 1), (0, 0)))[:, 1:]
        + lvl0.couple_w[:, :, :-1] * jnp.pad(p, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
        + lvl0.couple_w[:, :, 1:] * jnp.pad(p, ((0, 0), (0, 0), (0, 1)))[:, :, 1:]
    )
    return lvl0.scale * (lvl0.diag * p - nbr) * lvl0.fluid
t("apply_level (pad-fused)", apply_pad, p)

t("v_cycle", lambda b: multigrid.v_cycle(levels, b), b)
t("smooth x1 level0", lambda b: multigrid._smooth(lvl0, jnp.zeros_like(b), b, 1), b)
t("restrict l0->l1", lambda r: multigrid._restrict(levels[1], r), b)

out = t("solve (mg)", lambda g: pressure_mod.solve(g, cfg, dt), grid)
print("iters:", int(out.iterations), "res:", float(out.residual), flush=True)
