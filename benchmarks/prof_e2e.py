"""Per-stage breakdown of the config-3 frame (64^3 sim -> mesher -> render).

Isolates substep / mesher / accel build / render so the DDA work is
measured, not guessed. Run on the GPU: ``python benchmarks/prof_e2e.py``.
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (_ROOT, os.path.join(_ROOT, "benchmarks")):
    if p not in sys.path:
        sys.path.insert(0, p)

import jax
import jax.numpy as jnp

from libfluid_tpu.config import (
    MesherConfig, RenderConfig, SimConfig, TransferScheme,
)
from libfluid_tpu.mesher.marching_cubes import generate_mesh
from libfluid_tpu.renderer import accel as accel_mod
from libfluid_tpu.renderer import scenes
from libfluid_tpu.renderer.render import render
from libfluid_tpu.renderer.scene import inject_mesh
from libfluid_tpu.sim import new_state, seed_box, substep

RES = int(sys.argv[1]) if len(sys.argv) > 1 else 64


def timeit(f, *args, n=2):
    out = f(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / n, out


cfg = SimConfig(
    grid_size=(64, 64, 64), gravity=(0.0, -981.0, 0.0),
    particle_capacity=1 << 18, scheme=TransferScheme.APIC,
    has_obstacles=False,
)
state = new_state(cfg, jax.random.PRNGKey(0))
state = seed_box(state, cfg, (1.0, 1.0, 1.0), (31.0, 31.0, 31.0))
mcfg = MesherConfig(grid_size=(64, 64, 64), cell_size=1.0, max_triangles=1 << 17)
builder, cam = scenes.fluid_box((0.0, 0.0, 0.0), (64.0, 64.0, 64.0))
water = builder.lambertian((0.4, 0.55, 0.8))
scene0 = builder.finish()
rcfg = RenderConfig(
    width=256, height=256, samples_per_pixel=4, max_bounces=4,
    differentiable=False,
)

# advance a few steps so the surface is a real dam-break front
stepper = jax.jit(lambda s: substep(s, cfg, 0.02)[0])
for _ in range(3):
    state = stepper(state)
jax.block_until_ready(state.position)

dt_step, state2 = timeit(stepper, state)
print(f"substep            {dt_step*1e3:8.0f} ms", flush=True)

mesher = jax.jit(lambda s: generate_mesh(s.position, s.active, mcfg))
dt_mesh, mesh = timeit(mesher, state2)
ntri = int(jnp.sum(mesh.valid))
print(f"mesher             {dt_mesh*1e3:8.0f} ms   ({ntri} tris)", flush=True)


def build_scene(mesh):
    s = inject_mesh(scene0, mesh.vertices, mesh.valid, water)
    return s._replace(accel=accel_mod.build(s, res=(RES, RES, RES)))


builder_j = jax.jit(build_scene)
dt_build, scene = timeit(builder_j, mesh)
print(f"inject+accel build {dt_build*1e3:8.0f} ms   (res {RES}^3)", flush=True)

rend = jax.jit(lambda s, k: render(s, cam, rcfg, k))
dt_rend, img = timeit(rend, scene, jax.random.PRNGKey(2), n=2)
print(f"render 256^2x4spp  {dt_rend*1e3:8.0f} ms", flush=True)
print(f"TOTAL              {(dt_step+dt_mesh+dt_build+dt_rend)*1e3:8.0f} ms",
      flush=True)
