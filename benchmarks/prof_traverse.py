"""Microbenchmark of accel.traverse on a fluid-mesh scene (config-3 shape).

Times one traversal of a primary-ray wavefront and one of a diffuse-bounce
wavefront, and reports the iteration count the lockstep loop actually ran
(the whole wavefront pays the worst ray). Run on the GPU.
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

from libfluid_tpu.config import MesherConfig, SimConfig, TransferScheme
from libfluid_tpu.mesher.marching_cubes import generate_mesh
from libfluid_tpu.renderer import accel as accel_mod
from libfluid_tpu.renderer import scenes
from libfluid_tpu.renderer.scene import inject_mesh
from libfluid_tpu.sim import new_state, seed_box, substep

RES = int(sys.argv[1]) if len(sys.argv) > 1 else 64
LANES = 1 << 16


cfg = SimConfig(
    grid_size=(64, 64, 64), gravity=(0.0, -981.0, 0.0),
    particle_capacity=1 << 18, scheme=TransferScheme.APIC, has_obstacles=False,
)
state = new_state(cfg, jax.random.PRNGKey(0))
state = seed_box(state, cfg, (1.0, 1.0, 1.0), (31.0, 31.0, 31.0))
stepper = jax.jit(lambda s: substep(s, cfg, 0.02)[0])
for _ in range(3):
    state = stepper(state)
mcfg = MesherConfig(grid_size=(64, 64, 64), cell_size=1.0, max_triangles=1 << 17)
mesh = jax.jit(lambda s: generate_mesh(s.position, s.active, mcfg))(state)
builder, cam = scenes.fluid_box((0.0, 0.0, 0.0), (64.0, 64.0, 64.0))
water = builder.lambertian((0.4, 0.55, 0.8))
scene0 = builder.finish()
scene = inject_mesh(scene0, mesh.vertices, mesh.valid, water)
scene = scene._replace(accel=jax.jit(
    lambda s: accel_mod.build(s, res=(RES, RES, RES))
)(scene))
print(f"tris={int(jnp.sum(mesh.valid))} res={RES} "
      f"big={int(jnp.sum(scene.accel.big_ids >= 0))}", flush=True)

# primary rays
ij = jnp.stack(
    jnp.meshgrid(jnp.arange(256.0), jnp.arange(256.0), indexing="xy"), -1
).reshape(-1, 2)[:LANES] / 256.0
o, d = cam.get_rays(ij)
d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

pack = jax.jit(accel_mod.pack_tris)(scene)


def run(o, d):
    return accel_mod.traverse(scene.accel, pack, o, d, 3.0e38)


fn = jax.jit(run)
out = fn(o, d)
jax.block_until_ready(out[0])
for name in ("primary",):
    t0 = time.time()
    for _ in range(5):
        out = fn(o, d)
    jax.block_until_ready(out[0])
    print(f"{name}: {(time.time()-t0)/5*1e3:.1f} ms / {LANES} rays", flush=True)

hit_t, hit_id = out[0], out[1]
print(f"hit fraction: {float(jnp.mean((hit_id >= 0).astype(jnp.float32))):.2f}",
      flush=True)

# diffuse-bounce rays: start at hit points, random cosine directions
key = jax.random.PRNGKey(9)
hitp = o + d * jnp.minimum(hit_t, 200.0)[:, None]
nrm = jax.random.normal(key, (LANES, 3))
nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
o2 = hitp + nrm * 1e-3
out2 = fn(o2, nrm)
jax.block_until_ready(out2[0])
t0 = time.time()
for _ in range(5):
    out2 = fn(o2, nrm)
jax.block_until_ready(out2[0])
print(f"diffuse: {(time.time()-t0)/5*1e3:.1f} ms / {LANES} rays", flush=True)
