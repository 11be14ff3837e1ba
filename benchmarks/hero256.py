"""Config-5 hero frame: 256^3 APIC tide -> marching cubes -> path-traced PPM.

The reference's qualitative baseline is its committed renders
(``renders/tide.png``, ``README.md:3``); this script produces the
counterpart at the same scale: the tide scene (a shallow pool plus a tall
wall of water, ``bench.bench_sim_256`` seeding) stepped with the slab-tiled
substep, meshed at 256^3, and rendered in a Cornell-style room
(``test_scenes.cpp:280-386``) with the persistent-threads path tracer.

Run on the GPU: ``python benchmarks/hero256.py [substeps] [size] [spp]``.
Writes renders/tide256.ppm + prints per-phase timings.
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import jax
import jax.numpy as jnp
import numpy as np

from libfluid_tpu.config import (
    MesherConfig, RenderConfig, SimConfig, TransferScheme,
)
from libfluid_tpu.io.ppm import save_ppm
from libfluid_tpu.mesher.marching_cubes import generate_mesh
from libfluid_tpu.renderer import accel as accel_mod
from libfluid_tpu.renderer import scenes
from libfluid_tpu.renderer.render import render
from libfluid_tpu.sim import new_state, seed_box
from libfluid_tpu.sim.bigstep import substep_tiled

N_STEPS = int(sys.argv[1]) if len(sys.argv) > 1 else 30
SIZE = int(sys.argv[2]) if len(sys.argv) > 2 else 512
SPP = int(sys.argv[3]) if len(sys.argv) > 3 else 32


def _particles(cache=os.path.join(_ROOT, "out", "hero_state.npz")):
    """Run (or reload) the 256^3 tide sim; returns (position, active) on
    host. Cached so render-phase retries don't pay the ~8 min sim again."""
    if os.path.exists(cache):
        d = np.load(cache)
        print(f"loaded cached particles: {int(d['active'].sum())}", flush=True)
        return d["position"], d["active"]

    cfg = SimConfig(
        grid_size=(256, 256, 256), gravity=(0.0, -981.0, 0.0),
        particle_capacity=1 << 23, scheme=TransferScheme.APIC,
        has_obstacles=False,
    )
    state = new_state(cfg, jax.random.PRNGKey(0))
    state = seed_box(state, cfg, (1.0, 1.0, 1.0), (254.0, 9.0, 254.0))
    state = seed_box(state, cfg, (1.0, 10.0, 1.0), (24.0, 63.0, 254.0))
    print(f"seeded {int(jnp.sum(state.active))} particles", flush=True)

    dt = 0.02
    fn = jax.jit(lambda s: substep_tiled(s, cfg, dt, 16))
    t0 = time.time()
    state, diag = jax.block_until_ready(fn(state))
    print(f"compile+first substep: {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    for i in range(N_STEPS - 1):
        state, diag = fn(state)
    jax.block_until_ready(state)
    print(
        f"{N_STEPS} substeps total; steady "
        f"{(time.time()-t0)/max(N_STEPS-1,1)*1e3:.0f} ms/substep "
        f"cg={int(diag.pressure_iterations)} vmax={float(diag.max_velocity):.0f}",
        flush=True,
    )
    pos = np.asarray(state.position)
    act = np.asarray(state.active)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    np.savez(cache, position=pos, active=act)
    return pos, act


def main():
    position, active = _particles()

    # 128^3 sampling of the 256-unit domain: meshing at half the sim
    # resolution, as the reference's testbed meshes 104^3 nodes at cell 0.5
    # over its 50^3 sim (testbed/main.cpp:219-223)
    mcfg = MesherConfig(
        grid_size=(128, 128, 128), cell_size=2.0, max_triangles=1 << 20,
        particle_extent=4.0, particle_radius=1.0,
    )
    t0 = time.time()
    mesh = jax.jit(lambda p, a: generate_mesh(p, a, mcfg))(
        jnp.asarray(position), jnp.asarray(active)
    )
    nv = int(np.asarray(jnp.sum(mesh.valid)))
    print(f"mesh: {nv} tris in {time.time()-t0:.0f}s", flush=True)

    # host-side: compact the mesh and build the scene + accelerator
    verts = np.asarray(mesh.vertices)[np.asarray(mesh.valid)]  # (T, 3, 3)
    builder, cam = scenes.fluid_box((0.0, 0.0, 0.0), (256.0, 256.0, 256.0))
    water = builder.lambertian((0.35, 0.55, 0.8))
    pos = verts.reshape(-1, 3)
    idx = np.arange(pos.shape[0], dtype=np.int32).reshape(-1, 3)
    builder.add_mesh(pos, idx, water)
    scene = builder.finish()
    t0 = time.time()
    # 64^3 accel cells (4 units): the hero surface is a thin sheet in a
    # large open room, where coarse cells keep the traversal short
    scene = scene._replace(accel=accel_mod.build(scene, res=(64, 64, 64)))
    print(f"accel built in {time.time()-t0:.0f}s", flush=True)

    rcfg = RenderConfig(
        width=SIZE, height=SIZE, samples_per_pixel=SPP, max_bounces=5,
    )
    fn = jax.jit(render, static_argnums=(2,))
    t0 = time.time()
    img = np.asarray(fn(scene, cam, rcfg, jax.random.PRNGKey(1000)))
    print(
        f"render {SIZE}^2 x {SPP}spp: {time.time()-t0:.0f}s "
        f"mean={img.mean():.3f}",
        flush=True,
    )
    out = os.path.join(_ROOT, "renders", "tide256.ppm")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_ppm(out, img, gamma=2.2)
    print("wrote", out, flush=True)


if __name__ == "__main__":
    main()
