"""Sharded simulation/render steps and the end-to-end training step.

The scaling layout (SURVEY.md §2 P1-P12):
- particle SoA arrays sharded over the 'dp' mesh axis (each device owns a
  slice; P2G scatter-adds into a device-local grid that GSPMD all-reduces),
- the grid replicated at this scale (z-tiled halo pressure in
  :mod:`libfluid_tpu.parallel.halo` takes over at 256^3+),
- camera rays sharded over 'dp' (one global wavefront, sharding-constrained),
- gradients all-reduced by the ``psum`` transposes GSPMD inserts in backward.

``training_step`` is the framework's "training" analog: differentiable
physics — optimize initial particle velocities against a pixel-space loss on
the rendered end state, with gradients flowing
image -> sphere proxies at particle positions -> G2P -> pressure solve
(implicit adjoint) -> P2G -> initial velocities.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libfluid_tpu.config import RenderConfig, SimConfig
from libfluid_tpu.parallel.mesh import grid_sharding_z, particle_sharding, replicated
from libfluid_tpu.renderer.camera import Camera
from libfluid_tpu.renderer.pathtrace import trace_rays
from libfluid_tpu.renderer.scene import Scene
from libfluid_tpu.sim.state import SimState
from libfluid_tpu.sim.step import substep


def shard_sim_state(
    state: SimState, mesh: Mesh, shard_grid: bool | None = None
) -> SimState:
    """Place particle arrays sharded over 'dp' and — when the grid is tall
    enough — the grid/solid arrays z-sharded over the same axis.

    With a z-sharded grid, GSPMD turns every pressure/extrapolation stencil
    into halo exchanges (``lax.ppermute``) and the CG dot products
    into ``psum``s — the SP/CP slot of SURVEY §5 driven end-to-end through
    the production substep rather than the replicated-grid fallback. The
    hand-written shard_map kernels in :mod:`libfluid_tpu.parallel.halo`
    remain the explicit-layout reference implementation for the same math.
    """
    psh = particle_sharding(mesh)
    rep = replicated(mesh)
    ndev = mesh.devices.size
    nz = state.grid.u.shape[2]
    ny = state.grid.u.shape[1]
    if shard_grid is None:
        # z tiles thinner than ~4 cells spend more on halos than stencils
        shard_grid = ndev > 1 and nz >= 4 * ndev and ny >= ndev
    if shard_grid:
        gsh = grid_sharding_z(mesh)
        # the z-face array has nz+1 layers (indivisible); it rides sharded
        # along y instead — GSPMD reshards it where stencils mix axes
        wsh = NamedSharding(mesh, P(None, "dp", None))
    else:
        gsh = wsh = rep

    grid = state.grid._replace(
        u=jax.device_put(state.grid.u, gsh),
        v=jax.device_put(state.grid.v, gsh),
        w=jax.device_put(state.grid.w, wsh),
        cell_type=jax.device_put(state.grid.cell_type, gsh),
    )
    return SimState(
        position=jax.device_put(state.position, psh),
        velocity=jax.device_put(state.velocity, psh),
        affine=jax.device_put(state.affine, psh),
        active=jax.device_put(state.active, psh),
        grid=grid,
        solid=jax.device_put(state.solid, gsh),
        sources=jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), state.sources),
        key=jax.device_put(state.key, rep),
        time=jax.device_put(state.time, rep),
        pressure=jax.device_put(state.pressure, gsh),
    )


def sharded_substep(state: SimState, cfg: SimConfig, dt, mesh: Mesh):
    """jit-compiled substep, explicitly sharded: particles owner-distributed
    by z-slab, grid z-tiled, all communication hand-placed
    (:mod:`libfluid_tpu.parallel.zshard`). `state` is redistributed first."""
    from libfluid_tpu.parallel.zshard import substep_z, zshard_state

    st = zshard_state(state, cfg, mesh)
    fn = jax.jit(lambda s: substep_z(s, cfg, dt, mesh))
    return fn(st)


def sharded_render(
    scene: Scene, camera: Camera, cfg: RenderConfig, key, mesh: Mesh
) -> jnp.ndarray:
    """Render with rays sharded over 'dp' (ref ``rendering.h`` OpenMP rows).

    The camera rays are one global batch whose leading axis is constrained
    to 'dp', so each device traces H*W/n of them. Threefry's partitionable
    mode (JAX's default) makes every random draw independent of how the
    batch is sharded, so the image is the same for any device count up to
    float reassociation.
    """
    w, h = cfg.width, cfg.height
    px = jnp.arange(w, dtype=jnp.float32)
    py = jnp.arange(h, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(px, py, indexing="xy")
    rays = NamedSharding(mesh, P("dp"))
    base = jax.lax.with_sharding_constraint(
        jnp.stack([gx, gy], axis=-1).reshape(-1, 2), rays
    )
    inv = jnp.asarray([1.0 / w, 1.0 / h], jnp.float32)

    acc = jnp.zeros((w * h, 3), jnp.float32)
    for s in range(cfg.samples_per_pixel):
        k1, k2 = jax.random.split(jax.random.fold_in(key, s))
        sp = (base + jax.random.uniform(k1, base.shape)) * inv
        o, d = camera.get_rays(sp)
        o = jax.lax.with_sharding_constraint(o, rays)
        d = jax.lax.with_sharding_constraint(d, rays)
        acc = acc + trace_rays(scene, o, d, k2, cfg)
    return (acc / cfg.samples_per_pixel).reshape(h, w, 3)


def _spheres_at(scene: Scene, centers: jnp.ndarray, radius: float) -> Scene:
    """Differentiable scene update: place the scene's S spheres at `centers`
    (S, 3) with uniform `radius` — the proxy geometry linking particle state
    to pixels without the mesher in the loop."""
    s = centers.shape[0]
    eye = jnp.eye(3, dtype=centers.dtype) * radius
    inv_eye = jnp.eye(3, dtype=centers.dtype) / radius
    to_world = jnp.concatenate(
        [jnp.broadcast_to(eye, (s, 3, 3)), centers[:, :, None]], axis=-1
    )
    to_local = jnp.concatenate(
        [jnp.broadcast_to(inv_eye, (s, 3, 3)), -centers[:, :, None] / radius], axis=-1
    )
    return scene._replace(sph_to_world=to_world, sph_to_local=to_local)


def training_step(
    state: SimState,
    scene: Scene,
    camera: Camera,
    target_image: jnp.ndarray,
    cfg: SimConfig,
    rcfg: RenderConfig,
    mesh: Mesh,
    dt: float,
    lr: float = 1e-2,
    sphere_radius: float = 0.5,
) -> Tuple[SimState, jnp.ndarray]:
    """One differentiable-physics optimization step on initial velocities.

    The scene must have been built with S placeholder spheres; the first S
    active particles become sphere proxies for rendering. Returns the state
    with updated velocities and the scalar loss.
    """
    nspheres = scene.sph_mat.shape[0]

    def loss_fn(vel):
        st = state._replace(velocity=vel)
        st, _ = substep(st, cfg, dt)
        centers = st.position[:nspheres]
        sc = _spheres_at(scene, centers, sphere_radius)
        img = sharded_render(sc, camera, rcfg, st.key, mesh)
        return jnp.mean((img - target_image) ** 2), st

    (loss, st), grad = jax.value_and_grad(loss_fn, has_aux=True)(state.velocity)
    new_vel = state.velocity - lr * grad
    return st._replace(velocity=new_vel), loss
