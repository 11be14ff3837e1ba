"""Headless testbed CLI.

Reproduces the reference testbed's frame loop (``testbed/main.cpp:125-197``:
``sim.update(1/60)`` per frame with per-step diagnostics) and its export hooks
(F3 mesh.obj, F4 points.txt, F5 800x800 400spp offline render -> test.ppm;
``main.cpp:328-347,429-453``) as command-line flags.

Examples:
    python -m libfluid_tpu.testbed --setup 0 --frames 60
    python -m libfluid_tpu.testbed --setup 2 --frames 10 --mesh-every 5 \
        --render-every 5 --out out/tb
    python -m libfluid_tpu.testbed --scene cornell1 --offline-render --out out/tb
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _log(*a):
    print(*a, flush=True)


def run_sim(args) -> int:
    import jax
    import jax.numpy as jnp

    from libfluid_tpu.config import RenderConfig
    from libfluid_tpu.io.obj import save_obj
    from libfluid_tpu.io.point_cloud import save_points
    from libfluid_tpu.io.ppm import save_ppm
    from libfluid_tpu.mesher.marching_cubes import generate_mesh
    from libfluid_tpu.renderer.render import render
    from libfluid_tpu.sim import step
    from libfluid_tpu.testbed import (
        SETUP_NAMES,
        build_setup,
        default_mesher_config,
        fluid_render_scene,
    )

    cfg, state = build_setup(args.setup, seed=args.seed)
    _log(f"setup {args.setup}: {SETUP_NAMES[args.setup]}")
    _log(
        f"grid {cfg.grid_size} cell {cfg.cell_size} scheme {cfg.scheme.value} "
        f"capacity {cfg.particle_capacity}"
    )
    _log(f"devices: {jax.devices()}")

    os.makedirs(args.out, exist_ok=True)
    frame_dt = 1.0 / args.fps

    step_fn = jax.jit(lambda s: step(s, cfg, frame_dt))
    mesher_cfg = default_mesher_config()
    mesh_fn = jax.jit(
        lambda p, a: generate_mesh(p, a, mesher_cfg, mesher_cfg.particle_radius)
    )
    rcfg = RenderConfig(
        width=args.render_size,
        height=args.render_size,
        samples_per_pixel=args.spp,
        algorithm=args.algorithm,
    )
    render_fn = jax.jit(render, static_argnums=(2,))
    render_key = jax.random.PRNGKey(args.seed + 1)

    t_start = time.time()
    for frame in range(args.frames):
        t0 = time.time()
        state, diag = step_fn(state)
        jax.block_until_ready(state.position)
        wall = time.time() - t0
        # the reference's per-step diagnostics (main.cpp:54-59,101-123)
        _log(f"frame {frame}  ({wall * 1e3:.0f} ms, {int(diag.substeps)} substeps)")
        _log(f"    total energy: {float(diag.kinetic_energy + diag.potential_energy):.6g}")
        iters = int(diag.pressure_iterations)
        _log(f"    iterations = {iters}")
        if iters > 100:
            _log("*** WARNING: large number of iterations")
        _log(f"    residual = {float(diag.pressure_residual):.6g}")
        _log(f"    max pressure = {float(diag.max_pressure):.6g}")
        _log(f"    max particle velocity = {float(diag.max_velocity):.6g}")
        _log(f"    particles = {int(diag.particle_count)}")
        if not np.isfinite(float(diag.max_velocity)):
            _log("*** ERROR: simulation diverged (NaN velocity); aborting")
            return 1

        want_mesh = args.mesh_every and (frame + 1) % args.mesh_every == 0
        want_render = args.render_every and (frame + 1) % args.render_every == 0
        if want_mesh or want_render:
            t0 = time.time()
            mesh = jax.block_until_ready(mesh_fn(state.position, state.active))
            _log(
                f"    mesh: {int(mesh.count)} triangles ({(time.time() - t0) * 1e3:.0f} ms)"
            )
            if want_mesh:
                path = os.path.join(args.out, f"mesh_{frame:05d}.obj")
                save_obj(path, np.asarray(mesh.vertices), int(mesh.count))
                _log(f"    wrote {path}")
            if want_render:
                scene, cam = fluid_render_scene(
                    mesh, cfg, args.setup, aspect=1.0, tri_capacity=args.tri_capacity
                )
                render_key, sub = jax.random.split(render_key)
                t0 = time.time()
                img = jax.block_until_ready(render_fn(scene, cam, rcfg, sub))
                path = os.path.join(args.out, f"frame_{frame:05d}.ppm")
                save_ppm(path, np.asarray(img), gamma=2.2)
                _log(f"    rendered {path} ({time.time() - t0:.2f} s)")
        if args.points_every and (frame + 1) % args.points_every == 0:
            path = os.path.join(args.out, f"points_{frame:05d}.txt")
            save_points(path, np.asarray(state.position), np.asarray(state.active))
            _log(f"    wrote {path}")

    total = time.time() - t_start
    _log(f"done: {args.frames} frames in {total:.2f} s ({args.frames / total:.2f} fps)")
    return 0


def run_scene(args) -> int:
    """Static render of a canned scene (the reference's keys 1/2/3 + F5)."""
    import jax

    from libfluid_tpu.config import RenderConfig
    from libfluid_tpu.io.ppm import save_ppm
    from libfluid_tpu.renderer import scenes as scenes_mod
    from libfluid_tpu.renderer.render import render

    builders = {
        "redgreen": scenes_mod.red_green_box,
        "cornell1": scenes_mod.cornell_box_one_light,
        "cornell2": scenes_mod.cornell_box_two_lights,
        "glass": scenes_mod.glass_ball_box,
    }
    builder, cam = builders[args.scene](1.0)
    scene = builder.finish()
    size = 800 if args.offline_render else args.render_size
    spp = 400 if args.offline_render else args.spp
    rcfg = RenderConfig(
        width=size, height=size, samples_per_pixel=spp, algorithm=args.algorithm
    )
    _log(f"rendering {args.scene}: {size}x{size} @ {spp} spp ({args.algorithm})")
    t0 = time.time()
    img = jax.block_until_ready(
        jax.jit(render, static_argnums=(2,))(scene, cam, rcfg, jax.random.PRNGKey(args.seed))
    )
    wall = time.time() - t0
    rays = size * size * spp
    _log(f"render: {wall:.2f} s  ({rays / wall / 1e6:.2f} Mpaths/s)")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.scene}.ppm")
    save_ppm(path, np.asarray(img), gamma=2.2)
    _log(f"wrote {path}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m libfluid_tpu.testbed", description=__doc__
    )
    p.add_argument("--setup", type=int, default=0, help="sim scenario 0-4")
    p.add_argument("--scene", choices=["redgreen", "cornell1", "cornell2", "glass"],
                   help="render a static scene instead of simulating")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--fps", type=float, default=60.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="testbed_out")
    p.add_argument("--mesh-every", type=int, default=0, help="export OBJ every N frames")
    p.add_argument("--points-every", type=int, default=0, help="export points every N frames")
    p.add_argument("--render-every", type=int, default=0, help="render PPM every N frames")
    p.add_argument("--render-size", type=int, default=400)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--algorithm", choices=["pt", "bdpt"], default="pt")
    p.add_argument("--tri-capacity", type=int, default=1 << 17,
                   help="static triangle capacity for the fluid render scene")
    p.add_argument("--offline-render", action="store_true",
                   help="with --scene: 800x800 @ 400 spp like the reference's F5")
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="force the CPU backend with N virtual devices")
    args = p.parse_args(argv)
    if args.cpu:
        os.environ.setdefault(
            "XLA_FLAGS", f"--xla_force_host_platform_device_count={args.cpu}"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.scene:
        return run_scene(args)
    return run_sim(args)


if __name__ == "__main__":
    sys.exit(main())
