"""Smoke test of the whole system on one NVIDIA GPU.

Drives the simulator, mesher and renderer through the entry points a user
calls, at the sizes the repository claims, checks every result, and times
each phase:

1. device: a GPU must be present (no CPU carry-on);
2. testbed: ``python -m libfluid_tpu.testbed`` setup 0 (the reference's
   50^3 dam break), 5 frames through ``sim.step`` (the block meets the
   floor in the fourth), meshed every frame and rendered once;
3. the 128^3 APIC dam break (2.0M particles, K=12) through ``jax.jit(substep)``:
   cold compile, ``memory_analysis()``, steady ms/substep;
4. the Pallas GPU correction kernel against its jnp oracle on the phase-3
   slot payload, and the springs' time with either;
5. one 32^3 substep on the GPU against the same substep on the CPU;
6. Cornell and glass renders against the committed goldens, and Cornell
   rays/s;
7. one differentiable ``parallel.training_step`` on a 1-device mesh.

``--four`` runs only the multi-card paths on four GPUs of one host: the
z-sharded ``substep_z`` at 128^3 against the dense substep on card 0, and
the sharded ``training_step`` against the same step on one card.

The programs of all phases compile side by side on worker threads from the
start, while the testbed runs.

Usage: ``python chip_smoke.py [--four]``. The last line of standard output
is one JSON object: ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is non-zero and no such line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

# the CPU reference of phase 5 runs in this process beside the GPU
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
DT = 0.02  # substep of the 128^3 dam break (bench.py)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def compile_later(fn, *args) -> Future:
    """A future of (``jax.jit(fn)`` compiled for `args`, compile seconds).

    XLA's GPU compile of a substep program takes minutes whatever the grid
    size, so every phase's programs compile side by side on daemon threads
    while the first phases run; a compile time is thus taken alongside the
    others. A failed compile raises from ``result()``."""
    fut: Future = Future()

    def work():
        try:
            t0 = time.perf_counter()
            exe = jax.jit(fn).lower(*args).compile()
            fut.set_result((exe, time.perf_counter() - t0))
        except BaseException as e:  # handed to the phase that waits on it
            fut.set_exception(e)

    threading.Thread(target=work, daemon=True).start()
    return fut


def match_particles(a: np.ndarray, b: np.ndarray):
    """Pair two equally sized particle sets whose orders differ: for each
    particle of `a` the index of its nearest neighbour in `b`, and the
    largest distance from a particle of either set to the other set."""
    from scipy.spatial import cKDTree

    check(a.shape == b.shape, f"particle sets differ in size: {a.shape} vs {b.shape}")
    d_ab, idx = cKDTree(b).query(a)
    d_ba, _ = cKDTree(a).query(b)
    return idx, float(max(d_ab.max(), d_ba.max()))


def active_positions(state) -> np.ndarray:
    return np.asarray(state.position)[np.asarray(state.active)]


def active_velocities(state) -> np.ndarray:
    return np.asarray(state.velocity)[np.asarray(state.active)]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device():
    t0 = time.perf_counter()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind})",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    from libfluid_tpu.cache import enable_persistent_cache

    cache_dir = enable_persistent_cache()
    log(f"card: {smi.stdout.strip()}")
    log(f"phase 1 device: ok  {dev.device_kind} x{len(jax.devices())}  "
        f"compile cache {cache_dir}  ({time.perf_counter() - t0:.1f} s)")
    return dev


def phase_testbed():
    from libfluid_tpu.testbed.__main__ import main as testbed_main

    t0 = time.perf_counter()
    out_dir = os.path.join(REPO, "out", "smoke_testbed")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = testbed_main([
            "--setup", "0", "--frames", "5", "--mesh-every", "1",
            "--render-every", "5", "--out", out_dir,
        ])
    text = buf.getvalue()
    check(rc == 0, f"testbed returned {rc}:\n{text}")
    counts = [int(v) for v in re.findall(r"particles = (\d+)", text)]
    iters = [int(v) for v in re.findall(r"iterations = (\d+)", text)]
    resid = [float(v) for v in re.findall(r"residual = (\S+)", text)]
    check(len(counts) == 5 and len(set(counts)) == 1,
          f"testbed particle counts {counts}")
    # the block falls freely for three frames (nothing to solve, so 0
    # iterations) and meets the floor in the fourth
    check(len(iters) == 5 and max(iters) >= 1 and max(iters) < 200
          and max(resid) < 1e-5,
          f"testbed PCG residuals {resid} iterations {iters}")
    check(os.path.exists(os.path.join(out_dir, "frame_00004.ppm")),
          "testbed wrote no render")
    frame_ms = re.findall(r"frame \d+  \((\d+) ms", text)
    mesh_ms = re.findall(r"mesh: (\d+) triangles \((\d+) ms", text)
    log(f"phase 2 testbed: ok  setup 0, 5 frames, {counts[0]} particles, "
        f"PCG iterations {iters} residual max {max(resid):.2e}, frame ms "
        f"{frame_ms} (the first compiles), mesh (triangles, ms) {mesh_ms}  "
        f"({time.perf_counter() - t0:.1f} s)")


def dam_break_128():
    """The 128^3 APIC dam break of bench.py: 2.0M particles, K=12."""
    from libfluid_tpu.config import SimConfig, TransferScheme
    from libfluid_tpu.sim import new_state, seed_box

    cfg = SimConfig(
        grid_size=(128, 128, 128), cell_size=1.0, gravity=(0.0, -981.0, 0.0),
        particle_capacity=1 << 21, scheme=TransferScheme.APIC,
        has_obstacles=False,
    )
    state = new_state(cfg, jax.random.PRNGKey(0))
    state = seed_box(state, cfg, (1.0, 1.0, 1.0), (63.0, 63.0, 63.0))
    return cfg, state


def check_substep(cfg, state, diag, n0: int, what: str) -> None:
    count = int(diag.particle_count)
    check(count == n0, f"{what}: particle count {count} != {n0}")
    check(float(diag.pressure_residual) < 1e-5
          and int(diag.pressure_iterations) < cfg.solver.max_iterations,
          f"{what}: CG residual {float(diag.pressure_residual):.2e} after "
          f"{int(diag.pressure_iterations)} iterations")
    check(np.isfinite(float(diag.max_velocity)), f"{what}: vmax not finite")
    # the repo's own end-to-end bound (tests/test_sim_e2e.py)
    check(float(diag.max_divergence) < 1e-2,
          f"{what}: max divergence {float(diag.max_divergence):.2e}")
    pos = active_positions(state)
    # the wall push-out lands particles on the skin up to float32 rounding
    skin = cfg.boundary_skin_width - 1e-4 * cfg.cell_size
    lo = np.asarray(cfg.domain_min) + skin
    hi = np.asarray(cfg.domain_max) - skin
    check(np.isfinite(pos).all() and (pos >= lo).all() and (pos <= hi).all(),
          f"{what}: positions leave [{lo}, {hi}]: {pos.min(0)} {pos.max(0)}")


def time_substeps(fn, state, n: int = 5):
    """Mean seconds per substep over `n` chained substeps after one warm
    call, ending in block_until_ready."""
    state, _ = jax.block_until_ready(fn(state))
    t0 = time.perf_counter()
    for _ in range(n):
        state, diag = fn(state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / n, state, diag


def time_calls(fn, *args, n: int = 5) -> float:
    """Mean seconds per call over `n` calls after one warm call."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def prepare_sim128():
    from libfluid_tpu.sim import substep

    cfg, state = dam_break_128()
    return cfg, state, compile_later(lambda s: substep(s, cfg, DT), state)


def phase_sim128(cfg, state, program):
    t0 = time.perf_counter()
    n0 = int(jnp.sum(state.active))
    compiled, compile_s = program.result()
    mem = compiled.memory_analysis()
    (state, diag), first_s = timed(compiled, state)
    check_substep(cfg, state, diag, n0, "128^3 first substep")
    per, state, diag = time_substeps(compiled, state, 5)
    check_substep(cfg, state, diag, n0, "128^3 steady substeps")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    gb = 1 << 30
    log(f"phase 3 sim128: ok  {n0} particles  cold compile {compile_s:.1f} s "
        f"(alongside other phases' compiles)  first {first_s * 1e3:.1f} ms  "
        f"steady {per * 1e3:.2f} ms/substep "
        f"(5 substeps)  CG {int(diag.pressure_iterations)} it res "
        f"{float(diag.pressure_residual):.2e}  vmax {float(diag.max_velocity):.1f}  "
        f"div {float(diag.max_divergence):.2e}  memory: args "
        f"{mem.argument_size_in_bytes / gb:.2f} GB temps "
        f"{mem.temp_size_in_bytes / gb:.2f} GB out "
        f"{mem.output_size_in_bytes / gb:.2f} GB peak {peak / gb:.2f} GB  "
        f"({time.perf_counter() - t0:.1f} s)")
    return state, per


def prepare_kernel(cfg, state):
    """Programs for the K=12 resident slot payload of a 128^3 state and the
    springs on it, by the kernel and by the jnp oracle."""
    from libfluid_tpu.sim import correction, slotsort

    kc = cfg.correction_capacity
    re2 = cfg.cell_size ** 2 / 2.0
    seed, origin = jnp.int32(12345), jnp.zeros((3,), jnp.int32)

    def payload(s):
        sg = slotsort.sort_and_build(s, cfg).slot_grid
        return sg.position[:, :kc], sg.mask[:kc]

    shapes = jax.eval_shape(payload, state)
    return {
        "payload": compile_later(payload, state),
        "kernel": compile_later(lambda p, m: correction._springs_triton(
            p, m, re2, seed, cfg, origin), *shapes),
        "jnp": compile_later(lambda p, m: correction._springs_jnp(
            p, m, re2, seed, cfg, origin=origin), *shapes),
    }


def phase_kernel(cfg, state, programs, substep_s: float):
    t0 = time.perf_counter()
    payload, kernel, oracle = (programs[k].result()[0]
                               for k in ("payload", "kernel", "jnp"))
    res_pos, res_mask = payload(state)
    want, got = oracle(res_pos, res_mask), kernel(res_pos, res_mask)
    # springs = pos*wsum - wnbr cancels catastrophically and the card sums
    # in another order: normalise by the |pos|*wsum scale
    scale = float(jnp.max(jnp.abs(res_pos))) * 100.0
    err = float(jnp.max(jnp.abs(got - want))) / scale
    check(err < 2e-6, f"correction kernel vs oracle: normalised error {err:.2e}")
    times = {"kernel": [], "jnp": []}
    for name in ("kernel", "jnp", "jnp", "kernel"):
        fn = kernel if name == "kernel" else oracle
        times[name].append(time_calls(fn, res_pos, res_mask))
    k_ms = 1e3 * min(times["kernel"])
    j_ms = 1e3 * min(times["jnp"])
    log(f"phase 4 kernel: ok  correction kernel vs oracle normalised error "
        f"{err:.2e} (< 2e-6) on the 128^3 K={res_mask.shape[0]} payload  "
        f"springs with kernel {k_ms:.2f} ms, jnp springs {j_ms:.2f} ms (best "
        f"of 2 x 5)  substep with kernel {substep_s * 1e3:.2f} ms  "
        f"({time.perf_counter() - t0:.1f} s)")


def prepare_cpu_reference():
    """A 32^3 APIC state and its substep compiled for the card and for the
    CPU of this process."""
    from libfluid_tpu.config import SimConfig, TransferScheme
    from libfluid_tpu.sim import new_state, seed_box, substep

    cfg = SimConfig(
        grid_size=(32, 32, 32), gravity=(0.0, -981.0, 0.0),
        particle_capacity=1 << 16, scheme=TransferScheme.APIC,
        has_obstacles=False,
    )
    state = new_state(cfg, jax.random.PRNGKey(3))
    state = seed_box(state, cfg, (1.0, 1.0, 1.0), (15.0, 15.0, 15.0))

    def fn(s):
        return substep(s, cfg, DT)

    cpu = jax.device_put(state, jax.devices("cpu")[0])
    return cfg, state, compile_later(fn, state), compile_later(fn, cpu)


def phase_cpu_reference(cfg, state, gpu_program, cpu_program):
    t0 = time.perf_counter()
    gpu_fn, cpu_fn = gpu_program.result()[0], cpu_program.result()[0]
    for _ in range(3):  # get the fluid moving first
        state, _ = gpu_fn(state)
    cpu = jax.devices("cpu")[0]
    ref_state, ref_diag = jax.block_until_ready(cpu_fn(jax.device_put(state, cpu)))
    out_state, out_diag = jax.block_until_ready(gpu_fn(state))
    check(out_state.position.devices() == {jax.devices()[0]}
          and ref_state.position.devices() == {cpu}, "substeps ran elsewhere")
    n_ref, n_out = int(ref_diag.particle_count), int(out_diag.particle_count)
    check(n_ref == n_out, f"particle count GPU {n_out} vs CPU {n_ref}")
    it_ref, it_out = int(ref_diag.pressure_iterations), int(out_diag.pressure_iterations)
    check(abs(it_ref - it_out) <= 2, f"CG iterations GPU {it_out} vs CPU {it_ref}")
    # float32 sums in another order (atomic scatter-adds on the card) and a
    # CG stopped at a 1e-6 residual move particles by far less than 1e-3
    # cells per substep; a wrong stage moves them by a good part of a cell
    tol = 1e-3 * cfg.cell_size
    _, dist = match_particles(active_positions(ref_state), active_positions(out_state))
    check(dist < tol, f"GPU vs CPU positions differ by {dist:.2e} > {tol:.0e}")
    log(f"phase 5 cpu-reference: ok  32^3, {n_out} particles, CG {it_out} vs "
        f"{it_ref} it, positions within {dist:.2e} (< {tol:.0e} cells)  "
        f"({time.perf_counter() - t0:.1f} s)")


def _psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    peak = float(max(a.max(), b.max(), 1e-6))
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def phase_render():
    from libfluid_tpu.config import RenderConfig
    from libfluid_tpu.renderer import scenes
    from libfluid_tpu.renderer.pathtrace import trace_persistent
    from libfluid_tpu.renderer.render import render

    t0 = time.perf_counter()
    rcfg = RenderConfig(width=64, height=64, samples_per_pixel=128, max_bounces=5)
    stats = []
    for name, mk in (("cornell", scenes.cornell_box_one_light),
                     ("glass", scenes.glass_ball_box)):
        golden = np.load(os.path.join(REPO, "tests", "golden", f"{name}_64.npz"))["img"]
        b, cam = mk(1.0)
        scene = b.finish()
        img = np.asarray(jax.jit(lambda k: render(scene, cam, rcfg, k))(
            jax.random.PRNGKey(7)))
        p = _psnr(img, golden)
        rel = abs(img.mean() / golden.mean() - 1.0)
        check(np.isfinite(img).all() and p > 26.0 and rel < 0.03,
              f"{name} render vs golden: PSNR {p:.1f} dB, mean off {rel:.3f}")
        stats.append(f"{name} PSNR {p:.1f} dB mean {rel * 100:.2f}% off")

    b, cam = scenes.cornell_box_one_light(1.0)
    scene = b.finish()
    cfg = RenderConfig(width=256, height=256, samples_per_pixel=32,
                       max_bounces=5, differentiable=False)
    fn = jax.jit(lambda k: trace_persistent(scene, cam, cfg, k, True))
    jax.block_until_ready(fn(jax.random.PRNGKey(0)))
    (img, cast), dt = timed(fn, jax.random.PRNGKey(1))
    check(np.isfinite(np.asarray(img)).all(), "Cornell 256^2 render not finite")
    log(f"phase 6 render: ok  {'; '.join(stats)}  Cornell 256^2x32spp "
        f"{dt * 1e3:.1f} ms, {int(cast)} rays cast = {int(cast) / dt / 1e6:.1f} "
        f"Mrays/s  ({time.perf_counter() - t0:.1f} s)")


def training_setup():
    """The __graft_entry__ dry run's grid (16x16x32, APIC) and render
    (16^2, 1 spp, 2 bounces) with four sphere proxies of radius 2 in
    mid-room. The proxies glow through a smooth emission texture, so the
    pixels they cover depend continuously on their centres: glass proxies,
    as in the dry run, give this estimator an exactly zero gradient (it
    does not differentiate visibility, and no path through them reaches a
    light in 2 bounces)."""
    from libfluid_tpu.config import RenderConfig, SimConfig, TransferScheme
    from libfluid_tpu.renderer import scenes
    from libfluid_tpu.sim import new_state, seed_box

    cfg = SimConfig(
        grid_size=(16, 16, 32), gravity=(0.0, -10.0, 0.0),
        particle_capacity=1 << 12, scheme=TransferScheme.APIC,
    )
    state = new_state(cfg, jax.random.PRNGKey(0))
    state = seed_box(state, cfg, (5.0, 4.0, 12.0), (6.0, 6.0, 6.0))
    builder, cam = scenes.fluid_box((0.0, 0.0, 0.0), (16.0, 16.0, 32.0), aspect=1.0)
    ramp = np.linspace(0.0, 1.0, 8)
    texture = np.stack([*np.meshgrid(ramp, ramp, indexing="ij"), np.full((8, 8), 0.5)], -1)
    glow = builder.lambertian((0.5, 0.5, 0.5), emission=(4.0, 4.0, 4.0),
                              emission_tex=builder.add_texture(texture))
    for _ in range(4):
        builder.add_sphere(jnp.zeros((3, 4)) + jnp.eye(3, 4), glow)
    scene = builder.finish()
    rcfg = RenderConfig(width=16, height=16, samples_per_pixel=1, max_bounces=2)
    return cfg, state, scene, cam, rcfg, jnp.zeros((16, 16, 3))


def prepare_training(n_devices: int, lr: float = 1e-2):
    """One training_step on the first `n_devices` cards, compiling."""
    from libfluid_tpu.parallel import make_mesh, shard_sim_state, training_step

    cfg, state, scene, cam, rcfg, target = training_setup()
    mesh = make_mesh(n_devices)
    sharded = shard_sim_state(state, mesh)
    program = compile_later(lambda st: training_step(
        st, scene, cam, target, cfg, rcfg, mesh, dt=1.0 / 60.0, lr=lr,
        sphere_radius=2.0), sharded)
    return state, sharded, program, lr


def run_training(prepared):
    """(loss, gradient w.r.t. the initial velocities, new state)."""
    state, sharded, program, lr = prepared
    new_state, loss = jax.block_until_ready(program.result()[0](sharded))
    grad = (np.asarray(state.velocity) - np.asarray(new_state.velocity)) / lr
    return float(loss), grad, new_state


def phase_training(prepared):
    t0 = time.perf_counter()
    loss, grad, _ = run_training(prepared)
    check(np.isfinite(loss), f"training loss {loss}")
    check(np.isfinite(grad).all(), "training gradient not finite")
    check(np.abs(grad).max() > 0.0, "training gradient all zero")
    log(f"phase 7 training: ok  loss {loss:.6g}  |grad|max "
        f"{np.abs(grad).max():.3e}  ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------


def prepare_four_zshard():
    """The seeded 128^3 dam break, its dense substep for card 0 and its
    z-sharded substep over four cards, compiling."""
    from libfluid_tpu.parallel import make_mesh, substep_z, zshard_state
    from libfluid_tpu.sim import substep

    cfg, state = dam_break_128()
    mesh = make_mesh(4)
    zs = zshard_state(state, cfg, mesh)
    return (cfg, state, zs,
            compile_later(lambda s: substep(s, cfg, DT), state),
            compile_later(lambda s: substep_z(s, cfg, DT, mesh), zs))


def phase_four_zshard(cfg, state, zs, dense_program, z_program):
    """One substep from the seeded 128^3 dam break. From rest no cell holds
    more than the K=12 slots; later, cells past capacity at a slab seam
    differ by design (the ghost exchange carries no overflow rows, see
    zshard's P2G), so the comparison is made before any compression."""
    t0 = time.perf_counter()
    n0 = int(jnp.sum(state.active))
    for name in ("position", "active"):
        devs = {s.device for s in getattr(zs, name).addressable_shards}
        check(len(devs) == 4, f"zshard {name} lives on {devs}")
    dense, zstep = dense_program.result()[0], z_program.result()[0]
    ref_state, ref_diag = jax.block_until_ready(dense(state))
    check_substep(cfg, ref_state, ref_diag, n0, "dense 128^3 substep on card 0")
    check(int(ref_diag.overflow_count) == 0, "the seeded state overflows its slots")
    out_state, out_diag = jax.block_until_ready(zstep(zs))
    devs = {s.device for s in out_state.position.addressable_shards}
    check(len(devs) == 4, f"substep_z output lives on {devs}")
    check(int(out_diag.particle_count) == n0,
          f"substep_z particle count {int(out_diag.particle_count)} != {n0}")
    check(int(out_diag.particles_lost) == 0, "substep_z lost particles")
    check(abs(int(out_diag.pressure_iterations) - int(ref_diag.pressure_iterations)) <= 2,
          f"CG iterations z-sharded {int(out_diag.pressure_iterations)} vs "
          f"dense {int(ref_diag.pressure_iterations)}")
    # the z-sharded program does the same arithmetic in another order and
    # each device sorts its own particles: 1e-3 cells and 1e-3 of the
    # largest speed are far above float32 reassociation and far below what
    # a wrong stage changes
    tol = 1e-3 * cfg.cell_size
    idx, dist = match_particles(active_positions(ref_state), active_positions(out_state))
    check(dist < tol, f"substep_z vs dense positions differ by {dist:.2e} > {tol:.0e}")
    vref = active_velocities(ref_state)
    verr = float(np.abs(active_velocities(out_state)[idx] - vref).max())
    vtol = 1e-3 * float(np.abs(vref).max())
    check(verr < vtol, f"substep_z vs dense velocities differ by {verr:.2e} > {vtol:.2e}")
    # three more substeps exercise the sharded pressure solve, which the
    # first substep from rest barely needs
    per, _, diag3 = time_substeps(zstep, out_state, 3)
    check(int(diag3.particle_count) == n0 and int(diag3.particles_lost) == 0,
          f"substep_z later: {int(diag3.particle_count)} particles, "
          f"{int(diag3.particles_lost)} lost")
    check(float(diag3.pressure_residual) < 1e-5
          and int(diag3.pressure_iterations) < cfg.solver.max_iterations
          and np.isfinite(float(diag3.max_velocity)),
          f"substep_z later: CG residual {float(diag3.pressure_residual):.2e} "
          f"after {int(diag3.pressure_iterations)} iterations")
    log(f"four zshard: ok  128^3 {n0} particles on {len(devs)} cards, CG "
        f"{int(out_diag.pressure_iterations)} vs {int(ref_diag.pressure_iterations)} "
        f"it, positions within {dist:.2e} (< {tol:.0e} cells) and velocities "
        f"within {verr:.2e} (< {vtol:.2e}) of the dense substep on card 0  "
        f"substep_z {per * 1e3:.2f} ms/substep (3 substeps, last CG "
        f"{int(diag3.pressure_iterations)} it)  "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_four_training(one, four):
    t0 = time.perf_counter()
    loss1, grad1, _ = run_training(one)
    loss4, grad4, st4 = run_training(four)
    devs = {s.device for s in st4.position.addressable_shards}
    check(len(devs) == 4, f"sharded training state lives on {devs}")
    # the same program partitioned four ways: float32 reassociation only
    # (threefry draws do not depend on the sharding)
    check(np.isfinite(loss4) and abs(loss4 - loss1) <= 1e-4 * abs(loss1),
          f"training loss 4 cards {loss4} vs 1 card {loss1}")
    gerr = float(np.abs(grad4 - grad1).max()) / float(np.abs(grad1).max())
    check(gerr < 1e-3, f"training gradient 4 vs 1 card: relative error {gerr:.2e}")
    log(f"four training: ok  loss {loss4:.6g} vs {loss1:.6g} on one card, "
        f"gradient relative error {gerr:.2e} (< 1e-3)  "
        f"({time.perf_counter() - t0:.1f} s)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card paths")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    dev = phase_device()
    if args.four:
        check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, found {len(jax.devices())}")
        zshard = prepare_four_zshard()
        training = prepare_training(1), prepare_training(4)
        phase_four_zshard(*zshard)
        del zshard
        phase_four_training(*training)
    else:
        cfg, state, sim_program = prepare_sim128()
        kernel_programs = prepare_kernel(cfg, state)
        reference = prepare_cpu_reference()
        training = prepare_training(1)
        phase_testbed()
        state, substep_s = phase_sim128(cfg, state, sim_program)
        phase_kernel(cfg, state, kernel_programs, substep_s)
        del state, sim_program, kernel_programs
        phase_cpu_reference(*reference)
        phase_render()
        phase_training(training)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
