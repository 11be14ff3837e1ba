"""Frozen configuration dataclasses.

The reference exposes tunables as public mutable fields on each class
(``simulation.h:177-190``, ``pressure_solver.h:38-42``, ``mesher.h:27-31``,
``path_tracer.h:21``, ``bidirectional_path_tracer.h:18-21``). Here they are
frozen dataclasses so a config can be closed over by ``jax.jit`` as a static
argument; the field names and defaults mirror the reference 1:1 so parameter
sets port directly.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import jax.numpy as jnp


class TransferScheme(enum.Enum):
    """Particle<->grid transfer scheme (reference ``simulation.h:44-48``)."""

    PIC = "pic"
    FLIP = "flip_blend"
    APIC = "apic"


class CellType:
    """Cell-content markers (reference ``mac_grid.h:17-21``).

    Stored as an int8 grid; out-of-bounds lookups behave as SOLID
    (``mac_grid.cpp:30``).
    """

    AIR = 0
    FLUID = 1
    SOLID = 2


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Pressure-solver tunables (reference ``pressure_solver.h:38-42``).

    The reference uses a serial MIC(0)-preconditioned CG; here the
    preconditioner is an order-free, shardable geometric multigrid V-cycle
    (or plain Jacobi).
    """

    tolerance: float = 1e-6  # max-norm residual threshold (ref pressure_solver.h:41)
    max_iterations: int = 200  # ref pressure_solver.h:42
    preconditioner: str = "mg"  # "mg" (geometric V-cycle) or "jacobi"
    # dtype the V-cycle preconditioner runs in (the outer CG iteration stays
    # float32 either way; tolerance semantics are unchanged). bfloat16 halves
    # the V-cycle's bytes but costs CG iterations; float32 is the default.
    preconditioner_dtype: str = "float32"  # "float32" | "bfloat16"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulation tunables (reference ``simulation.h:177-190``).

    `grid_size` is the number of cells per axis (nx, ny, nz); the MAC arrays
    carry one extra face layer per axis. `particle_capacity` fixes the size of
    the particle SoA arrays (XLA requires static shapes); inactive slots are
    masked out everywhere.
    """

    grid_size: Tuple[int, int, int] = (50, 50, 50)
    cell_size: float = 1.0
    grid_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    gravity: Tuple[float, float, float] = (0.0, -981.0, 0.0)

    particle_capacity: int = 1 << 17

    scheme: TransferScheme = TransferScheme.APIC
    blending_factor: float = 1.0  # FLIP blend (ref simulation.h:180)
    cfl_number: float = 3.0
    density: float = 1.0
    boundary_skin_width: float = 0.1
    correction_stiffness: float = 5.0
    velocity_extrapolation_iterations: int = 3  # ref simulation.h:187 default 3
    seeding_density: int = 2  # particles-per-cell cube root (ref simulation.h:54)

    enable_position_correction: bool = True
    enable_collisions: bool = True
    max_neighbors_per_cell: int = 12  # cell-slot capacity; particles past
    # it ("overflow") are completed EXACTLY by a compacted scatter pass in
    # p2g_slots, so K trades dense-pass cost against compaction load rather
    # than correctness
    p2g_overflow_capacity: int = 4096  # compaction buffer for that pass.
    # Dam-break impacts transiently pile ~5% of particles past 16/cell; up to
    # this many are merged exactly. Beyond it the face average degrades to a
    # subsample mean in hyper-compressed cells (faces average their first K
    # particles) — a bounded estimator approximation, not a mass leak, since
    # P2G normalizes by total weight. Diagnostics.overflow_count reports it.
    correction_capacity: int = 12  # slots per cell joining the dense correction
    # springs pass. Defaults to max_neighbors_per_cell so EVERY slotted
    # particle is in the dense pass (the reference's neighborhood loop has no
    # cap at all, simulation.cpp:562-610) — the Newton's-third-law kernel
    # (kernels.correction_springs_triton) absorbs the KC^2 growth. Particles past it
    # (rank >= correction_capacity, i.e. slot overflow only at the default)
    # get their spring from a compacted per-particle gather pass against the
    # resident field — up to this many per substep (only >12-per-cell
    # compression reaches it):
    correction_overflow_capacity: int = 4096
    # z-shard particle-exchange ring-buffer capacity per direction (rows a
    # device can send up/down per substep). 0 = auto (half the device block).
    # Overfilling it LOSES particles (counted in Diagnostics.particles_lost,
    # never silently) — tests lower it to drive the failure edge.
    exchange_capacity: int = 0
    # Static declaration that interior solid cells (obstacles) exist. When
    # False, the collision pass skips the solid march entirely (the domain
    # walls are handled by advection clamping + the skin push-out, which needs
    # no solid lookups) — obstacle-free scenes pay nothing for obstacles.
    has_obstacles: bool = True

    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)

    dtype: jnp.dtype = jnp.float32

    # ---- derived helpers (static python, safe under jit) ----

    @property
    def nx(self) -> int:
        return self.grid_size[0]

    @property
    def ny(self) -> int:
        return self.grid_size[1]

    @property
    def nz(self) -> int:
        return self.grid_size[2]

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def domain_min(self) -> Tuple[float, float, float]:
        return self.grid_offset

    @property
    def domain_max(self) -> Tuple[float, float, float]:
        ox, oy, oz = self.grid_offset
        return (
            ox + self.nx * self.cell_size,
            oy + self.ny * self.cell_size,
            oz + self.nz * self.cell_size,
        )

    def __hash__(self):  # SimConfig
        return hash(
            (self.grid_size, self.cell_size, self.grid_offset, self.gravity,
             self.particle_capacity, self.scheme, self.blending_factor,
             self.cfl_number, self.density, self.boundary_skin_width,
             self.correction_stiffness, self.velocity_extrapolation_iterations,
             self.seeding_density, self.enable_position_correction,
             self.enable_collisions,
             self.max_neighbors_per_cell, self.correction_capacity,
             self.correction_overflow_capacity,
             self.p2g_overflow_capacity, self.exchange_capacity,
             self.has_obstacles, self.solver, str(self.dtype)))


@dataclasses.dataclass(frozen=True)
class MesherConfig:
    """Surface mesher tunables (reference ``mesher.h:25-34``)."""

    grid_size: Tuple[int, int, int] = (64, 64, 64)
    cell_size: float = 0.5
    grid_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    particle_extent: float = 2.0  # kernel support radius, world units (ref mesher.h:28)
    particle_radius: float = 0.5  # average-radius contribution per particle
    max_triangles: int = 1 << 18  # static output capacity for marching cubes

    def __hash__(self):
        return hash((self.grid_size, self.cell_size, self.grid_offset,
                     self.particle_extent, self.particle_radius,
                     self.max_triangles))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Renderer tunables (reference ``path_tracer.h:21``, ``bidirectional_path_tracer.h:18-21``)."""

    width: int = 256
    height: int = 256
    samples_per_pixel: int = 16
    algorithm: str = "pt"  # "pt" (naive forward) or "bdpt"
    max_bounces: int = 5  # naive PT cap (ref path_tracer.h:21)
    max_camera_bounces: int = 6  # BDPT camera subpath cap (ref bdpt.h:19; ref uses 15)
    max_light_bounces: int = 6  # BDPT light subpath cap (ref bdpt.h:21)
    ray_batch: int = 1 << 15  # rays traced per wavefront batch
    # Russian roulette: from this bounce on, paths survive with probability
    # max(throughput) (clamped to >= rr_floor) and are reweighted — unbiased
    # dead-lane elimination the reference lacks (path_tracer.cpp has none).
    # Set >= max_bounces to disable.
    rr_start: int = 3
    rr_floor: float = 0.05
    # scan-based bounce driver (reverse-differentiable). False switches to a
    # while_loop that exits as soon as every lane is dead — faster inference/
    # benchmarking, but jax.grad through render() then fails loudly.
    differentiable: bool = True

    def __hash__(self):
        return hash((self.width, self.height, self.samples_per_pixel,
                     self.algorithm, self.max_bounces, self.max_camera_bounces,
                     self.max_light_bounces, self.ray_batch, self.rr_start,
                     self.rr_floor, self.differentiable))
