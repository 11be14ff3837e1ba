"""Multi-device scaling: device meshes, shardings, halo exchange.

Replaces the reference's shared-memory OpenMP parallelism (SURVEY.md §2
P1-P12) with ``jax.sharding`` over a device mesh (one host's GPUs, joined all to
all by NVLink, or several hosts):

- particles are sharded over the data axis; P2G scatters into device-local
  grids that are summed with ``psum`` (the analog of the reference's
  write-disjoint OpenMP particle loops),
- grid stencils (pressure CG, extrapolation) run on z-sharded tiles with
  width-1 halo exchange via ``lax.ppermute``,
- camera rays are embarrassingly sharded for rendering (ref ``rendering.h``
  OpenMP-over-rows),
- CG dot products and image accumulation reduce with ``psum``.
"""

from libfluid_tpu.parallel.mesh import make_mesh, particle_sharding, replicated
from libfluid_tpu.parallel.halo import halo_exchange_z, sharded_apply_A
from libfluid_tpu.parallel.shard import (
    shard_sim_state,
    sharded_substep,
    sharded_render,
    training_step,
)
from libfluid_tpu.parallel.zshard import step_z, substep_z, zshard_state

__all__ = [
    "make_mesh",
    "particle_sharding",
    "replicated",
    "halo_exchange_z",
    "sharded_apply_A",
    "shard_sim_state",
    "sharded_substep",
    "sharded_render",
    "training_step",
    "substep_z",
    "step_z",
    "zshard_state",
]
