"""libfluid_tpu — a differentiable fluid-simulation and rendering framework in JAX.

Built from scratch in JAX/XLA with the capability set of lukedan/libfluid
(PIC/FLIP/APIC particle-in-cell liquid simulation on a MAC grid, pressure projection,
marching-cubes surface meshing, mesh voxelization, and path tracing / BDPT), but
re-architected for accelerators:

- the mutable ``simulation`` object of the reference becomes a functional core:
  a :class:`~libfluid_tpu.sim.state.SimState` pytree and a pure
  ``step(state, cfg) -> state`` transition,
- particle-grid transfers are batched scatter/gather ops (differentiable by
  construction),
- the serial MIC(0)-PCG pressure solver becomes a matrix-free, order-free
  preconditioned CG over dense grid tiles (shardable with halo exchange),
- the renderer is a wavefront path tracer over ray batches,
- scaling is expressed with ``jax.sharding`` over a device mesh rather than
  OpenMP threads.

Reference parity map: see SURVEY.md at the repo root.
"""

from libfluid_tpu import config as config
from libfluid_tpu.config import (
    SimConfig,
    SolverConfig,
    MesherConfig,
    RenderConfig,
    TransferScheme,
)

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "SolverConfig",
    "MesherConfig",
    "RenderConfig",
    "TransferScheme",
    "config",
]
