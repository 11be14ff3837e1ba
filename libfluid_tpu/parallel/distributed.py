"""Multi-host bring-up: ``jax.distributed`` initialization + process-spanning
mesh construction.

The reference is strictly single-process shared memory (SURVEY.md §5
"distributed backend": none — OpenMP + mutexes). One process drives all
GPUs of one host and needs none of this; across hosts the runtime is one
process per host. This module is the bring-up recipe:

    from libfluid_tpu.parallel import distributed
    distributed.init_distributed("host0:1234", num_processes=2, process_id=i)
    mesh = distributed.global_mesh(("dp",)) # all devices, all processes

    state = zshard_state(state, cfg, mesh)  # then exactly as single-host
    state, diag = jax.jit(lambda s: substep_z(s, cfg, dt, mesh))(state)

Nothing tells JAX of a cluster, so pass the coordinator's ``host:port``,
the process count and this process' id explicitly (as the 2-process CPU
test, ``tests/test_distributed.py``, does).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join (or start) the distributed runtime. Idempotent: calling twice is
    a no-op. Arguments left as None fall back to JAX's own cluster
    detection, which finds nothing on a plain GPU host."""
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def global_mesh(
    axis_names: Sequence[str] = ("dp",),
    axis_sizes: Optional[Sequence[int]] = None,
) -> Mesh:
    """Mesh over ALL devices of ALL processes, ordered process-major (so a
    1-D 'dp' axis keeps each host's devices contiguous — z-slabs land on the
    host that owns them and halo ppermutes stay on the host's NVLink,
    crossing the network only at host boundaries)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devs)
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {axis_sizes} != {n} global devices")
    return Mesh(np.asarray(devs).reshape(tuple(axis_sizes)), tuple(axis_names))


def process_count() -> int:
    return jax.process_count()


def is_coordinator() -> bool:
    return jax.process_index() == 0
