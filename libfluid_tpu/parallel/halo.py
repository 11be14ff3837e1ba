"""Halo exchange for z-sharded grid tiles, and a sharded Poisson stencil.

The sharded analog of the CP/SP slot in SURVEY.md §5: the grid's long axis is
partitioned over the mesh; width-1 ghost layers move with ``lax.ppermute``
(XLA lowers this to collective permutes, NCCL on GPUs). Used under
``jax.shard_map``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def halo_exchange_z(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Pad a local (nx, ny, nz_local, ...) tile with one ghost layer from each
    z-neighbor (zero at the domain ends). Returns (nx, ny, nz_local+2, ...)."""
    n = lax.psum(1, axis_name)
    idx = lax.axis_index(axis_name)
    send_right = x[:, :, -1:]
    send_left = x[:, :, :1]
    # neighbor k receives from k-1 (rightward shift) / k+1 (leftward shift)
    from_left = lax.ppermute(
        send_right, axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    from_right = lax.ppermute(
        send_left, axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    zero = jnp.zeros_like(send_left)
    left = jnp.where(idx == 0, zero, from_left)
    right = jnp.where(idx == n - 1, zero, from_right)
    return jnp.concatenate([left, x, right], axis=2)


def sharded_apply_A(
    fluid, couple_w_lo, couple_w_hi, couple_u, couple_v, diag, p, a_scale, axis_name
):
    """Masked 7-point Laplacian on a z-sharded tile.

    Same math as :func:`libfluid_tpu.sim.pressure.apply_A` but the z-neighbor
    terms come through the halo. `couple_w_lo/hi` are the local cell's
    coupling masks to its -z/+z neighbor (so no face array needs splitting).
    """
    p = p * fluid
    ph = halo_exchange_z(p, axis_name)
    nbr = (
        couple_u[:-1] * jnp.pad(p, ((1, 0), (0, 0), (0, 0)))[:-1]
        + couple_u[1:] * jnp.pad(p, ((0, 1), (0, 0), (0, 0)))[1:]
        + couple_v[:, :-1] * jnp.pad(p, ((0, 0), (1, 0), (0, 0)))[:, :-1]
        + couple_v[:, 1:] * jnp.pad(p, ((0, 0), (0, 1), (0, 0)))[:, 1:]
        + couple_w_lo * ph[:, :, :-2]
        + couple_w_hi * ph[:, :, 2:]
    )
    return a_scale * (diag * p - nbr) * fluid


def sharded_dot(a, b, axis_name):
    """Global inner product across tiles (one psum per CG iteration)."""
    return lax.psum(jnp.sum(a * b), axis_name)
