"""Deterministic coincident-pair jitter for the position-correction springs.

The reference draws a per-thread uniform random force for exactly-coincident
particle pairs (``simulation.cpp:585-589``) — any fixed distribution works,
only symmetry-breaking matters. Here the jitter must additionally be
*path-invariant*: the dense substep, the slab-tiled substep and the z-sharded
substep all evaluate the same (global cell, slot) and must produce bit-equal
positions (the equivalence suite asserts it; ADVICE r4 high: per-path
``jax.random`` draws with different shapes/key splits broke dense<->tiled
equivalence the moment coincident mates entered the dense pass).

So the jitter is a counter-based hash of ``(substep seed, global cell
coordinates, slot rank, component)`` — no PRNG state, no shape dependence,
identical wherever it is evaluated (plain int32 mul/xor/shift ops).
Quality requirements are mild
(symmetry breaking of a heuristic spring), uniformity in [-1, 1) is plenty.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# lowbias32 constants (public-domain integer hash); int32 two's-complement
# wraparound multiplies produce the same bits as the uint32 original
_M1 = np.uint32(0x7FEB352D).astype(np.int32)
_M2 = np.uint32(0x846CA68B).astype(np.int32)

# distinct odd mixing constants for the coordinate linear combination
_CX = np.int32(198491317)
_CY = np.int32(6542989)
_CZ = np.int32(362437)
_CK = np.int32(87178291)
_CC = np.int32(1299709)


def _mix32(x):
    x = x ^ lax.shift_right_logical(x, 16)
    x = x * _M1
    x = x ^ lax.shift_right_logical(x, 15)
    x = x * _M2
    x = x ^ lax.shift_right_logical(x, 16)
    return x


def jitter_bits(seed, gx, gy, gz, slot, comp):
    """int32 hash of (seed, global cell, slot, component); inputs broadcast."""
    t = (
        gx * _CX
        + gy * _CY
        + gz * _CZ
        + slot * _CK
        + comp * _CC
    )
    return _mix32(_mix32(t ^ seed))


def jitter_value(seed, gx, gy, gz, slot, comp):
    """Uniform jitter in (-1, 1): the hash bits scaled by 2^-31."""
    b = jitter_bits(seed, gx, gy, gz, slot, comp)
    return b.astype(jnp.float32) * np.float32(1.0 / 2147483648.0)


def jitter_field(seed, kc: int, shape, origin, dtype):
    """(3, kc, nx, ny, nz) jitter field over a LOCAL grid window.

    ``origin`` = global cell coordinates of local cell (0, 0, 0) — python
    ints or traced int32 scalars (the tiled path passes the slab's x offset,
    the z-sharded path its device's z offset). Ghost layers at negative
    global coordinates get well-defined (unused — mask 0) values.
    """
    nx, ny, nz = shape
    ox, oy, oz = origin
    gx = (jnp.arange(nx, dtype=jnp.int32) + ox)[None, None, :, None, None]
    gy = (jnp.arange(ny, dtype=jnp.int32) + oy)[None, None, None, :, None]
    gz = (jnp.arange(nz, dtype=jnp.int32) + oz)[None, None, None, None, :]
    slot = jnp.arange(kc, dtype=jnp.int32)[None, :, None, None, None]
    comp = jnp.arange(3, dtype=jnp.int32)[:, None, None, None, None]
    return jitter_value(
        jnp.asarray(seed, jnp.int32), gx, gy, gz, slot, comp
    ).astype(dtype)


def seed_from_key(key) -> jnp.ndarray:
    """The one seed derivation every path shares (so a common substep key
    yields a common jitter field regardless of code path)."""
    return jax.random.randint(key, (), 0, jnp.int32(2**31 - 1))
