"""Affine transforms (reference ``include/fluid/math/mat.h:291-346``).

Transforms are (3, 4) row-major matrices [R|t]; points/directions are arrays
with trailing axis 3 (batched). Euler rotation uses the reference's ZYX
composition (``mat.h:300-330``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# float32 products on a GPU may run in TF32 (~3 decimal digits), which moves
# hit points by ~1e-3 relative; these 3x3 / 3x4 transforms are tiny, so
# full precision costs nothing
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


def scale(s):
    """Diagonal scale as a (3, 4) transform (ref ``mat.h:293-298``)."""
    s = jnp.asarray(s) * jnp.ones((3,))
    return jnp.concatenate([jnp.diag(s), jnp.zeros((3, 1))], axis=-1)


def rotate_euler(angles):
    """Rotation by Euler angles applied in Z, then Y, then X order (ZYX).

    Matches reference ``transform::rotate_euler`` (``mat.h:300-330``); returns
    a (3, 3) rotation matrix.
    """
    ax, ay, az = angles[0], angles[1], angles[2]
    cx, sx = jnp.cos(ax), jnp.sin(ax)
    cy, sy = jnp.cos(ay), jnp.sin(ay)
    cz, sz = jnp.cos(az), jnp.sin(az)
    rx = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    rx = rx.at[1, 1].set(cx).at[1, 2].set(-sx).at[2, 1].set(sx).at[2, 2].set(cx)
    ry = jnp.eye(3)
    ry = ry.at[0, 0].set(cy).at[0, 2].set(sy).at[2, 0].set(-sy).at[2, 2].set(cy)
    rz = jnp.eye(3)
    rz = rz.at[0, 0].set(cz).at[0, 1].set(-sz).at[1, 0].set(sz).at[1, 1].set(cz)
    return _mm(_mm(rx, ry), rz)


def scale_rotate_translate(s, euler, t):
    """[R·S | t] as a (3, 4) transform (ref ``mat.h:332-346``)."""
    s = jnp.asarray(s) * jnp.ones((3,))
    r = rotate_euler(jnp.asarray(euler)) * s[None, :]
    return jnp.concatenate([r, jnp.asarray(t).reshape(3, 1)], axis=-1)


def apply_point(m, p):
    """Apply a (3,4) transform to points with trailing axis 3."""
    return _mm(p, m[:, :3].T) + m[:, 3]


def apply_vector(m, v):
    """Apply the linear part of a (3,4) transform to direction vectors."""
    return _mm(v, m[:, :3].T)


def inverse(m):
    """Inverse of a (3,4) affine transform as another (3,4) transform."""
    rinv = jnp.linalg.inv(m[:, :3])
    return jnp.concatenate([rinv, _mm(-rinv, m[:, 3]).reshape(3, 1)], axis=-1)
