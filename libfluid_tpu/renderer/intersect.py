"""Batched ray/scene intersection.

Replaces the reference's SAH BVH traversal (``aabb_tree.cpp:227-322``) with a
wavefront-friendly formulation: every ray tests triangle chunks in a
``lax.scan`` (bounded memory, fully vectorized Möller–Trumbore over the
ray x chunk block) and all spheres, keeping the nearest hit. For the scenes
the reference ships (tens of triangles, one sphere) this beats divergent
tree traversal on a wavefront; fluid meshes (10^5 triangles) get a two-level
uniform-grid accelerator in a later pass (SURVEY.md §2 P9).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from libfluid_tpu.math import intersection as isect
from libfluid_tpu.renderer.scene import Scene

# full float32 for the small frame/transform products (a GPU may run them
# in TF32, which moves hit points by ~1e-3 relative)
_HIGHEST = jax.lax.Precision.HIGHEST

_BIG = 3.0e38
TRI_CHUNK = 512


class HitRecord(NamedTuple):
    hit: jnp.ndarray  # (R,) bool
    t: jnp.ndarray  # (R,)
    position: jnp.ndarray  # (R, 3)
    normal: jnp.ndarray  # (R, 3) unit geometric normal
    mat_id: jnp.ndarray  # (R,) int32
    prim_kind: jnp.ndarray  # (R,) 0 = triangle, 1 = sphere
    prim_id: jnp.ndarray  # (R,) int32
    uv: jnp.ndarray  # (R, 2) barycentric (tri) / spherical (sphere)


def _tri_chunks(scene: Scene):
    t = scene.tri_p0.shape[0]
    # adapt the chunk width to the scene: the canned few-triangle scenes
    # (Cornell: 36 tris) otherwise pay for a full 512-wide lane pad on every
    # ray x chunk product — 14x wasted Moller-Trumbore work per cast. 128 is
    # the f32 lane tile, so smaller pads buy nothing.
    chunk = min(TRI_CHUNK, -(-t // 128) * 128) if t else TRI_CHUNK
    pad = (-t) % chunk
    def padarr(x, fill=0.0):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0
        ) if pad else x
    # pad rows are zero-area (e1 = e2 = 0) and never hit (det = 0); p0 must
    # stay finite — a 1e30 fill rides into tvec = origin - p0 and blows up
    # the backward cross-product Jacobians (inf * 0 = NaN) when triangle
    # geometry is differentiated (the mesher-in-the-loop chain)
    p0 = padarr(scene.tri_p0)
    e1 = padarr(scene.tri_e1)
    e2 = padarr(scene.tri_e2)
    n = (t + pad) // chunk
    return (
        p0.reshape(n, chunk, 3),
        e1.reshape(n, chunk, 3),
        e2.reshape(n, chunk, 3),
        n,
    )


def _brute_force_tris(scene: Scene, origin, direction, t_max):
    """Chunked all-triangles scan (the reference-scale path)."""
    r = origin.shape[0]
    p0c, e1c, e2c, nchunk = _tri_chunks(scene)

    def chunk_body(carry, chunk):
        best_t, best_id, best_u, best_v = carry
        p0, e1, e2, base = chunk
        hit, t, u, v = isect.ray_triangle(
            origin[:, None, :], direction[:, None, :], p0[None], e1[None], e2[None]
        )
        t = jnp.where(hit, t, _BIG)
        j = jnp.argmin(t, axis=1)
        tj = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
        closer = tj < best_t
        best_id = jnp.where(closer, base + j.astype(jnp.int32), best_id)
        best_u = jnp.where(
            closer, jnp.take_along_axis(u, j[:, None], axis=1)[:, 0], best_u
        )
        best_v = jnp.where(
            closer, jnp.take_along_axis(v, j[:, None], axis=1)[:, 0], best_v
        )
        best_t = jnp.minimum(best_t, tj)
        return (best_t, best_id, best_u, best_v), None

    init = (
        jnp.full((r,), t_max, origin.dtype),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), origin.dtype),
        jnp.zeros((r,), origin.dtype),
    )
    bases = jnp.arange(nchunk, dtype=jnp.int32) * TRI_CHUNK
    (tri_t, tri_id, tri_u, tri_v), _ = jax.lax.scan(
        chunk_body, init, (p0c, e1c, e2c, bases)
    )
    return tri_t, tri_id, tri_u, tri_v


def ray_cast(scene: Scene, origin: jnp.ndarray, direction: jnp.ndarray, t_max=_BIG) -> HitRecord:
    """Nearest hit for a batch of rays; directions need not be normalized
    (t is in units of |direction|, like the reference's ray_cast).

    With ``scene.accel`` set (see :mod:`libfluid_tpu.renderer.accel`) the
    triangle search runs the uniform-grid DDA; otherwise the chunked
    brute-force scan below (fine for the canned few-triangle scenes)."""
    if scene.accel is not None:
        from libfluid_tpu.renderer import accel as accel_mod

        tri_t, tri_id, tri_u, tri_v = accel_mod.traverse(
            scene.accel,
            accel_mod.pack_tris(scene),
            origin,
            direction,
            jnp.asarray(t_max, origin.dtype),
        )
    else:
        tri_t, tri_id, tri_u, tri_v = _brute_force_tris(
            scene, origin, direction, t_max
        )
    return finalize_hit(scene, origin, direction, tri_t, tri_id, tri_u, tri_v, t_max)


def finalize_hit(
    scene: Scene, origin, direction, tri_t, tri_id, tri_u, tri_v, t_max=_BIG
) -> HitRecord:
    """Fold the sphere primitives into a finished triangle search and derive
    the shading payload (position/normal/material/uv). Split out of
    ``ray_cast`` so the persistent megakernel (pathtrace) can run it on
    lanes whose grid traversal just completed."""
    r = origin.shape[0]
    # spheres: transform to local, hit unit sphere (primitive.cpp:59-135).
    # Padding spheres (the no-sphere sentinel at translation 1e30) are masked
    # by their reserved null material; the clip keeps |o_loc|^2 finite so the
    # quadratic never produces inf - inf = NaN — a forward NaN there poisons
    # the VJP of every ray whose origin depends on scene geometry (the
    # mesher-in-the-loop gradient chain).
    stl = scene.sph_to_local  # (S, 3, 4)
    o_loc = jnp.einsum("sij,rj->rsi", stl[:, :, :3], origin, precision=_HIGHEST) + stl[None, :, :, 3]
    o_loc = jnp.clip(o_loc, -1e15, 1e15)
    d_loc = jnp.einsum("sij,rj->rsi", stl[:, :, :3], direction, precision=_HIGHEST)
    sh, st = isect.ray_unit_sphere(o_loc, d_loc)
    sh = sh & (scene.sph_mat > 0)[None, :]
    st = jnp.where(sh, st, _BIG)
    sj = jnp.argmin(st, axis=1)
    s_t = jnp.take_along_axis(st, sj[:, None], axis=1)[:, 0]

    use_sphere = s_t < tri_t
    best_t = jnp.where(use_sphere, s_t, tri_t)
    hit = best_t < t_max

    prim_kind = jnp.where(use_sphere, 1, 0).astype(jnp.int32)
    prim_id = jnp.where(use_sphere, sj.astype(jnp.int32), tri_id)

    pos = origin + direction * best_t[:, None]

    # normals and materials
    safe_tid = jnp.clip(tri_id, 0)
    tri_n = scene.tri_normal[safe_tid]
    tri_m = scene.tri_mat[safe_tid]

    safe_sid = jnp.clip(sj, 0)
    # sphere normal: local hit point through inverse-transpose of to_world's
    # linear part == to_local^T applied to the local normal
    # miss lanes carry s_t = _BIG: clamp before forming the local hit point,
    # or arctan2(inf, inf) in the uv math emits NaN derivatives that survive
    # the zero cotangent of the where-mask below
    s_t_lp = jnp.minimum(s_t, 1e12)
    lp = jnp.take_along_axis(o_loc, sj[:, None, None], axis=1)[:, 0] + jnp.take_along_axis(
        d_loc, sj[:, None, None], axis=1
    )[:, 0] * s_t_lp[:, None]
    a_loc = scene.sph_to_local[safe_sid][:, :, :3]
    sph_n = jnp.einsum("rji,rj->ri", a_loc, lp, precision=_HIGHEST)  # A^T * local_normal
    sph_n = sph_n / jnp.maximum(
        jnp.linalg.norm(sph_n, axis=-1, keepdims=True), 1e-30
    )
    sph_m = scene.sph_mat[safe_sid]

    normal = jnp.where(use_sphere[:, None], sph_n, tri_n)
    mat_id = jnp.where(use_sphere, sph_m, tri_m)
    mat_id = jnp.where(hit, mat_id, 0)

    # uv: barycentric for tris, spherical for spheres (primitive.cpp:47-56,120-135)
    phi = jnp.arctan2(lp[:, 2], lp[:, 0])
    # clip strictly inside (-1, 1): arccos' is infinite at the endpoints, and
    # miss lanes land exactly on the clip boundary, NaN-ing the VJP (0 * inf)
    theta = jnp.arccos(jnp.clip(lp[:, 1], -1.0 + 1e-6, 1.0 - 1e-6))
    sph_uv = jnp.stack([phi / (2 * jnp.pi) + 0.5, theta / jnp.pi], axis=-1)
    tri_uv = jnp.stack([tri_u, tri_v], axis=-1)
    uv = jnp.where(use_sphere[:, None], sph_uv, tri_uv)

    return HitRecord(
        hit=hit,
        t=best_t,
        position=pos,
        normal=normal,
        mat_id=mat_id,
        prim_kind=prim_kind,
        prim_id=prim_id,
        uv=uv,
    )


_VIS_TRI_CHUNK = 8


def _any_hit_tris(scene: Scene, o, d, t_max) -> jnp.ndarray:
    """(R,) bool: does ANY triangle block the ray before t_max?

    Möller–Trumbore written component-wise in (T_chunk, R) layout — rays on
    the lane axis, a small triangle chunk on sublanes. The broadcasting
    (R, T, 3) form materializes three cross-product temps with a minor axis
    of 3 (lane-padded 43x) at hundreds of MB per cast; this form's largest
    temp is T_chunk * R floats and the whole scan fuses elementwise.
    """
    r = o.shape[0]
    t_cap = scene.tri_p0.shape[0]
    tc = _VIS_TRI_CHUNK
    pad = (-t_cap) % tc

    def prep(x):
        if pad:
            x = jnp.concatenate([x, jnp.zeros((pad, 3), x.dtype)], axis=0)
        return x.reshape(-1, tc, 3).transpose(0, 2, 1)  # (n, 3, tc)

    p0c, e1c, e2c = prep(scene.tri_p0), prep(scene.tri_e1), prep(scene.tri_e2)
    ox, oy, oz = (o[:, i][None, :] for i in range(3))  # (1, R)
    dx, dy, dz = (d[:, i][None, :] for i in range(3))
    eps_det = 1e-9

    def chunk_body(blocked, chunk):
        p0, e1, e2 = chunk  # (3, tc) each
        col = lambda m, i: m[i][:, None]  # (tc, 1)
        e1x, e1y, e1z = col(e1, 0), col(e1, 1), col(e1, 2)
        e2x, e2y, e2z = col(e2, 0), col(e2, 1), col(e2, 2)
        p0x, p0y, p0z = col(p0, 0), col(p0, 1), col(p0, 2)
        # pvec = d x e2  (tc, R)
        pv0 = dy * e2z - dz * e2y
        pv1 = dz * e2x - dx * e2z
        pv2 = dx * e2y - dy * e2x
        det = e1x * pv0 + e1y * pv1 + e1z * pv2
        inv = jnp.where(jnp.abs(det) > eps_det, 1.0 / det, 0.0)
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pv0 + tvy * pv1 + tvz * pv2) * inv
        # qvec = tvec x e1
        qv0 = tvy * e1z - tvz * e1y
        qv1 = tvz * e1x - tvx * e1z
        qv2 = tvx * e1y - tvy * e1x
        v = (dx * qv0 + dy * qv1 + dz * qv2) * inv
        t = (e2x * qv0 + e2y * qv1 + e2z * qv2) * inv
        hit = (
            (jnp.abs(det) > eps_det)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > 0.0)
            & (t < t_max)
        )
        return blocked | jnp.any(hit, axis=0), None

    blocked0 = jnp.zeros((r,), bool)
    blocked, _ = jax.lax.scan(chunk_body, blocked0, (p0c, e1c, e2c))
    return blocked


def test_visibility(scene: Scene, p1: jnp.ndarray, p2: jnp.ndarray, eps=1e-4) -> jnp.ndarray:
    """True where the segment p1->p2 is unobstructed (``scene.cpp:77-85``):
    the ray is shrunk by eps at both ends and any hit with t in (0, 1) blocks.

    Shadow rays only need a BOOLEAN, so this skips the shading payload of
    :func:`ray_cast` entirely (normals/uv/material derivation cost ~as much
    as the intersection itself on small scenes — BDPT's 36 visibility casts
    per sample were ~80%% of its wall-clock through the full pipeline)."""
    diff = p2 - p1
    n = diff / jnp.maximum(jnp.linalg.norm(diff, axis=-1, keepdims=True), 1e-30)
    o = p1 + n * eps
    d = diff - 2.0 * eps * n
    t_max = 1.0

    if scene.accel is not None:
        from libfluid_tpu.renderer import accel as accel_mod

        _, tri_id, _, _ = accel_mod.traverse(
            scene.accel, accel_mod.pack_tris(scene), o, d,
            jnp.asarray(t_max, o.dtype),
        )
        tri_blocked = tri_id >= 0
    else:
        tri_blocked = _any_hit_tris(scene, o, d, t_max)

    # spheres: boolean-only local-space test
    stl = scene.sph_to_local  # (S, 3, 4)
    o_loc = jnp.einsum("sij,rj->rsi", stl[:, :, :3], o, precision=_HIGHEST) + stl[None, :, :, 3]
    o_loc = jnp.clip(o_loc, -1e15, 1e15)
    d_loc = jnp.einsum("sij,rj->rsi", stl[:, :, :3], d, precision=_HIGHEST)
    sh, st = isect.ray_unit_sphere(o_loc, d_loc)
    sph_blocked = jnp.any(
        sh & (st < t_max) & (scene.sph_mat > 0)[None, :], axis=1
    )
    return ~(tri_blocked | sph_blocked)


def tangent_frame(normal: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) world->tangent rotation with the normal on row 1 (+Y),
    matching ``compute_arbitrary_tangent_space`` (``common.h:112-116``)."""
    a = jnp.abs(normal)
    # pick the axis least aligned with the normal (common.h:92-109)
    use_x = (a[..., 0] <= a[..., 1]) & (a[..., 0] <= a[..., 2])
    use_y = ~use_x & (a[..., 1] <= a[..., 2])
    axis = jnp.where(
        use_x[..., None],
        jnp.asarray([1.0, 0.0, 0.0], normal.dtype),
        jnp.where(
            use_y[..., None],
            jnp.asarray([0.0, 1.0, 0.0], normal.dtype),
            jnp.asarray([0.0, 0.0, 1.0], normal.dtype),
        ),
    )
    x = jnp.cross(normal, axis)
    # a zero normal (degenerate geometry) makes |x| = 0, whose normalize has
    # a NaN derivative even under a zero cotangent — route through a unit
    # placeholder instead
    ok = jnp.sum(x * x, axis=-1, keepdims=True) > 1e-24
    x = jnp.where(ok, x, jnp.asarray([1.0, 0.0, 0.0], normal.dtype))
    x = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    z = jnp.cross(x, normal)
    return jnp.stack([x, normal, z], axis=-2)
