"""Uniform-grid ray acceleration structure (wavefront 3D-DDA traversal).

Replaces the reference's SAH BVH (``aabb_tree.cpp:110-221`` build,
``:227-322`` traversal) with the design from SURVEY.md §2 P9:
divergent tree descent does not vectorize, but a uniform grid walked with a
3D-DDA keeps every ray in lock-step — each wavefront iteration either tests a
small chunk of the ray's current cell's triangles (one row gather + batched
Möller–Trumbore) or advances the DDA one cell, all as masked vector ops.

Two-level split: triangles whose cell-span exceeds 2 per axis (walls, lights,
floors — a handful per scene) go to a dense "big" list brute-forced once per
cast, exactly like the reference testbed's small scenes; everything else
(e.g. 10^5 marching-cubes fluid triangles) lands in per-cell CSR lists built
with one sort — fully jittable, so a fresh fluid mesh re-accelerates on
device every frame with no host round-trip.

The build is differentiation-free (int structure only); gradients flow
through the triangle data used at hit time, unchanged.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

_BIG = 3.0e38


class Accel(NamedTuple):
    res: Tuple[int, int, int]  # static grid resolution
    lo: jnp.ndarray  # (3,) world bbox min
    cell: jnp.ndarray  # (3,) cell size per axis
    cell_start: jnp.ndarray  # (C+1,) int32 CSR offsets into tri_ids
    tri_ids: jnp.ndarray  # (E,) int32 triangle ids (sorted by cell)
    big_ids: jnp.ndarray  # (B,) int32 large-triangle ids, -1 padded
    big_overflow: jnp.ndarray  # () int32 — big tris beyond capacity (should be 0)
    # (C,) int32 "proximity cloud": L-inf distance to the nearest non-empty
    # cell, capped at DIST_CAP. The traversal jumps dist-1 cells through
    # empty space in ONE wavefront iteration — the lockstep DDA otherwise
    # pays the worst ray's per-cell step count through open regions above a
    # fluid surface
    dist: jnp.ndarray

    @property
    def num_cells(self) -> int:
        rx, ry, rz = self.res
        return rx * ry * rz


DIST_CAP = 16  # max empty-skip radius stored in Accel.dist (cells): longer
# hops through the open region above the fluid, for erosion passes the
# per-frame build amortizes (a tuning constant)


def _valid_tris(scene) -> jnp.ndarray:
    # material 0 is the reserved null/padding material (scene.py builder)
    return scene.tri_mat > 0


def build(
    scene,
    res: Tuple[int, int, int] = (64, 64, 64),
    big_capacity: int = 128,
    max_span: int = 2,
) -> Accel:
    """Build the uniform grid for `scene`'s triangles (jittable).

    Entry capacity is exact: every "small" triangle occupies at most
    (max_span+1)^3 cells, so the sorted entry array has static size and
    never truncates. Triangles spanning more go to the brute-forced big
    list, whose `big_overflow` counter is the ONLY signal of truncation —
    pick `res` so grid cells are no smaller than ~1/max_span of the bulk
    triangle size (e.g. accel res == marching-cubes res for fluid meshes);
    a too-fine grid pushes thousands of ordinary triangles into the big
    list and SILENTLY DROPS those past capacity (found as an ~12% nearest-
    hit mismatch at 2-3x over-resolution in r5).
    """
    rx, ry, rz = res
    t_cap = scene.tri_p0.shape[0]
    valid = _valid_tris(scene)

    v0 = scene.tri_p0
    v1 = v0 + scene.tri_e1
    v2 = v0 + scene.tri_e2
    tlo = jnp.minimum(v0, jnp.minimum(v1, v2))
    thi = jnp.maximum(v0, jnp.maximum(v1, v2))

    big_inf = jnp.asarray([_BIG] * 3, v0.dtype)
    lo = jnp.min(jnp.where(valid[:, None], tlo, big_inf), axis=0)
    hi = jnp.max(jnp.where(valid[:, None], thi, -big_inf), axis=0)
    # degenerate/empty guard + epsilon pad so boundary tris stay inside
    span = jnp.maximum(hi - lo, 1e-6)
    pad = span * 1e-4
    lo = lo - pad
    cell = (span + 2 * pad) / jnp.asarray([rx, ry, rz], v0.dtype)

    resv = jnp.asarray([rx, ry, rz], jnp.int32)
    clo = jnp.clip(jnp.floor((tlo - lo) / cell).astype(jnp.int32), 0, resv - 1)
    chi = jnp.clip(jnp.floor((thi - lo) / cell).astype(jnp.int32), 0, resv - 1)
    span_cells = chi - clo  # >= 0
    small = valid & jnp.all(span_cells <= max_span, axis=-1)
    big = valid & ~small

    num_cells = rx * ry * rz
    sentinel = num_cells  # entries sorted past all real cells

    # (max_span+1)^3 candidate cells per small triangle
    offsets = [
        (ox, oy, oz)
        for ox in range(max_span + 1)
        for oy in range(max_span + 1)
        for oz in range(max_span + 1)
    ]
    keys = []
    for off in offsets:
        offv = jnp.asarray(off, jnp.int32)
        c = jnp.minimum(clo + offv, resv - 1)
        ok = small & jnp.all(offv <= span_cells, axis=-1)
        flat = (c[:, 0] * ry + c[:, 1]) * rz + c[:, 2]
        keys.append(jnp.where(ok, flat, sentinel))
    key_arr = jnp.concatenate(keys)  # (len(offsets)*T,)
    tid_arr = jnp.tile(jnp.arange(t_cap, dtype=jnp.int32), len(offsets))

    order = jnp.argsort(key_arr)
    tri_ids = tid_arr[order]
    counts = jax.ops.segment_sum(
        jnp.ones_like(key_arr, jnp.int32), key_arr, num_segments=num_cells + 1
    )[:num_cells]
    cell_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )  # (C+1,)

    big_idx = jnp.nonzero(big, size=big_capacity, fill_value=-1)[0].astype(jnp.int32)
    big_overflow = jnp.sum(big.astype(jnp.int32)) - jnp.sum(
        (big_idx >= 0).astype(jnp.int32)
    )

    # proximity cloud: L-inf distance transform of the occupancy, capped.
    # DIST_CAP saturating 3^3 min-erosions (reduce_window) — each ring adds
    # one; tiny next to the sort above even at 64^3
    occ3 = (counts > 0).reshape(rx, ry, rz)
    d3 = jnp.where(occ3, 0, DIST_CAP).astype(jnp.int32)
    for _ in range(DIST_CAP - 1):
        eroded = -jax.lax.reduce_window(
            -d3, -(2**31 - 1), jax.lax.max,
            (3, 3, 3), (1, 1, 1), "SAME",
        )
        d3 = jnp.minimum(d3, eroded + 1)

    return Accel(
        res=res,
        lo=lo,
        cell=cell,
        cell_start=cell_start,
        tri_ids=tri_ids,
        big_ids=big_idx,
        big_overflow=big_overflow,
        dist=d3.reshape(-1),
    )


def _moller_trumbore(o, d, p0, e1, e2, eps=1e-9):
    """Batched ray-triangle (broadcasting shapes); returns (hit, t, u, v).
    Matches ``intersection.cpp:92-119``."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = o - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv
    t = jnp.sum(e2 * qvec, axis=-1) * inv
    hit = (
        (jnp.abs(det) > eps)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
    )
    return hit, t, u, v


CHUNK = 8  # triangles tested per ray per wavefront iteration. The DDA loop
# is lockstep across the wavefront — every lane pays the slowest ray's
# iteration count — so wider chunks cut the crowded-cell test iterations
# that dominate fluid-surface scenes (VPU lanes are free; 8 rows per ray
# per step is still tiny)


class TravState(NamedTuple):
    """Per-ray DDA traversal state — exposed so the persistent-threads path
    tracer can interleave single traversal steps with shading/respawn (the
    megakernel in :mod:`libfluid_tpu.renderer.pathtrace`): a lane whose ray
    finishes early starts its next ray immediately instead of idling in
    lock-step while the slowest ray of the batch walks the grid."""

    active: jnp.ndarray  # (R,) still traversing
    cell3: jnp.ndarray  # (R, 3)
    t_next: jnp.ndarray  # (R, 3)
    t_cur: jnp.ndarray  # (R,)
    start: jnp.ndarray  # (R,)
    cnt: jnp.ndarray  # (R,)
    dist: jnp.ndarray  # (R,)
    k: jnp.ndarray  # (R,) triangles tested so far in the current cell
    best_t: jnp.ndarray
    best_id: jnp.ndarray
    best_u: jnp.ndarray
    best_v: jnp.ndarray


def _fetch(accel: Accel, c3):
    rx, ry, rz = accel.res
    flat = (c3[:, 0] * ry + c3[:, 1]) * rz + c3[:, 2]
    flat = jnp.clip(flat, 0, rx * ry * rz - 1)
    s = accel.cell_start[flat]
    e = accel.cell_start[flat + 1]
    return s, e - s, accel.dist[flat]


def init_state(
    accel: Accel,
    tri_pack: jnp.ndarray,  # (T+1, 9): p0|e1|e2 rows, last row degenerate
    origin: jnp.ndarray,  # (R, 3)
    direction: jnp.ndarray,  # (R, 3)
    t_max,
) -> TravState:
    """Fresh traversal state: brute-forces the (small, static) big-triangle
    list and clips against the grid box; the DDA starts at the entry cell."""
    rx, ry, rz = accel.res
    r = origin.shape[0]
    dtype = origin.dtype
    resv = jnp.asarray([rx, ry, rz], jnp.int32)

    best_t = jnp.full((r,), t_max, dtype)
    best_id = jnp.full((r,), -1, jnp.int32)
    best_u = jnp.zeros((r,), dtype)
    best_v = jnp.zeros((r,), dtype)

    # ---- big triangles: one brute-force pass (B is small and static) ----
    bids = accel.big_ids
    bsafe = jnp.clip(bids, 0, tri_pack.shape[0] - 1)
    bt = tri_pack[bsafe]  # (B, 9)
    hit, t, u, v = _moller_trumbore(
        origin[:, None], direction[:, None], bt[None, :, 0:3], bt[None, :, 3:6], bt[None, :, 6:9]
    )
    hit = hit & (bids >= 0)[None, :] & (t < best_t[:, None])
    t = jnp.where(hit, t, _BIG)
    j = jnp.argmin(t, axis=1)
    tj = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
    closer = tj < best_t
    best_id = jnp.where(closer, bids[j], best_id)
    best_u = jnp.where(closer, jnp.take_along_axis(u, j[:, None], 1)[:, 0], best_u)
    best_v = jnp.where(closer, jnp.take_along_axis(v, j[:, None], 1)[:, 0], best_v)
    best_t = jnp.where(closer, tj, best_t)

    # ---- DDA setup ----
    inv_d = jnp.where(jnp.abs(direction) > 1e-30, 1.0 / direction, _BIG)
    box_lo = accel.lo
    box_hi = accel.lo + accel.cell * resv.astype(dtype)
    t_lo = (box_lo - origin) * inv_d
    t_hi = (box_hi - origin) * inv_d
    t_near = jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
    t_far = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
    t_enter = jnp.maximum(t_near, 0.0)
    misses_box = (t_far < t_enter) | (t_enter >= best_t)

    p = origin + direction * (t_enter[:, None] + 1e-7)
    cellf = (p - box_lo) / accel.cell
    cell3 = jnp.clip(jnp.floor(cellf).astype(jnp.int32), 0, resv - 1)
    step = jnp.sign(direction).astype(jnp.int32)
    next_bound = (
        box_lo
        + (cell3 + (step > 0).astype(jnp.int32)).astype(dtype) * accel.cell
    )
    t_next = jnp.where(
        step == 0, _BIG, (next_bound - origin) * inv_d
    )  # (R, 3)
    start0, cnt0, dist0 = _fetch(accel, cell3)
    return TravState(
        active=~misses_box,
        cell3=cell3,
        t_next=t_next,
        t_cur=t_enter,
        start=start0,
        cnt=cnt0,
        dist=dist0,
        k=jnp.zeros((r,), jnp.int32),
        best_t=best_t,
        best_id=best_id,
        best_u=best_u,
        best_v=best_v,
    )


def step_state(
    accel: Accel,
    tri_pack: jnp.ndarray,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    st: TravState,
) -> TravState:
    """One lockstep traversal iteration: test a CHUNK of the current cell's
    triangles AND advance rays whose cell is exhausted (a <=CHUNK-triangle
    cell costs one iteration, not two). Advancing through empty space uses
    the proximity cloud: from a cell whose nearest occupied cell is `dist`
    away, hop dist-1 cells in one go (traveling k*min(t_delta) moves at most
    k cells on EVERY axis — an L-inf ball the distance field guarantees
    empty) and re-derive the DDA state from the landing point."""
    rx, ry, rz = accel.res
    dtype = origin.dtype
    resv = jnp.asarray([rx, ry, rz], jnp.int32)
    e_cap = accel.tri_ids.shape[0]
    box_lo = accel.lo
    inv_d = jnp.where(jnp.abs(direction) > 1e-30, 1.0 / direction, _BIG)
    step = jnp.sign(direction).astype(jnp.int32)
    t_delta = jnp.abs(accel.cell * inv_d)
    t_min_delta = jnp.min(jnp.where(step == 0, _BIG, t_delta), axis=-1)

    (active, cell3, t_next, t_cur, start, cnt, dist, k,
     best_t, best_id, best_u, best_v) = st

    testing = active & (k < cnt)

    # --- test a chunk of the current cell's triangles ---
    idx = start[:, None] + k[:, None] + jnp.arange(CHUNK, dtype=jnp.int32)[None]
    in_list = testing[:, None] & (idx < (start + cnt)[:, None])
    ids = accel.tri_ids[jnp.clip(idx, 0, e_cap - 1)]  # (R, CHUNK)
    rows = tri_pack[jnp.where(in_list, ids, tri_pack.shape[0] - 1)]  # (R, CHUNK, 9)
    hit, t, u, v = _moller_trumbore(
        origin[:, None], direction[:, None],
        rows[..., 0:3], rows[..., 3:6], rows[..., 6:9],
    )
    hit = hit & in_list & (t < best_t[:, None])
    tm = jnp.where(hit, t, _BIG)
    j = jnp.argmin(tm, axis=1)
    tj = jnp.take_along_axis(tm, j[:, None], 1)[:, 0]
    closer = tj < best_t
    best_id = jnp.where(closer, jnp.take_along_axis(ids, j[:, None], 1)[:, 0], best_id)
    best_u = jnp.where(closer, jnp.take_along_axis(u, j[:, None], 1)[:, 0], best_u)
    best_v = jnp.where(closer, jnp.take_along_axis(v, j[:, None], 1)[:, 0], best_v)
    best_t = jnp.where(closer, tj, best_t)
    k = jnp.where(testing, k + CHUNK, k)

    # --- advance every ray whose cell is exhausted ---
    stepping = active & (k >= cnt)
    axis = jnp.argmin(t_next, axis=-1)  # (R,)
    t_exit = jnp.take_along_axis(t_next, axis[:, None], -1)[:, 0]
    # nearest confirmed once the current cell lies past it
    finished = stepping & (t_exit >= best_t)

    # single-cell DDA step (the near-surface / occupied-neighborhood case)
    onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
    new_cell = cell3 + onehot * step
    oob = jnp.any((new_cell < 0) | (new_cell >= resv), axis=-1)
    finished = finished | (stepping & oob)
    move = stepping & ~finished

    # empty-space jump (proximity cloud)
    jump = move & (dist >= 2)
    t_land = t_cur + (dist - 1).astype(dtype) * t_min_delta + 1e-6
    p_land = origin + direction * t_land[:, None]
    c3_j = jnp.floor((p_land - box_lo) / accel.cell).astype(jnp.int32)
    nb_j = (
        box_lo
        + (c3_j + (step > 0).astype(jnp.int32)).astype(dtype) * accel.cell
    )
    tn_j = jnp.where(step == 0, _BIG, (nb_j - origin) * inv_d)
    oob_j = jnp.any((c3_j < 0) | (c3_j >= resv), axis=-1)
    finished = finished | (jump & oob_j)
    jump = jump & ~oob_j
    move = move & ~jump

    cell3 = jnp.where(
        jump[:, None], c3_j, jnp.where(move[:, None], new_cell, cell3)
    )
    t_next = jnp.where(
        jump[:, None],
        tn_j,
        jnp.where(
            move[:, None], t_next + onehot.astype(dtype) * t_delta, t_next
        ),
    )
    t_cur = jnp.where(jump, t_land, jnp.where(move, t_exit, t_cur))
    moved = move | jump
    s2, c2, d2 = _fetch(accel, cell3)
    start = jnp.where(moved, s2, start)
    cnt = jnp.where(moved, c2, cnt)
    dist = jnp.where(moved, d2, dist)
    k = jnp.where(moved, 0, k)
    active = active & ~finished

    return TravState(
        active, cell3, t_next, t_cur, start, cnt, dist, k,
        best_t, best_id, best_u, best_v,
    )


def traverse(
    accel: Accel,
    tri_pack: jnp.ndarray,  # (T+1, 9): p0|e1|e2 rows, last row degenerate
    origin: jnp.ndarray,  # (R, 3)
    direction: jnp.ndarray,  # (R, 3)
    t_max,
    max_iters: Optional[int] = None,
):
    """Nearest triangle hit per ray: returns (t, tri_id, u, v) with t == t_max
    and tri_id == -1 for misses. t is in units of |direction|."""
    rx, ry, rz = accel.res
    if max_iters is None:
        max_iters = 2 * (rx + ry + rz) + 64

    st0 = init_state(accel, tri_pack, origin, direction, t_max)

    def cond(carry):
        it, st = carry
        return (it < max_iters) & jnp.any(st.active)

    def body(carry):
        it, st = carry
        return it + 1, step_state(accel, tri_pack, origin, direction, st)

    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st0))
    return st.best_t, st.best_id, st.best_u, st.best_v


def pack_tris(scene) -> jnp.ndarray:
    """(T+1, 9) p0|e1|e2 rows; the last row is a degenerate never-hit
    triangle used for masked lanes."""
    pack = jnp.concatenate([scene.tri_p0, scene.tri_e1, scene.tri_e2], axis=1)
    return jnp.concatenate([pack, jnp.zeros((1, 9), pack.dtype)], axis=0)
