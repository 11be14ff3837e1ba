"""Materials and BSDF evaluation/sampling over flat tables.

Replaces the reference's ``std::variant`` BSDFs (``bsdf.h/.cpp``) and
materials (``material.h/.cpp``) with a table: kind id + parameters per
material, and batched evaluate/sample functions that compute all three BSDF
kinds elementwise and select by kind — branchless, wavefront-friendly, and
differentiable w.r.t. albedo/emission/IOR.

Conventions (identical to the reference):
- tangent space with the shading normal on the +Y axis
  (``common.h:112-116``),
- directions point away from the surface,
- Lambertian is double-sided with cosine sampling (``bsdf.cpp:12-45``),
- perfect mirror divides by |cos| to cancel the Lambertian term
  (``bsdf.cpp:48-68``),
- dielectric transmission splits reflection/refraction by Fresnel, handles
  total internal reflection, and multiplies eta^2 in radiance transport
  (``bsdf.cpp:71-117``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from libfluid_tpu.math import warping

LAMBERTIAN = 0
SPECULAR_REFLECTION = 1
SPECULAR_TRANSMISSION = 2

# transport modes (ref bsdf.h:13-16)
RADIANCE = 0
IMPORTANCE = 1

_PI = jnp.pi


class MaterialTable(NamedTuple):
    """Flat material parameters; index 0 is reserved for the "null" material
    (black lambertian, no emission) used by padding primitives.

    Texture support mirrors the reference's ``channel<T>`` = optional texture
    x modulation (``material.h:18-29``): per material an albedo/emission
    texture id into one stacked texture array; id 0 is a 1x1 white texel, so
    "no texture" needs no branch — the channel value is always
    ``modulation * sample(texture, uv)``.
    """

    kind: jnp.ndarray  # (M,) int32
    albedo: jnp.ndarray  # (M, 3) reflectance / transmission skin modulation
    ior: jnp.ndarray  # (M,)
    emission: jnp.ndarray  # (M, 3)
    albedo_tex: jnp.ndarray = None  # (M,) int32, 0 = untextured
    emission_tex: jnp.ndarray = None  # (M,) int32
    textures: jnp.ndarray = None  # (NT, TH, TW, 3); texture 0 = white
    tex_hw: jnp.ndarray = None  # (NT, 2) int32 true (h, w) per texture


def default_textures(dtype=jnp.float32):
    """The trivial texture set: one white texel."""
    return (
        jnp.ones((1, 1, 1, 3), dtype),
        jnp.ones((1, 2), jnp.int32),
    )


def sample_texture(textures, tex_hw, tex_id, uv):
    """Bilinear texture sample, matching ``image::sample`` semantics
    (``common.h:38-64``): uv wraps, texel centers at (i+0.5)/n, edge clamp.
    `tex_id` (...,) int32, `uv` (..., 2) with u = x (width), v = y (height).
    Differentiable w.r.t. texel values."""
    hw = tex_hw[tex_id].astype(uv.dtype)  # (..., 2) true (h, w)
    size = jnp.stack([hw[..., 1], hw[..., 0]], axis=-1)  # (w, h) in uv order
    uvw = uv - jnp.floor(uv)  # wrap (common.h:41)
    p = uvw * size + 0.5
    ip = jnp.floor(p)
    frac = p - ip
    tl = jnp.maximum(ip - 1.0, 0.0).astype(jnp.int32)
    br = jnp.minimum(ip, size - 1.0).astype(jnp.int32)
    x0, y0 = tl[..., 0], tl[..., 1]
    x1, y1 = br[..., 0], br[..., 1]
    # texel fetch: one (..., 3)-row gather per corner (x = width index)
    def at(yy, xx):
        return textures[tex_id, yy, xx]

    p_tl = at(y0, x0)
    p_tr = at(y0, x1)
    p_bl = at(y1, x0)
    p_br = at(y1, x1)
    fx = frac[..., 0:1]
    fy = frac[..., 1:2]
    top = p_tl + (p_tr - p_tl) * fx
    bot = p_bl + (p_br - p_bl) * fx
    return top + (bot - top) * fy


def _channel(table: MaterialTable, base, tex_ids, mat_id, uv):
    if uv is None or table.textures is None or table.textures.shape[0] <= 1:
        return base
    return base * sample_texture(
        table.textures, table.tex_hw, tex_ids[mat_id], uv
    )


def albedo_at(table: MaterialTable, mat_id, uv=None):
    """channel::get_value for the albedo (``material.h:22-28``)."""
    return _channel(table, table.albedo[mat_id], table.albedo_tex, mat_id, uv)


def emission_at(table: MaterialTable, mat_id, uv=None):
    return _channel(
        table, table.emission[mat_id], table.emission_tex, mat_id, uv
    )


class BsdfSample(NamedTuple):
    direction: jnp.ndarray  # (..., 3) outgoing direction, tangent space
    pdf: jnp.ndarray  # (...,)
    reflectance: jnp.ndarray  # (..., 3) BSDF value (specular: pre-divided by |cos|)
    is_delta: jnp.ndarray  # (...,) bool


def fresnel_dielectric(cos_in, cos_out, eta_in, eta_out):
    """Unpolarized dielectric Fresnel from both angles (``fresnel.cpp:21-29``)."""
    r_par = (eta_out * cos_in - eta_in * cos_out) / (
        eta_out * cos_in + eta_in * cos_out
    )
    r_perp = (eta_in * cos_in - eta_out * cos_out) / (
        eta_in * cos_in + eta_out * cos_out
    )
    return 0.5 * (r_par * r_par + r_perp * r_perp)


def _mirror_dir(w):
    """Reflect about the tangent-space normal (+Y)."""
    return jnp.stack([-w[..., 0], w[..., 1], -w[..., 2]], axis=-1)


def sample_bsdf(
    table: MaterialTable,
    mat_id: jnp.ndarray,
    win: jnp.ndarray,
    xi: jnp.ndarray,
    mode: int = RADIANCE,
    uv: jnp.ndarray = None,
) -> BsdfSample:
    """Sample an outgoing direction per ray; `win` (..., 3) tangent-space
    incoming direction (pointing away from the surface), `xi` (..., 2).
    `uv` enables textured albedo (``material.h:18-29``)."""
    kind = table.kind[mat_id]
    albedo = albedo_at(table, mat_id, uv)
    ior = table.ior[mat_id]
    cos_in_sgn = win[..., 1]
    abs_cos_in = jnp.maximum(jnp.abs(cos_in_sgn), 1e-8)

    # --- lambertian (double-sided cosine) ---
    # warping returns z-up; tangent space is y-up -> swap; flip to the
    # incoming side when win.y < 0 (double-sided, ref bsdf.cpp:21-26)
    d = warping.unit_hemisphere_cosine_from_unit_square(xi)
    flip = cos_in_sgn < 0.0
    y_lam = jnp.where(flip, -d[..., 2], d[..., 2])
    d_lam = jnp.stack([d[..., 0], y_lam, d[..., 1]], axis=-1)
    pdf_lam = jnp.abs(d_lam[..., 1]) / _PI
    f_lam = albedo / _PI

    # --- perfect mirror ---
    d_mir = _mirror_dir(win)
    pdf_mir = jnp.ones_like(pdf_lam)
    f_mir = albedo / abs_cos_in[..., None]

    # --- dielectric transmission (ref bsdf.cpp:77-112) ---
    entering = cos_in_sgn >= 0.0
    eta_in = jnp.where(entering, 1.0, ior)
    eta_out = jnp.where(entering, ior, 1.0)
    cos_in = jnp.abs(cos_in_sgn)
    sign = jnp.where(entering, 1.0, -1.0)
    eta = eta_in / eta_out
    sin2_out = (1.0 - cos_in * cos_in) * eta * eta
    tir = sin2_out >= 1.0
    # double-where against sqrt'(0) = inf on TIR lanes (0-cot * inf = NaN)
    cos_out = jnp.where(
        tir, 0.0, jnp.sqrt(jnp.where(tir, 1.0, 1.0 - sin2_out))
    )
    fres = jnp.where(tir, 1.0, fresnel_dielectric(cos_in, cos_out, eta_in, eta_out))
    refract = (xi[..., 0] > fres) & ~tir
    d_refr = -eta[..., None] * win
    d_refr = d_refr.at[..., 1].add((eta * cos_in - cos_out) * sign)
    d_tr = jnp.where(refract[..., None], d_refr, _mirror_dir(win))
    pdf_tr = jnp.where(refract, 1.0 - fres, fres)
    eta2 = jnp.where(mode == RADIANCE, eta * eta, 1.0)
    f_refr = (1.0 - fres)[..., None] * albedo / jnp.maximum(cos_out, 1e-8)[..., None]
    f_refr = f_refr * eta2[..., None]
    f_refl = fres[..., None] * albedo / cos_in[..., None]
    f_tr = jnp.where(refract[..., None], f_refr, f_refl)
    pdf_tr = jnp.where(tir, 1.0, pdf_tr)
    f_tr = jnp.where(tir[..., None], albedo / cos_in[..., None], f_tr)

    is_mir = kind == SPECULAR_REFLECTION
    is_tr = kind == SPECULAR_TRANSMISSION
    direction = jnp.where(
        is_tr[..., None], d_tr, jnp.where(is_mir[..., None], d_mir, d_lam)
    )
    pdf = jnp.where(is_tr, pdf_tr, jnp.where(is_mir, pdf_mir, pdf_lam))
    refl = jnp.where(is_tr[..., None], f_tr, jnp.where(is_mir[..., None], f_mir, f_lam))
    return BsdfSample(
        direction=direction,
        pdf=pdf,
        reflectance=refl,
        is_delta=is_mir | is_tr,
    )


def eval_bsdf(table: MaterialTable, mat_id, win, wout, uv=None):
    """f(in, out) — nonzero only for non-delta BSDFs (``bsdf.cpp:12-14``)."""
    kind = table.kind[mat_id]
    albedo = albedo_at(table, mat_id, uv)
    same_side = win[..., 1] * wout[..., 1] > 0.0
    f_lam = jnp.where(same_side[..., None], albedo / _PI, 0.0)
    return jnp.where((kind == LAMBERTIAN)[..., None], f_lam, 0.0)


def pdf_bsdf(table: MaterialTable, mat_id, win, wout):
    """Solid-angle pdf of sample_bsdf for non-delta BSDFs (``bsdf.cpp:31-42``)."""
    kind = table.kind[mat_id]
    same_side = win[..., 1] * wout[..., 1] > 0.0
    p_lam = jnp.where(same_side, jnp.abs(wout[..., 1]) / _PI, 0.0)
    return jnp.where(kind == LAMBERTIAN, p_lam, 0.0)


def emission_of(table: MaterialTable, mat_id):
    return table.emission[mat_id]


def is_delta_kind(table: MaterialTable, mat_id):
    k = table.kind[mat_id]
    return (k == SPECULAR_REFLECTION) | (k == SPECULAR_TRANSMISSION)
