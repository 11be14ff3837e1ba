"""Pallas GPU kernel (Triton route) for the position-correction springs.

The plain jnp pass (:func:`libfluid_tpu.sim.correction._springs_jnp`) runs
27 fused XLA passes, one per neighbour offset, and each pass re-reads the
resident slot payload and reads and writes the five (KC, nx, ny, nz)
accumulators. This kernel reads each slot once per neighbouring tile and
keeps the accumulators in registers.

Design:

- one program per tile of ``TILE_Z`` cells along z (fixed x, y); it loads
  its own slots and, for each of the 27 neighbour offsets, the neighbour
  tile's slots with masked gather loads (out-of-domain cells load as empty);
- every output slot is a plain sum over its own neighbourhood, so programs
  write disjoint outputs and run in any order — each pair is evaluated from
  both sides instead of carrying Newton's-third-law halves between programs;
- the slot axis is padded from KC to a power of two under a mask;
- a tile with no residents writes zeros without touching its neighbours, and
  an empty neighbour tile is skipped: at a dam break most of the grid is air.

The kernel returns the jitter-free springs and the coincident-pair counts;
the caller adds the counter-hashed jitter in jnp, exactly as the oracle does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

TILE_Z = 32  # cells per program along z (a power of two)
NUM_WARPS = 4
MAX_SLOTS = 16  # slot capacity the kernel takes (padded to a power of two)


def check_correction_shape(kc: int, grid_size) -> None:
    """Raises ValueError for a slot payload the kernel cannot take."""
    nx, ny, nz = grid_size
    if not 1 <= kc <= MAX_SLOTS:
        raise ValueError(
            f"correction kernel takes 1..{MAX_SLOTS} slots per cell, got {kc}"
        )
    if 3 * kc * nx * ny * nz >= 2**31:
        raise ValueError(
            f"correction kernel indexes with int32; grid {grid_size} x {kc} "
            "slots is too large"
        )


def _springs_kernel(pos_ref, mask_ref, spr_ref, coin_ref, *,
                    grid_size, kc: int, kp: int, tz: int, re2: float):
    nx, ny, nz = grid_size
    ncell = nx * ny * nz
    nzb = pl.cdiv(nz, tz)
    # lax.div/rem: jnp's // and % on int32 scalars do not lower on this route
    div, rem = jax.lax.div, jax.lax.rem
    p = pl.program_id(0)
    zb = rem(p, nzb)
    y = rem(div(p, nzb), ny)
    x = div(p, nzb * ny)

    k = jnp.arange(kp, dtype=jnp.int32)
    z = zb * tz + jnp.arange(tz, dtype=jnp.int32)
    kin = (k < kc)[:, None]
    zin = (z < nz)[None, :]
    # (kp, tz) tiles: slot major, cells along z minor (coalesced loads)
    ridx = k[:, None] * ncell + ((x * ny + y) * nz + z)[None, :]
    rld = kin & zin
    rmask = plgpu.load(mask_ref.at[ridx], mask=rld, other=0.0)
    rpos = [
        plgpu.load(pos_ref.at[ridx + c * kc * ncell], mask=rld, other=0.0)
        for c in range(3)
    ]
    # pair tensors are (kp resident, kp neighbour, tz)
    same_slot = k[:, None, None] == k[None, :, None]
    zeros = jnp.zeros((kp, tz), jnp.float32)

    def offset(t, acc):
        dx = div(t, 9) - 1
        dy = rem(div(t, 3), 3) - 1
        dz = rem(t, 3) - 1
        xn = x + dx
        yn = y + dy
        zn = z + dz
        inb = (
            (xn >= 0) & (xn < nx) & (yn >= 0) & (yn < ny)
            & (zn >= 0)[None, :] & (zn < nz)[None, :]
        )
        nidx = k[:, None] * ncell + ((xn * ny + yn) * nz + zn)[None, :]
        nld = kin & inb
        nmask = plgpu.load(mask_ref.at[nidx], mask=nld, other=0.0)

        def pairs(acc):
            wsum, wx, wy, wz, coin = acc
            npos = [
                plgpu.load(pos_ref.at[nidx + c * kc * ncell], mask=nld, other=0.0)
                for c in range(3)
            ]
            sq = sum(
                (rpos[c][:, None, :] - npos[c][None, :, :]) ** 2 for c in range(3)
            )
            pair = rmask[:, None, :] * nmask[None, :, :]
            # d = (0, 0, 0): exclude each slot against itself
            pair = jnp.where((t == 13) & same_slot, 0.0, pair)
            degenerate = sq < 1e-12
            kern = jnp.maximum(1.0 - sq * (1.0 / re2), 0.0)
            w = kern * kern * kern * jax.lax.rsqrt(jnp.maximum(sq, 1e-12))
            w = jnp.where(degenerate, 0.0, w) * pair
            return (
                wsum + jnp.sum(w, axis=1),
                wx + jnp.sum(w * npos[0][None, :, :], axis=1),
                wy + jnp.sum(w * npos[1][None, :, :], axis=1),
                wz + jnp.sum(w * npos[2][None, :, :], axis=1),
                coin + jnp.sum(jnp.where(degenerate, pair, 0.0), axis=1),
            )

        return jax.lax.cond(jnp.max(nmask) > 0.0, pairs, lambda a: a, acc)

    def resident(_):
        return jax.lax.fori_loop(0, 27, offset, (zeros,) * 5)

    wsum, wx, wy, wz, coin = jax.lax.cond(
        jnp.max(rmask) > 0.0, resident, lambda _: (zeros,) * 5, None
    )
    for c, wc in enumerate((wx, wy, wz)):
        plgpu.store(spr_ref.at[ridx + c * kc * ncell], rpos[c] * wsum - wc,
                    mask=rld)
    plgpu.store(coin_ref.at[ridx], coin, mask=rld)


def correction_springs_triton(res_pos, res_mask, re2: float,
                              interpret: bool = False):
    """Jitter-free springs (3, KC, nx, ny, nz) and coincident-pair counts
    (KC, nx, ny, nz) for the resident slots; float32 only.
    ``interpret=True`` is for the CPU tests."""
    kc = res_pos.shape[1]
    grid_size = tuple(res_pos.shape[2:])
    check_correction_shape(kc, grid_size)
    nx, ny, nz = grid_size
    kp = max(pl.next_power_of_2(kc), 2)
    tz = min(TILE_Z, max(pl.next_power_of_2(nz), 2))
    ncell = nx * ny * nz
    spr, coin = pl.pallas_call(
        functools.partial(
            _springs_kernel, grid_size=grid_size, kc=kc, kp=kp, tz=tz,
            re2=float(re2),
        ),
        grid=(nx * ny * pl.cdiv(nz, tz),),
        out_shape=[
            jax.ShapeDtypeStruct((3 * kc * ncell,), jnp.float32),
            jax.ShapeDtypeStruct((kc * ncell,), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="correction_springs",
    )(res_pos.reshape(-1), res_mask.reshape(-1))
    return spr.reshape(res_pos.shape), coin.reshape(res_mask.shape)
