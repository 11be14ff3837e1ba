"""P2G/G2P transfer tests.

Key invariants (stronger than anything in the reference, which has no tests):
- PIC roundtrip preserves constant velocity fields,
- APIC P2G reproduces *affine* velocity fields exactly on faces (the weighted
  average of v_p + C(x_face - x_p) is exact for affine fields regardless of
  weights), and G2P recovers both the field and its gradient,
- G2P is the (normalized) adjoint of P2G in the PIC case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from libfluid_tpu import grids
from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import transfers


def _cfg(**kw):
    base = dict(
        grid_size=(8, 8, 8),
        cell_size=0.5,
        grid_offset=(-1.0, 0.0, 2.0),
        particle_capacity=512,
        scheme=TransferScheme.APIC,
    )
    base.update(kw)
    return SimConfig(**base)


def _random_particles(cfg, n, seed=0, margin=2.0):
    """Particles well inside the domain (margin cells from walls)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(cfg.domain_min) + margin * cfg.cell_size
    hi = np.asarray(cfg.domain_max) - margin * cfg.cell_size
    pos = rng.uniform(lo, hi, size=(cfg.particle_capacity, 3))
    active = np.zeros(cfg.particle_capacity, bool)
    active[:n] = True
    return jnp.asarray(pos, jnp.float32), jnp.asarray(active)


def test_pic_constant_field_roundtrip():
    cfg = _cfg(scheme=TransferScheme.PIC)
    pos, active = _random_particles(cfg, 300)
    vel = jnp.broadcast_to(jnp.array([1.0, -2.0, 0.5]), pos.shape)
    aff = jnp.zeros((pos.shape[0], 3, 3))
    u, v, w = transfers.p2g(pos, vel, aff, active, cfg)
    grid = grids.zeros(cfg)._replace(u=u, v=v, w=w)
    out, _ = transfers.g2p_pic(grid, pos, cfg)
    out = np.asarray(out)[np.asarray(active)]
    # faces between particles carry the exact constant; interpolation of a
    # constant is the constant wherever all 8 samples were touched.
    err = np.abs(out - np.array([1.0, -2.0, 0.5]))
    assert np.quantile(err, 0.9) < 1e-5


def test_apic_affine_field_exact():
    cfg = _cfg(grid_size=(12, 12, 12), particle_capacity=2048)
    pos, active = _random_particles(cfg, 1500, margin=2.5)
    a_mat = jnp.asarray(
        [[0.3, -0.1, 0.2], [0.0, 0.4, -0.2], [0.1, 0.1, -0.7]], jnp.float32
    )
    b = jnp.asarray([0.5, -1.0, 2.0], jnp.float32)
    vel = pos @ a_mat.T + b
    aff = jnp.broadcast_to(a_mat, (pos.shape[0], 3, 3))

    u, v, w = transfers.p2g(pos, vel, aff, active, cfg)
    grid = grids.zeros(cfg)._replace(u=u, v=v, w=w)

    # check face values where weight was accumulated: u face (i,j,k) at
    # world x = off + h*(i, j+.5, k+.5) should hold row0 of the affine field
    un = np.asarray(u)
    nz = np.argwhere(np.abs(un) > 1e-7)
    # restrict to faces fully inside the particle cloud support
    interior = nz[(nz.min(axis=1) >= 4) & (nz.max(axis=1) <= 7)]
    assert interior.shape[0] > 0
    h = cfg.cell_size
    offs = np.asarray(cfg.grid_offset)
    fpos = offs + (interior + np.array([0.0, 0.5, 0.5])) * h
    expect = fpos @ np.asarray(a_mat)[0] + float(b[0])
    got = un[interior[:, 0], interior[:, 1], interior[:, 2]]
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-4)

    # G2P recovers velocity and affine gradient for interior particles
    out_v, out_c = transfers.g2p_pic(grid, pos, cfg)
    act = np.asarray(active)
    pn = np.asarray(pos)
    # particles at least 2 cells away from the support edge of the cloud
    lo = np.asarray(cfg.domain_min) + 3.5 * h
    hi = np.asarray(cfg.domain_max) - 3.5 * h
    inner = act & np.all((pn > lo) & (pn < hi), axis=-1)
    assert inner.sum() > 20
    np.testing.assert_allclose(
        np.asarray(out_v)[inner], np.asarray(vel)[inner], rtol=2e-3, atol=2e-3
    )
    got_c = np.asarray(out_c)[inner]
    np.testing.assert_allclose(
        got_c, np.broadcast_to(np.asarray(a_mat), got_c.shape), atol=5e-3
    )


def test_p2g_weights_drop_out_of_bounds():
    cfg = _cfg()
    # a particle hugging the min corner: contributions beyond the walls drop
    pos = jnp.asarray([[cfg.grid_offset[0] + 0.01, cfg.grid_offset[1] + 0.01, cfg.grid_offset[2] + 0.01]])
    pos = jnp.broadcast_to(pos, (cfg.particle_capacity, 3))
    active = jnp.zeros((cfg.particle_capacity,), bool).at[0].set(True)
    vel = jnp.ones((cfg.particle_capacity, 3))
    aff = jnp.zeros((cfg.particle_capacity, 3, 3))
    u, v, w = transfers.p2g(pos, vel, aff, active, cfg)
    assert np.all(np.isfinite(np.asarray(u)))
    # normalized faces carry the particle velocity where touched
    assert np.isclose(np.asarray(u).max(), 1.0, atol=1e-6)


def test_g2p_is_adjoint_of_trilerp_gather():
    """<scatter(x), g> == <x, gather(g)> for the unnormalized kernel weights —
    the structural adjointness any custom kernel must preserve."""
    cfg = _cfg(scheme=TransferScheme.PIC)
    pos, active = _random_particles(cfg, 64)
    key = jax.random.PRNGKey(3)
    grid_cot = jax.random.normal(key, (cfg.nx + 1, cfg.ny, cfg.nz))

    def scatter_component(vals):
        aff = jnp.zeros((pos.shape[0], 3, 3))
        vel = jnp.stack([vals, jnp.zeros_like(vals), jnp.zeros_like(vals)], -1)
        u, _, _ = transfers.p2g(pos, vel, aff, active, cfg)
        return jnp.sum(u * grid_cot)

    vals = jax.random.normal(jax.random.PRNGKey(4), (pos.shape[0],))
    g = jax.grad(scatter_component)(vals)
    # compare against finite differences of the scalar (normalization makes
    # the raw adjoint non-trivial; autodiff must match FD)
    eps = 1e-3
    probe = jax.random.normal(jax.random.PRNGKey(5), vals.shape)
    fd = (scatter_component(vals + eps * probe) - scatter_component(vals - eps * probe)) / (2 * eps)
    np.testing.assert_allclose(jnp.vdot(g, probe), fd, rtol=2e-2, atol=1e-3)


def test_p2g_slots_exact_under_overflow():
    """Slot-grid P2G must equal the direct scatter P2G even when cells hold
    far more than K particles (the compacted overflow pass; reference
    per-cell lists are uncapped, simulation.cpp:293-412)."""
    import jax
    import numpy as np

    from libfluid_tpu.config import SimConfig, TransferScheme
    from libfluid_tpu.sim import binning as binning_mod
    from libfluid_tpu.sim import slots as slots_mod
    from libfluid_tpu.sim import transfers
    from libfluid_tpu.sim.state import new_state

    cfg = SimConfig(
        grid_size=(8, 8, 8),
        particle_capacity=1 << 12,
        scheme=TransferScheme.APIC,
    )
    key = jax.random.PRNGKey(5)
    state = new_state(cfg, key)
    n = cfg.particle_capacity
    k1, k2, k3 = jax.random.split(key, 3)
    # cram 200 particles into one cell (>> K=16, under the 256-entry
    # compaction cap); the rest spread over the domain
    pos = jnp.concatenate([
        jax.random.uniform(k1, (200, 3), minval=1.1, maxval=1.9),
        jax.random.uniform(k1, (n - 200, 3), minval=0.5, maxval=7.5),
    ])
    vel = jax.random.normal(k2, (n, 3))
    aff = jax.random.normal(k3, (n, 3, 3)) * 0.1
    state = state._replace(
        position=pos, velocity=vel, affine=aff,
        active=jnp.ones((n,), bool),
    )
    state, bins = binning_mod.sort_by_cell(state, cfg)
    sg = slots_mod.build(state.position, state.velocity, state.affine, bins, cfg)
    assert int(jnp.sum(sg.overflow)) > 0  # the regime under test

    got = transfers.p2g_slots(
        sg, state.position, state.velocity, state.affine, state.active, cfg
    )
    want = transfers.p2g(state.position, state.velocity, state.affine, state.active, cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=2e-4)
