"""Position-correction springs: resident pass + compacted overflow pass.

Reference ``_correct_positions`` (``simulation.cpp:562-610``) caps nothing;
the dense pass caps residents at ``correction_capacity`` and VERDICT r2
weak #4 flagged that truncated particles silently got no spring. These tests
pin the overflow pass that closes it."""

import jax
import jax.numpy as jnp
import numpy as np

from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import binning as binning_mod
from libfluid_tpu.sim import correction as correction_mod
from libfluid_tpu.sim import slots as slots_mod
from libfluid_tpu.sim.state import new_state


def _crowded_state(n_extra=6):
    """One cell stuffed with correction_capacity + n_extra particles."""
    cfg = SimConfig(
        grid_size=(8, 8, 8),
        particle_capacity=64,
        scheme=TransferScheme.APIC,
        max_neighbors_per_cell=16,
        correction_capacity=8,
        has_obstacles=False,
    )
    state = new_state(cfg, jax.random.PRNGKey(0))
    m = cfg.correction_capacity + n_extra
    rng = np.random.default_rng(3)
    pos = 4.0 + rng.uniform(0.05, 0.95, size=(m, 3))  # all in cell (4,4,4)
    position = np.zeros((64, 3), np.float32)
    position[:m] = pos
    active = np.zeros((64,), bool)
    active[:m] = True
    state = state._replace(
        position=jnp.asarray(position), active=jnp.asarray(active)
    )
    return cfg, state, m


def test_truncated_particles_receive_springs():
    cfg, state, m = _crowded_state()
    state, bins = binning_mod.sort_by_cell(state, cfg)
    slot_grid = slots_mod.build(
        state.position, state.velocity, state.affine, bins, cfg
    )
    kc = cfg.correction_capacity
    truncated = np.asarray(
        state.active & (slot_grid.slot_of >= kc * cfg.num_cells)
    )
    assert truncated.sum() == m - kc  # ranks kc..m-1

    out = correction_mod.correct_positions(
        state.position, state.active, slot_grid, cfg, 1.0 / 60.0,
        jax.random.PRNGKey(1),
    )
    moved = np.abs(np.asarray(out - state.position)).sum(axis=1)
    # every active particle in the crowded cell moves, truncated ones included
    assert (moved[np.asarray(state.active)] > 0).all()
    assert (moved[truncated] > 0).all()
    # inactive rows are untouched
    assert (moved[~np.asarray(state.active)] == 0).all()


def test_overflow_spring_matches_bruteforce():
    """The compacted pass computes the same spring the dense kernel would:
    sum over resident neighbors of w(d) * (x_i - x_j)."""
    cfg, state, m = _crowded_state(n_extra=3)
    state, bins = binning_mod.sort_by_cell(state, cfg)
    slot_grid = slots_mod.build(
        state.position, state.velocity, state.affine, bins, cfg
    )
    kc = cfg.correction_capacity
    re2 = cfg.cell_size**2 / 2.0
    truncated = state.active & (slot_grid.slot_of >= kc * cfg.num_cells)
    res_pos = slot_grid.position[:, :kc]
    res_mask = slot_grid.mask[:kc]
    idx, springs = correction_mod.overflow_springs(
        state.position, truncated, res_pos, res_mask, re2, cfg, 16
    )
    idx = np.asarray(idx)
    springs = np.asarray(springs)

    pos = np.asarray(state.position)
    act = np.asarray(state.active)
    tr = np.asarray(truncated)
    # brute force against the first kc sorted particles of the cell
    # (= the resident slots, since all particles share one cell)
    residents = pos[act][:kc]
    for row in range(len(idx)):
        i = idx[row]
        if i >= pos.shape[0]:
            assert np.all(springs[row] == 0.0)
            continue
        assert tr[i]
        d = pos[i] - residents  # (kc, 3)
        d2 = (d**2).sum(axis=1)
        kern = np.maximum(1.0 - d2 / re2, 0.0) ** 3
        w = np.where(d2 < 1e-12, 0.0, kern / np.sqrt(np.maximum(d2, 1e-12)))
        expect = (w[:, None] * d).sum(axis=0)
        np.testing.assert_allclose(springs[row], expect, rtol=2e-4, atol=1e-5)
