"""The z-shard particle exchange keeps every particle a nearly full block
receives from above (the rows once landed past its free slots)."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from libfluid_tpu.config import SimConfig
from libfluid_tpu.parallel import make_mesh
from libfluid_tpu.parallel.zshard import AXIS, _exchange_particles


def test_nearly_full_block_keeps_rows_from_above():
    cfg = SimConfig(grid_size=(4, 4, 8))
    nl, cap = 8, 4
    mesh = make_mesh(2)
    # device 0 owns z cells 0..3 and holds 6 of its 8 rows (2 free < cap);
    # device 1 owns z 4..7 and one of its particles has moved down to z 2.5
    z = np.array([0.5, 1.5, 2.5, 3.5, 0.5, 1.5, 0, 0,
                  2.5, 5.5, 0, 0, 0, 0, 0, 0], np.float32)
    act = np.array([1, 1, 1, 1, 1, 1, 0, 0,
                    1, 1, 0, 0, 0, 0, 0, 0], bool)
    pos = np.stack([np.full(16, 1.5, np.float32)] * 2 + [z], axis=1)
    vel = np.zeros((16, 3), np.float32)
    aff = np.zeros((16, 3, 3), np.float32)

    def run(p, v, a, m):
        p, v, a, m, lost = _exchange_particles(p, v, a, m, cfg, 4, cap)
        return p, m, lost

    p, m, lost = jax.shard_map(
        run, mesh=mesh, in_specs=(P(AXIS),) * 4,
        out_specs=(P(AXIS), P(AXIS), P()), check_vma=False,
    )(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(aff), jnp.asarray(act))
    p, m = np.asarray(p), np.asarray(m)
    assert int(lost) == 0
    assert m.sum() == act.sum()
    np.testing.assert_allclose(
        np.sort(p[:nl][m[:nl], 2]), [0.5, 0.5, 1.5, 1.5, 2.5, 2.5, 3.5]
    )
    np.testing.assert_allclose(p[nl:][m[nl:], 2], [5.5])
