"""The Pallas GPU correction kernel against its jnp oracle.

The CPU tests run the kernel in Pallas' interpret mode and pin what
surrounds it: the jitter, the gradient rule, the dispatch, the compile cache
and ``chip_smoke.py``'s refusal to run without a GPU. The test marked
``gpu`` compiles the kernel for the card; it skips without one. Run it on
the card without the project conftest (which pins the CPU):

    python -m pytest tests/test_gpu_kernels.py -m gpu -q -p no:cacheprovider --noconftest
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libfluid_tpu.config import SimConfig
from libfluid_tpu.sim import correction, kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _payload(grid_size, kc, key, fill=0.5, coincident=True):
    """Random resident slots: prefix-dense per cell like the slot build, a
    few exactly coincident pairs, positions in world units."""
    nx, ny, nz = grid_size
    k1, k2 = jax.random.split(key)
    cell = jnp.stack(
        jnp.meshgrid(
            jnp.arange(nx), jnp.arange(ny), jnp.arange(nz), indexing="ij"
        )
    ).astype(jnp.float32)[:, None]  # (3, 1, nx, ny, nz)
    pos = cell + jax.random.uniform(k1, (3, kc, nx, ny, nz))
    count = jax.random.randint(k2, (nx, ny, nz), 0, kc + 1)
    count = jnp.where(jax.random.uniform(k1, (nx, ny, nz)) < fill, count, 0)
    mask = (jnp.arange(kc)[:, None, None, None] < count[None]).astype(jnp.float32)
    if coincident:
        pos = pos.at[:, 1].set(pos[:, 0])  # slot 1 sits on slot 0
    return pos * mask[None], mask


def _scale(pos):
    # springs = pos*wsum - wnbr cancels catastrophically; the attainable
    # agreement is an ulp of the |pos|*wsum intermediate, so errors are
    # normalised by that scale rather than by the residual spring
    return float(np.max(np.abs(np.asarray(pos)))) * 100.0


@pytest.mark.parametrize(
    "grid_size,kc",
    [((6, 5, 7), 12), ((4, 3, 40), 8), ((3, 4, 5), 3)],
    ids=["k12", "k8-two-z-tiles", "k3"],
)
def test_kernel_interpret_matches_oracle(grid_size, kc):
    cfg = SimConfig(grid_size=grid_size, cell_size=1.0)
    pos, mask = _payload(grid_size, kc, jax.random.PRNGKey(kc))
    re2 = cfg.cell_size**2 / 2.0
    seed, origin = jnp.int32(12345), jnp.asarray([2, 0, 1], jnp.int32)
    want = correction._springs_jnp(pos, mask, re2, seed, cfg, origin=origin)
    got = correction._springs_triton(
        pos, mask, re2, seed, cfg, origin, interpret=True
    )
    assert got.shape == want.shape
    assert float(jnp.max(jnp.abs(want))) > 0.0
    err = float(jnp.max(jnp.abs(got - want))) / _scale(pos)
    assert err < 2e-6, err


def test_kernel_coincident_counts_and_self_exclusion():
    """One cell with two coincident residents and one apart: the counts see
    the coincident pair from both sides and never a slot against itself."""
    pos = jnp.zeros((3, 4, 1, 1, 1), jnp.float32)
    pos = pos.at[:, 0, 0, 0, 0].set(jnp.asarray([0.5, 0.5, 0.5]))
    pos = pos.at[:, 1, 0, 0, 0].set(jnp.asarray([0.5, 0.5, 0.5]))
    pos = pos.at[:, 2, 0, 0, 0].set(jnp.asarray([0.7, 0.5, 0.5]))
    mask = jnp.asarray([1.0, 1.0, 1.0, 0.0]).reshape(4, 1, 1, 1)
    springs, coin = kernels.correction_springs_triton(
        pos, mask, 0.5, interpret=True
    )
    np.testing.assert_array_equal(
        np.asarray(coin[:, 0, 0, 0]), [1.0, 1.0, 0.0, 0.0]
    )
    # slot 2 is pushed away (+x) from the coincident pair, the empty slot 3
    # gets nothing
    assert float(springs[0, 2, 0, 0, 0]) > 0.0
    np.testing.assert_array_equal(np.asarray(springs[:, 3]), 0.0)


def test_springs_gradient_rule(monkeypatch):
    """jax.grad through the custom_vjp with the kernel forward equals the
    grad of the jnp oracle."""
    cfg = SimConfig(grid_size=(4, 4, 6), cell_size=1.0)
    pos, mask = _payload(cfg.grid_size, 6, jax.random.PRNGKey(1), coincident=False)
    re2 = 0.5
    seed, origin = jnp.int32(7), jnp.zeros((3,), jnp.int32)
    monkeypatch.setattr(
        correction, "_springs_forward",
        lambda p, m, s, o, r, c: correction._springs_triton(
            p, m, r, s, c, o, interpret=True
        ),
    )
    w = jax.random.normal(jax.random.PRNGKey(2), pos.shape)

    def loss_kernel(p):
        return jnp.sum(w * correction._springs(p, mask, seed, origin, re2, cfg))

    def loss_oracle(p):
        return jnp.sum(
            w * correction._springs_jnp(p, mask, re2, seed, cfg, origin=origin)
        )

    np.testing.assert_allclose(
        float(loss_kernel(pos)), float(loss_oracle(pos)), rtol=1e-4
    )
    g_k = jax.grad(loss_kernel)(pos)
    g_o = jax.grad(loss_oracle)(pos)
    np.testing.assert_array_equal(np.asarray(g_k), np.asarray(g_o))


_TRITON_CALL = "xla.gpu.triton"  # the custom call a Pallas Triton kernel lowers to


def _lowered(fn, args, platform):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=(platform,)).as_text()


def _forward(cfg, kc=12):
    pos, mask = _payload(cfg.grid_size, kc, jax.random.PRNGKey(0))
    args = (pos, mask, jnp.int32(1), jnp.zeros((3,), jnp.int32))
    return (lambda p, m, s, o: correction._springs_forward(p, m, s, o, 0.5, cfg)), args


def test_dispatch_cpu_runs_oracle():
    cfg = SimConfig(grid_size=(4, 4, 4))
    fn, args = _forward(cfg)
    assert jax.default_backend() == "cpu"
    assert _TRITON_CALL not in _lowered(fn, args, "cpu")
    want = correction._springs_jnp(*args[:2], 0.5, args[2], cfg, origin=args[3])
    np.testing.assert_array_equal(np.asarray(jax.jit(fn)(*args)), np.asarray(want))


def test_dispatch_gpu_picks_kernel_and_cpu_lowering_keeps_oracle():
    cfg = SimConfig(grid_size=(4, 4, 4))
    fn, args = _forward(cfg)
    # the same program lowered for a GPU holds the kernel, and for the CPU
    # (also a GPU process' CPU device) only the oracle
    assert _TRITON_CALL in _lowered(fn, args, "cuda")
    assert _TRITON_CALL not in _lowered(fn, args, "cpu")
    # float64 never takes the kernel
    fn64, args64 = _forward(SimConfig(grid_size=(4, 4, 4), dtype=jnp.float64))
    assert _TRITON_CALL not in _lowered(fn64, args64, "cuda")


def test_dispatch_gpu_rejects_unsupported_shape():
    fn, args = _forward(SimConfig(grid_size=(2, 2, 2)), kc=kernels.MAX_SLOTS + 1)
    with pytest.raises(ValueError, match="slots per cell"):
        _lowered(fn, args, "cuda")


def test_cache_honours_env_dir(monkeypatch, tmp_path):
    from libfluid_tpu import cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_persistent_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert cache.enable_persistent_cache() == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    return jax.devices()[0]


@pytest.mark.gpu
def test_kernel_matches_oracle_at_128(gpu):
    """The compiled kernel at the 128^3, K=12 shape of the APIC substep."""
    cfg = SimConfig(grid_size=(128, 128, 128))
    pos, mask = _payload(cfg.grid_size, 12, jax.random.PRNGKey(3), fill=0.3)
    pos = pos + 0.25 * mask  # away from the origin, like the dam break
    re2 = 0.5
    seed, origin = jnp.int32(99), jnp.zeros((3,), jnp.int32)
    want = jax.jit(
        lambda p, m: correction._springs_jnp(p, m, re2, seed, cfg, origin=origin)
    )(pos, mask)
    got = jax.jit(
        lambda p, m: correction._springs_triton(p, m, re2, seed, cfg, origin)
    )(pos, mask)
    err = float(jnp.max(jnp.abs(got - want))) / _scale(pos)
    assert err < 2e-6, err
