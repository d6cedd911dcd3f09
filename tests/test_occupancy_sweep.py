"""Partial-sweep regression tests (round-4, the dba943c root cause).

A near-uniform early density field + the relative mean threshold made the
round-3 contiguous-block partial sweep cull an entire HALF-SPACE of the
scene from training (level-0 z<64 occupancy went 95% -> 0% after ONE
partial sweep). The sweep is now z-slab interleaved; these tests pin both
the interleaving and the full-coverage rotation property.
"""
import jax
import jax.numpy as jnp
import numpy as np

import ngp_jax.grid.occupancy as occ
from ngp_jax.common import GRID_VOLUME, MIN_CONE_STEPSIZE


def _uniform_density(c):
    return lambda warped: jnp.full((warped.shape[0],), c, jnp.float32)


def _noisy_density(c):
    """Near-uniform density with ±0.5% deterministic noise — the
    early-training regime where the relative mean threshold is sharpest
    (σ·Δt ≪ 0.01 so thresh == mean)."""
    def fn(warped):
        h = jnp.sin(warped @ jnp.asarray([127.1, 311.7, 74.7])) * 43758.5
        return c * (1.0 + 0.005 * (h - jnp.floor(h) - 0.5))
    return fn


def test_partial_sweep_no_halfspace_cull():
    """One partial sweep on a NEAR-UNIFORM field must not empty either
    spatial half of the level-0 bitfield (the dba943c failure mode:
    decayed cells at 0.95c fall below the 0.975c mean threshold, and a
    CONTIGUOUS refresh block turns that into a half-space cull)."""
    g = occ.init_grid(max_cascade=0)
    g = occ.update_grid(g, _noisy_density(1.0), jax.random.key(0),
                        max_cascade=0, n_uniform=GRID_VOLUME, n_nonuniform=1)
    bf0 = np.asarray(g.bitfield)[: GRID_VOLUME // 8].reshape(64, 64, 64)
    assert (bf0 != 0).mean() > 0.5  # ±noise around mean: ~half occupied

    g = occ.update_grid(g, _noisy_density(1.0), jax.random.key(1),
                        max_cascade=0)  # default partial budget (half)
    bf1 = np.asarray(g.bitfield)[: GRID_VOLUME // 8].reshape(64, 64, 64)
    lo, hi = (bf1[:32] != 0).mean(), (bf1[32:] != 0).mean()
    # interleaved sweep: the cull pattern must be spatially uniform —
    # both halves keep a comparable share of occupied cells
    assert lo > 0.1, f"lower half-space culled (occ={lo:.3f}, hi={hi:.3f})"
    assert hi > 0.1, f"upper half-space culled (occ={hi:.3f}, lo={lo:.3f})"


def test_partial_sweeps_cover_all_cells():
    """n_blocks consecutive partial sweeps must refresh EVERY cell: flip
    the density source from 0 to a recognizable value and check all
    (trained) cells pick it up after one full rotation."""
    max_cascade = 1
    g = occ.init_grid(max_cascade)
    n_cells = GRID_VOLUME * (max_cascade + 1)
    # rotation length for the default half-volume budget
    budget = GRID_VOLUME // 4 + GRID_VOLUME // 4
    n_rows = (max_cascade + 1) * 128
    n_blocks = max(int(round(n_cells / budget)), 1)
    while n_rows % n_blocks:
        n_blocks -= 1
    for i in range(n_blocks):
        g = occ.update_grid(g, _uniform_density(7.0), jax.random.key(i),
                            max_cascade=max_cascade)
    d = np.asarray(g.density)
    expect = 7.0 * MIN_CONE_STEPSIZE
    # every cell was refreshed at least once within the rotation; decay
    # since refresh is at most decay^(n_blocks-1)
    assert (d >= expect * 0.95 ** n_blocks - 1e-9).all(), \
        f"min={d.min()}, expected >= {expect * 0.95 ** n_blocks}"
    assert np.isclose(d.max(), expect, rtol=1e-5)


def test_full_sweep_matches_reference_semantics():
    """Full sweep: density = max(decay*old, splat) everywhere; untrained
    (-1) cells stay untrained (ref: ema_grid_samples_nerf +
    mark_untrained_density_grid)."""
    g = occ.init_grid(max_cascade=0)
    marked = g.density.at[:100].set(-1.0)
    g = g._replace(density=marked)
    g = occ.update_grid(g, _uniform_density(3.0), jax.random.key(0),
                        max_cascade=0, n_uniform=GRID_VOLUME, n_nonuniform=1)
    d = np.asarray(g.density)
    assert (d[:100] == -1.0).all()
    assert np.allclose(d[100:], 3.0 * MIN_CONE_STEPSIZE, rtol=1e-5)
