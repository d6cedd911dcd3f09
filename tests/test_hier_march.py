"""Hierarchical (segment-culled) march must produce exactly the flat
march+compaction's sample stream on sparse grids (the realistic regime;
the coarse mask is conservative so no true sample is ever culled)."""
import numpy as np
import pytest

from synthetic import make_orbit_dataset


@pytest.mark.slow
def test_hier_march_matches_flat_on_sparse_grid():
    import jax
    import jax.numpy as jnp
    from ngp_jax.config import load_network_config
    from ngp_jax.grid import occupancy as occ
    from ngp_jax.rays.marching import (compact_samples,
                                       march_and_compact_hier, march_rays)
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    ds = make_orbit_dataset(res=16, aabb_scale=4)
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=4096, march_steps=256))

    dens = jnp.where(jax.random.uniform(jax.random.PRNGKey(0),
                                        tr.grid.density.shape) > 0.97,
                     1.0, 0.0)                       # ~3% occupied
    grid = occ.rebuild_bitfield(tr.grid._replace(density=dens),
                                tr.max_cascade)

    key = jax.random.PRNGKey(1)
    img = jnp.zeros((64,), jnp.int32)
    xy = jax.random.uniform(key, (64, 2))
    o, d, _ = tr._build_rays(tr.data, tr.cam_params, img, xy)

    t, dt, emit = march_rays(grid.bitfield, o, d, None, 64, 256,
                             tr.cone_angle, tr.max_cascade, tr.aabb_min,
                             tr.aabb_size)
    s_t, _, s_ray, counts, _, _, total, _ = compact_samples(
        t, dt, emit, 64, 4096)
    h_t, _, h_ray, h_counts, _, _, h_total, _, _ = march_and_compact_hier(
        grid.bitfield, grid.coarse, o, d, None, 64, 256, tr.cone_angle,
        tr.max_cascade, tr.aabb_min, tr.aabb_size, 4096)

    nf, nh = int(counts.sum()), int(h_counts.sum())
    assert nf == nh and int(total) == int(h_total)
    np.testing.assert_allclose(np.asarray(s_t[:nf]), np.asarray(h_t[:nh]),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(s_ray[:nf]),
                                  np.asarray(h_ray[:nh]))


@pytest.mark.slow
def test_trainer_hier_step_finite():
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    ds = make_orbit_dataset(res=16, aabb_scale=4)
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=4096, march_steps=256,
        hierarchical_march=True))
    assert np.isfinite(tr.train(3))


def test_adapt_capacity_shrinks_and_trains():
    """adapt_capacity: the static stream bucket tracks the measured batch
    (pow2, >= 2^15 floor, <= target) and training stays finite across the
    shape change."""
    import numpy as np
    from synthetic import make_orbit_dataset
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    ds = make_orbit_dataset(res=16)
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, adapt_rays=False, adapt_capacity=True,
        target_batch_size=1 << 16, march_steps=128))
    tr.training_step = 512          # adaptation is gated past warmup
    loss = tr.train(32)
    assert np.isfinite(loss)
    # tiny scene, 256 rays: the measured batch is far below 2^16 → the
    # bucket must have shrunk to the floor region
    assert tr._capacity < (1 << 16)
    assert tr._capacity >= (1 << 15)
    loss2 = tr.train(32)            # trains at the shrunk shape
    assert np.isfinite(loss2)
