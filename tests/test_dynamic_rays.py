"""dynamic_rays: live-ray masking adapts the ACTIVE ray count as a traced
scalar instead of recompiling per ray-count (the reference adapts
rays_per_batch every step, testbed_nerf.cu:2890-2891; static shapes
are what jit compiles)."""
import numpy as np

from synthetic import make_orbit_dataset


def _small_cfg():
    from ngp_jax.config import load_network_config
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    return cfg


def test_full_mask_matches_static_path():
    """n_live == n_rays must reproduce the static path exactly (the
    mask is the identity; RNG stream and graph are otherwise equal)."""
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig
    ds = make_orbit_dataset(res=16, aabb_scale=1)
    mk = lambda dyn: NerfTrainer(ds, _small_cfg(), seed=3, tcfg=NerfTrainerConfig(
        n_rays=128, adapt_rays=False, dynamic_rays=dyn,
        target_batch_size=4096, march_steps=128))
    a, b = mk(False), mk(True)
    b._n_live = 128                       # pin: adaptation may differ
    la = a.train(8)
    b_loss = b.train(8)
    assert np.isfinite(la) and np.isfinite(b_loss)
    np.testing.assert_allclose(la, b_loss, rtol=1e-4)


def test_live_count_masks_rays_and_adapts():
    """A small n_live must (a) train without error, (b) produce fewer
    measured samples than the full batch, (c) adapt upward when the
    sample budget allows."""
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig
    ds = make_orbit_dataset(res=16, aabb_scale=1)
    tr = NerfTrainer(ds, _small_cfg(), seed=3, tcfg=NerfTrainerConfig(
        n_rays=256, adapt_rays=False, dynamic_rays=True,
        target_batch_size=4096, march_steps=128))
    tr._n_live = 128
    tr.train(16)
    full_like = tr.last_surviving_segments
    lo = tr._n_live
    tr._n_live = 16
    tr.train(16)
    assert tr.last_surviving_segments < full_like
    assert np.isfinite(tr.last_loss)
    # feedback law grows the live count again (bounded by n_rays)
    assert 16 <= tr._n_live <= 256
    assert lo <= 256
