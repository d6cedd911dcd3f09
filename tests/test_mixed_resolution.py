"""Mixed-resolution captures: the device dataset is a flat pixel pool, so
images of different sizes train without max-res padding (round-1 weak
spot) and pixel lookups hit the right image rows."""
import numpy as np
import pytest

from synthetic import make_orbit_dataset


@pytest.mark.slow
def test_mixed_resolution_training_and_lookup():
    import jax
    import jax.numpy as jnp
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    ds = make_orbit_dataset(n_images=4, res=32)
    # shrink images 1 and 3 to 16×16 (content in the top-left corner of
    # the padded host array, like the loader produces)
    ds.resolution = ds.resolution.copy()
    ds.resolution[1] = [16, 16]
    ds.resolution[3] = [16, 16]
    ds.images = ds.images.copy()
    # distinct constant colors per image so lookups are identifiable
    for i, c in enumerate([0.2, 0.4, 0.6, 0.8]):
        ds.images[i, :, :, :3] = c
        ds.images[i, :, :, 3] = 1.0
    ds.focal = ds.focal.copy()
    ds.focal[1] /= 2
    ds.focal[3] /= 2

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=2048, march_steps=64))

    # pool size = Σ w·h, not I·Wmax·Hmax
    expect = 2 * 32 * 32 + 2 * 16 * 16
    assert tr.data["pixels"].shape[0] == expect

    # per-image lookup returns that image's color
    for img_id, c in enumerate([0.2, 0.4, 0.6, 0.8]):
        img = jnp.full((8,), img_id, jnp.int32)
        xy = jnp.asarray(np.random.default_rng(1).random((8, 2)),
                         jnp.float32)
        res = tr.data["resolution"][img]
        pix = jnp.clip((xy * res).astype(jnp.int32), 0,
                       res.astype(jnp.int32) - 1)
        tex = np.asarray(tr.data["pixels"][
            tr._pixel_index(tr.data, img, pix)])
        np.testing.assert_allclose(tex[:, :3], c, atol=1e-2)

    assert np.isfinite(tr.train(2))
