"""Error-map importance sampling (ref: sample_cdf_2d + image_idx,
testbed_nerf.cu:991-1080): 0.5 uniform mixture, stratified-residual
jitter (uniform within cells, decorrelated from the cell pick), and
branch-local pdf bookkeeping."""
import numpy as np
import pytest

from synthetic import make_orbit_dataset


def _trainer():
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tc = NerfTrainerConfig(
        n_rays=512, target_batch_size=2048, march_steps=64,
        sample_focal_plane_proportional_to_error=True,
        sample_image_proportional_to_error=True, error_map_res=4)
    return NerfTrainer(make_orbit_dataset(n_images=4, res=16), cfg, tcfg=tc)


def test_cdf_sampling_distribution_and_pdf():
    import jax
    import jax.numpy as jnp

    tr = _trainer()
    # concentrate error in image 2, cell (row 1, col 3)
    em = np.full((4, 4, 4), 0.01, np.float32)
    em[2, 1, 3] = 10.0
    tr.error_map = jnp.asarray(em)
    state = tr._error_state()

    n = 8192
    img, xy, _, pdf = tr._sample_pixels(tr.data, state,
                                        jax.random.PRNGKey(0), n)
    img, xy, pdf = map(np.asarray, (img, xy, pdf))

    # image 2 must be strongly preferred in the CDF half of the mixture
    frac2 = (img == 2).mean()
    assert frac2 > 0.45, frac2      # ≈ 0.5·(1/4) + 0.5·(big weight)

    # the hot cell attracts the CDF half of those picks
    cells = np.floor(xy * 4).astype(int)
    hot = (img == 2) & (cells[:, 0] == 3) & (cells[:, 1] == 1)
    assert hot.mean() > 0.2, hot.mean()

    # pdf: uniform-branch picks report 1.0; hot-cell picks report > 1
    assert (pdf[hot] >= 1.0).mean() > 0.9
    assert np.isfinite(pdf).all() and (pdf > 0).all()

    # within-cell positions uniform (stratified residual, not correlated
    # with the CDF draw): mean ≈ cell center
    rel = xy[hot] * 4 - cells[hot]
    assert abs(rel[:, 0].mean() - 0.5) < 0.08
    assert abs(rel[:, 1].mean() - 0.5) < 0.08
    # spread close to uniform's std 1/sqrt(12) ≈ 0.289
    assert 0.2 < rel[:, 0].std() < 0.36
    assert 0.2 < rel[:, 1].std() < 0.36


def test_error_map_interval_growth():
    tr = _trainer()
    assert tr._error_map_interval == 128
    tr.train(2)
    # first rebuild happens once enough steps accumulate; growth is ×1.5
    tr._steps_since_error_map_update = 200
    tr.train(1)
    assert tr._error_map_interval == 192.0


def test_sharpness_grid_deposit():
    """Sharpness grid populates and error-map deposits stay finite when
    importance sampling is on (ref: testbed_nerf.cu:1476-1481 deposit +
    :557 decay)."""
    import jax.numpy as jnp
    import numpy as np
    from synthetic import make_orbit_dataset
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    ds = make_orbit_dataset(res=16)
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=2048, march_steps=64,
        sample_image_proportional_to_error=True,
        sample_focal_plane_proportional_to_error=True))
    assert tr._use_sharpness
    assert "sharpness_maps" in tr.data
    # force occupancy so rays have samples to deposit from (density set
    # high so the in-chunk grid rebuild keeps cells occupied)
    from ngp_jax.grid import occupancy as occ
    tr.grid = occ.rebuild_bitfield(
        tr.grid._replace(density=jnp.ones_like(tr.grid.density)),
        tr.max_cascade)
    tr.train(3)
    sg = np.asarray(tr.sharpness_grid)
    assert np.isfinite(sg).all()
    assert (sg > 0).any(), "no sharpness deposits landed"
    assert np.isfinite(np.asarray(tr.error_map)).all()
