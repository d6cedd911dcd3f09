"""Depth supervision (ref: testbed_nerf.cu:1450-1452,1537-1540): the loss
term must be live (affects params) and must pull the composited expected
ray depth toward the depth-map target."""


import numpy as np
import pytest

from synthetic import make_orbit_dataset


def _dataset_with_depth(n_img=6, res=24, radius=1.5, depth_value=None):
    ds = make_orbit_dataset(n_images=n_img, res=res, radius=radius)
    # opaque mid-gray everywhere so every ray trains
    ds.images = np.full((n_img, res, res, 4), 0.6, np.float32)
    ds.images[..., 3] = 1.0
    # depth maps in ray-distance-at-unit-z units; cameras look at the
    # center from `radius` away, so a constant plane through the center
    # is ~radius deep along the optical axis
    dv = radius if depth_value is None else depth_value
    ds.depth_images = np.full((n_img, res, res), dv, np.float32)
    return ds


def _make_trainer(ds, lam):
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tc = NerfTrainerConfig(n_rays=512, target_batch_size=1 << 12,
                           march_steps=1024, random_bg_color=False,
                           depth_supervision_lambda=lam)
    return NerfTrainer(ds, cfg, tcfg=tc, seed=7)


def _expected_depth(tr, n_check=256):
    """Composite Σ w·t along random training rays with current params."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    img = jnp.zeros((n_check,), jnp.int32)
    xy = jax.random.uniform(key, (n_check, 2)) * 0.6 + 0.2
    o, d, _ = tr._build_rays(tr.data, tr.cam_params, img, xy)
    t, dt, emit = tr._march(jnp.full_like(tr.grid.bitfield, 255), o, d,
                            key, n_check)
    sigma_fn = lambda p: tr.model.density(tr.params, p)
    pos = o[:, None, :] + t[..., None] * d[:, None, :]
    warped = (pos - tr.aabb_min) / tr.aabb_size
    dens = sigma_fn(warped.reshape(-1, 3)).reshape(t.shape)
    sigma = jnp.exp(jnp.clip(dens, -15., 15.)) * emit
    sdt = sigma * dt
    T = jnp.exp(-jnp.cumsum(sdt, axis=1) + sdt)
    w = T * (1 - jnp.exp(-sdt))
    wsum = jnp.maximum(w.sum(1), 1e-6)
    return np.asarray((w * t).sum(1) / wsum)


@pytest.mark.slow
def test_depth_term_changes_training():
    ds = _dataset_with_depth()
    tr0 = _make_trainer(ds, 0.0)
    tr1 = _make_trainer(ds, 0.9)
    assert "depths" in tr1.data
    tr0.train(2)
    tr1.train(2)
    import jax
    l0 = jax.tree.leaves(tr0.params)
    l1 = jax.tree.leaves(tr1.params)
    assert any(not np.allclose(a, b) for a, b in zip(l0, l1)), \
        "depth_supervision_lambda must change the gradient"


@pytest.mark.slow
def test_depth_supervision_pulls_expected_depth():
    radius = 1.5
    target = 1.1  # force geometry nearer than image-only training would
    ds = _dataset_with_depth(radius=radius, depth_value=target)
    tr = _make_trainer(ds, 4.0)
    tr.train(120)
    dep = _expected_depth(tr)
    # median expected depth should land near the supervised target
    med = float(np.median(dep))
    assert abs(med - target) < 0.35, f"expected ~{target}, got {med}"


def test_loader_depth_world_scale(tmp_path):
    """integer_depth_scale must be multiplied by the world scale
    (ref: nerf_loader.cu:732 passes depth_scale * result.scale)."""
    import json
    from PIL import Image
    from ngp_jax.data.nerf_loader import load_nerf

    img = (np.random.rand(8, 8, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "f.png")
    depth = np.full((8, 8), 1000, np.uint16)
    Image.fromarray(depth, mode="I;16").save(tmp_path / "f_d.png")
    tj = {
        "camera_angle_x": 0.9, "aabb_scale": 1,
        "integer_depth_scale": 0.002,
        "frames": [{"file_path": "f.png", "depth_path": "f_d.png",
                    "transform_matrix": np.eye(4).tolist()}],
    }
    (tmp_path / "transforms.json").write_text(json.dumps(tj))
    ds = load_nerf(str(tmp_path), scale=0.33, offset=[0.5, 0.5, 0.5])
    assert ds.depth_images is not None
    np.testing.assert_allclose(ds.depth_images[0, 0, 0],
                               1000 * 0.002 * 0.33, rtol=1e-5)
