"""F-theta / LatLong lens models end-to-end (ref: read_lens
nerf_loader.cu:250-263; ray gen common_device.cuh:236-258 +
testbed_nerf.cu:1169-1173)."""
import json

import numpy as np
import pytest


def _write_scene(tmp_path, extra_keys):
    from PIL import Image
    img = (np.random.rand(16, 16, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "f.png")
    tj = {
        "camera_angle_x": 0.9, "aabb_scale": 1, "w": 16, "h": 16,
        **extra_keys,
        "frames": [{"file_path": "f.png",
                    "transform_matrix": np.eye(4).tolist()}],
    }
    (tmp_path / "transforms.json").write_text(json.dumps(tj))
    return tmp_path


def test_loader_latlong_mode(tmp_path):
    from ngp_jax.data.nerf_loader import load_nerf
    ds = load_nerf(str(_write_scene(tmp_path, {"latlong": True})))
    assert ds.lens_mode == "latlong"


def test_loader_ftheta_mode(tmp_path):
    from ngp_jax.data.nerf_loader import load_nerf
    ds = load_nerf(str(_write_scene(tmp_path, {
        "ftheta_p0": 0.0, "ftheta_p1": 1.0, "ftheta_p2": 0.0,
        "ftheta_p3": 0.0, "ftheta_p4": 0.0})))
    assert ds.lens_mode == "ftheta"
    np.testing.assert_allclose(ds.lens_params[0, :7],
                               [0, 1, 0, 0, 0, 16, 16])


def test_latlong_ray_directions():
    """uv (0.5, 0.5) → +z; uv (0.25, 0.5) → -x side; poles → ±y
    (ref: latlong_to_dir, common_device.cuh:251-258)."""
    import jax.numpy as jnp
    from ngp_jax.rays.camera import pixel_to_ray_train

    xy = jnp.asarray([[0.5, 0.5], [0.75, 0.5], [0.5, 0.999], [0.5, 0.001]])
    n = xy.shape[0]
    xf = jnp.broadcast_to(jnp.eye(3, 4), (n, 3, 4))
    ones2 = jnp.ones((n, 2))
    o, d = pixel_to_ray_train(xy, xf, ones2 * 16, ones2 * 0.5, ones2 * 16,
                              jnp.zeros((n, 7)), False, lens_mode="latlong")
    d = np.asarray(d / np.linalg.norm(np.asarray(d), axis=-1,
                                      keepdims=True))
    np.testing.assert_allclose(d[0], [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(d[1], [1, 0, 0], atol=1e-4)  # phi = +π/2
    assert d[2][1] > 0.99 and d[3][1] < -0.99               # poles


def test_ftheta_identity_polynomial_matches_pinhole_angles():
    """With θ(r) = r·s (linear polynomial), the ray angle from the axis
    must equal the pixel radius × s (ref: f_theta_undistortion)."""
    import jax.numpy as jnp
    from ngp_jax.rays.camera import f_theta_undistort

    # params: p0..p4 = (0, 0.01, 0, 0, 0), native res 100×100
    params = jnp.asarray([[0.0, 0.01, 0.0, 0.0, 0.0, 100.0, 100.0]] * 3)
    xy_rel = jnp.asarray([[0.1, 0.0], [0.0, 0.2], [0.15, 0.15]])
    d = np.asarray(f_theta_undistort(xy_rel, params,
                                     jnp.asarray([0., 0., 1.])))
    for i, (rx, ry) in enumerate([(0.1, 0.0), (0.0, 0.2), (0.15, 0.15)]):
        rpix = np.hypot(rx * 100, ry * 100)
        theta = 0.01 * rpix
        got = np.arccos(d[i, 2] / np.linalg.norm(d[i]))
        np.testing.assert_allclose(got, theta, atol=1e-5)
