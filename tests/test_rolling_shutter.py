"""Rolling shutter + motion blur (ref: get_xform_given_rolling_shutter,
common_device.cuh:224-234; render_to_cpu log_space_lerp,
python_api.cu:162-178)."""
import numpy as np
import pytest

from synthetic import make_orbit_dataset


def _rot(axis, ang):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)


def test_xform_slerp_endpoints_and_orthonormality():
    import jax.numpy as jnp
    from ngp_jax.rays.camera import xform_slerp

    a = np.concatenate([_rot([0, 0, 1], 0.0), [[0], [0], [0]]],
                       axis=1).astype(np.float32)
    b = np.concatenate([_rot([0, 0, 1], 0.8), [[1], [2], [3]]],
                       axis=1).astype(np.float32)
    t = jnp.asarray([0.0, 0.5, 1.0])
    out = np.asarray(xform_slerp(jnp.asarray(a), jnp.asarray(b), t))
    np.testing.assert_allclose(out[0], a, atol=1e-5)
    np.testing.assert_allclose(out[2], b, atol=1e-5)
    # halfway: rotation by 0.4 rad, translation midpoint, orthonormal
    np.testing.assert_allclose(out[1][:, :3], _rot([0, 0, 1], 0.4),
                               atol=1e-5)
    np.testing.assert_allclose(out[1][:, 3], [0.5, 1.0, 1.5], atol=1e-5)
    RtR = out[1][:, :3].T @ out[1][:, :3]
    np.testing.assert_allclose(RtR, np.eye(3), atol=1e-5)


@pytest.mark.slow
def test_training_with_rolling_shutter_dataset():
    """xforms_end ≠ xforms must activate the per-ray slerp path and still
    train finitely (the round-1 build silently ignored xforms_end)."""
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    ds = make_orbit_dataset(n_images=4, res=16)
    # end transforms: slightly rotated cameras
    ends = []
    for xf in ds.xforms:
        R = _rot([0, 0, 1], 0.05).astype(np.float32)
        out = xf.copy()
        out[:, :3] = R @ xf[:, :3]
        ends.append(out)
    ds.xforms_end = np.stack(ends)

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=2048, march_steps=1024))
    assert "xforms_end" in tr.data
    loss = tr.train(2)
    assert np.isfinite(loss)


@pytest.mark.slow
def test_render_with_rolling_shutter_blurs():
    """A renderer call with distinct start/end transforms must differ from
    a static render (per-ray interpolation active) and stay finite."""
    import jax
    from ngp_jax.config import load_network_config
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    ds = make_orbit_dataset(n_images=4, res=16)
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=2048, march_steps=256))
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        width=16, height=16, background=(0.2, 0.2, 0.2, 1),
        march_steps=256, chunk=256, linear_out=False))
    import jax.numpy as jnp
    bits = jnp.full_like(tr.grid.bitfield, 255)
    xf0 = ds.xforms[0]
    xf1 = xf0.copy()
    xf1[:, 3] += np.array([0.3, 0.0, 0.0], np.float32)
    img_static = r.render(tr.params, bits, xf0, 16, 16, focal=(20., 20.))
    img_blur = r.render(tr.params, bits, xf0, 16, 16, focal=(20., 20.),
                        camera_matrix_end=xf1,
                        rolling_shutter=(0., 0., 0., 1.))
    assert np.isfinite(img_blur).all()
    assert not np.allclose(img_static, img_blur)


def test_quat_from_mat_all_rotation_classes():
    """Shepperd pivot selection must survive trace ≤ 0 rotations (the
    naive w-only form silently returned identity for a 180° rotation —
    every fox camera render was corrupted)."""
    import jax.numpy as jnp
    from ngp_jax.rays.camera import quat_from_mat, quat_to_mat

    mats = [np.eye(3)]
    for axis in ([0, 0, 1], [0, 1, 0], [1, 0, 0], [1, 1, 1]):
        for ang in (0.3, np.pi / 2, np.pi - 1e-3, np.pi,
                    2.5, -np.pi + 1e-3):
            mats.append(_rot(axis, ang))
    for m in mats:
        q = quat_from_mat(jnp.asarray(m, jnp.float32))
        back = np.asarray(quat_to_mat(np.asarray(q)[None])[0])
        np.testing.assert_allclose(back, m, atol=1e-4)


def test_renderer_rays_match_training_rays():
    """Center-pixel renderer rays must equal the training-path rays for
    the same camera/intrinsics (the eval PSNR is meaningless otherwise)."""
    import jax
    import jax.numpy as jnp
    from ngp_jax.config import load_network_config
    from ngp_jax.rays.camera import pixel_to_ray_train
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    ds = make_orbit_dataset(n_images=2, res=16)
    # make the rotation interesting (orbit cams include trace<0 cases)
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=64, target_batch_size=512, march_steps=64))
    W = H = 8
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        width=W, height=H, chunk=64, march_steps=64))
    key = jax.random.PRNGKey(0)
    for view in range(2):
        xf = jnp.asarray(ds.xforms[view])
        o, d, u, v = r._gen_rays(key, 0, W * H, W, H, 20.0, 20.0, xf, xf,
                                 jnp.asarray([0., 0., 0., 1.]),
                                 jnp.asarray(False), motion=False)
        xy = jnp.stack([u, v], -1)
        n = W * H
        ot, dt_raw = pixel_to_ray_train(
            xy, jnp.broadcast_to(xf, (n, 3, 4)),
            jnp.full((n, 2), 20.0), jnp.full((n, 2), 0.5),
            jnp.full((n, 2), float(W)), jnp.zeros((n, 7)), False)
        dt = dt_raw / jnp.linalg.norm(dt_raw, axis=-1, keepdims=True)
        np.testing.assert_allclose(np.asarray(o), np.asarray(ot), atol=1e-5)
        np.testing.assert_allclose(np.asarray(d), np.asarray(dt), atol=1e-5)
