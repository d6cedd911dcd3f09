"""Image I/O codecs and camera math."""
import numpy as np
import pytest


def test_exr_roundtrip_float_and_half(tmp_path):
    from ngp_jax.data.image_io import load_exr, save_exr
    img = np.random.default_rng(0).random((37, 53, 4)).astype(np.float32)
    p32 = tmp_path / "f32.exr"
    save_exr(p32, img, dtype=np.float32)
    np.testing.assert_array_equal(load_exr(p32), img)
    p16 = tmp_path / "f16.exr"
    save_exr(p16, img, dtype=np.float16)
    np.testing.assert_allclose(load_exr(p16), img, atol=1e-3)


def test_exr_reads_reference_albert():
    from ngp_jax.data.image_io import load_exr
    img = load_exr("/root/reference/data/image/albert.exr")
    assert img.shape == (1024, 1024, 4)
    assert 0.0 <= img.min() and img.max() <= 1.0 + 1e-5


def test_bin_roundtrip(tmp_path):
    from ngp_jax.data.image_io import load_binary_image, save_binary_image
    img = np.random.default_rng(1).random((9, 7, 4)).astype(np.float32)
    p = tmp_path / "img.bin"
    save_binary_image(p, img)
    np.testing.assert_allclose(load_binary_image(p), img, atol=1e-3)


def test_ldr_srgb_premultiply(tmp_path):
    from ngp_jax.data.image_io import load_stbi, save_stbi
    img = np.zeros((8, 8, 4), np.float32)
    img[..., 0] = 0.5  # linear red
    img[..., 3] = 1.0
    p = tmp_path / "t.png"
    save_stbi(p, img, from_linear=True)
    back = load_stbi(p)
    np.testing.assert_allclose(back[..., 0], 0.5, atol=2e-2)
    np.testing.assert_allclose(back[..., 3], 1.0)


def test_opencv_undistort_inverts_distortion():
    import jax.numpy as jnp
    from ngp_jax.rays.camera import iterative_opencv_undistort
    k1, k2, p1, p2 = 0.06, -0.08, -0.001, 0.0002  # fox-like params
    rng = np.random.default_rng(2)
    x = (rng.random(100) - 0.5) * 0.8
    y = (rng.random(100) - 0.5) * 0.8
    # forward distortion (Brown-Conrady)
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    xu, yu = iterative_opencv_undistort(jnp.asarray(xd), jnp.asarray(yd),
                                        k1, k2, p1, p2)
    np.testing.assert_allclose(np.asarray(xu), x, atol=1e-4)
    np.testing.assert_allclose(np.asarray(yu), y, atol=1e-4)


def test_ray_aabb():
    import jax.numpy as jnp
    from ngp_jax.rays.camera import ray_aabb_intersect
    o = jnp.asarray([[0.5, 0.5, -1.0], [2.0, 2.0, 2.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    tmin, tmax = ray_aabb_intersect(o, d, 0.0, 1.0)
    np.testing.assert_allclose(np.asarray(tmin)[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(tmax)[0], 2.0, atol=1e-6)
    assert float(tmin[1]) > float(tmax[1])  # miss


def test_nerf_matrix_roundtrip():
    from ngp_jax.data.nerf_loader import nerf_matrix_to_ngp, ngp_matrix_to_nerf
    rng = np.random.default_rng(3)
    m = rng.random((3, 4)).astype(np.float32)
    scale, offset = 0.33, np.asarray([0.5, 0.5, 0.5], np.float32)
    ngp = nerf_matrix_to_ngp(m, scale, offset)
    back = ngp_matrix_to_nerf(ngp, scale, offset)
    np.testing.assert_allclose(back, m, atol=1e-5)


def test_pos_to_pixel_inverts_ray_gen():
    """pos_to_pixel must invert the perspective ray model, including the
    parallax head shift (ref: pos_to_pixel, common_device.cuh:320-355)."""
    import jax.numpy as jnp
    from ngp_jax.rays.camera import pos_to_pixel

    W, H, fx, fy = 64, 48, 70.0, 70.0
    xf = jnp.asarray([[1.0, 0, 0, 0.2], [0, 0.0, -1, 0.1],
                      [0, 1.0, 0, -0.3]], jnp.float32)
    ps = (0.03, -0.02, 0.5)
    pix = jnp.asarray([[10.5, 20.5], [33.5, 7.5], [50.5, 40.5]])
    # forward model (mirrors NerfRenderer._gen_rays perspective branch)
    u = pix[:, 0] / W
    v = pix[:, 1] / H
    d_cam = jnp.stack([(u - 0.5) * W / fx, (v - 0.5) * H / fy,
                       jnp.ones_like(u)], -1)
    head = jnp.asarray([ps[0], ps[1], 0.0])
    d_cam = d_cam - head[None] * ps[2]
    o = xf[:, :3] @ head + xf[:, 3]
    d_world = d_cam @ xf[:, :3].T
    pos = o[None] + d_world * jnp.asarray([[1.7], [2.2], [0.9]])

    back = pos_to_pixel(pos, (W, H), (fx, fy), xf, (0.5, 0.5), ps)
    np.testing.assert_allclose(np.asarray(back), np.asarray(pix),
                               atol=1e-3)


def test_motion_vector_3d_static_camera_is_zero():
    import jax.numpy as jnp
    from ngp_jax.rays.camera import motion_vector_3d

    xf = jnp.asarray([[1.0, 0, 0, 0.0], [0, 1.0, 0, 0.0],
                      [0, 0, 1.0, 0.0]], jnp.float32)
    pix = jnp.asarray([[8.5, 9.5], [30.5, 20.5]])
    mv = motion_vector_3d(pix, (64, 48), (70.0, 70.0), xf, xf,
                          (0.5, 0.5), jnp.asarray([1.0, 2.0]))
    np.testing.assert_allclose(np.asarray(mv), 0.0, atol=1e-4)


def test_apply_quilting_stereo_panels():
    """(2,1) stereo: left panel gets +IPD/2, right -IPD/2 (ref:
    apply_quilting, common_device.cuh:550-553)."""
    import jax.numpy as jnp
    from ngp_jax.rays.camera import apply_quilting

    x = jnp.asarray([10.0, 74.0])     # panels 0 and 1 for W=128, qx=2
    y = jnp.asarray([5.0, 5.0])
    xq, yq, ps = apply_quilting(x, y, (128, 64), (0.064, 0.0, 1.0), (2, 1))
    np.testing.assert_allclose(np.asarray(xq), [10.0, 10.0])
    np.testing.assert_allclose(np.asarray(ps[:, 0]), [0.032, -0.032])


def test_save_obj_unwrapped(tmp_path):
    from ngp_jax.render.mesh_export import save_obj_unwrapped

    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                       np.float32)
    faces = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    p = tmp_path / "m.obj"
    save_obj_unwrapped(p, verts, faces,
                       colors=np.full((4, 3), 0.5, np.float32))
    text = p.read_text()
    assert text.count("vt ") == 6          # one vt per index
    assert "usemtl nerf" in text
    assert text.count("\nf ") == 2
    assert (tmp_path / "m.obj.tga").exists()
