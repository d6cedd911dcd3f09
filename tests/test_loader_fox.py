"""Loader behavior on the real fox dataset (conventions, downscale,
world-mapping overrides) — the bugs these lock down cost hours."""
import numpy as np
import pytest

pytestmark = pytest.mark.smoke


@pytest.fixture(scope="module")
def fox():
    from ngp_jax.data.nerf_loader import load_nerf
    return load_nerf("/root/reference/data/nerf/fox", max_images=4,
                     downscale=8)


def test_intrinsics_downscaled(fox):
    # fl_x 1375.52 / 8
    np.testing.assert_allclose(fox.focal[0][0], 1375.52 / 8, rtol=1e-5)
    assert (fox.resolution[0] == [135, 240]).all()
    # principal point stays normalized
    np.testing.assert_allclose(fox.principal[0], [0.51347965, 0.5027437],
                               rtol=1e-3)
    assert fox.lens_is_opencv
    assert fox.aabb_scale == 4


def test_world_scale_override():
    from ngp_jax.data.nerf_loader import load_nerf
    a = load_nerf("/root/reference/data/nerf/fox", max_images=2, downscale=8)
    b = load_nerf("/root/reference/data/nerf/fox", max_images=2, downscale=8,
                  scale=0.33, offset=[0.5, 0.5, 0.5])
    # camera positions transform affinely: b = a*0.33 + 0.5
    np.testing.assert_allclose(b.xforms[0][:, 3],
                               a.xforms[0][:, 3] * 0.33 + 0.5, atol=1e-5)
    # rotations unchanged
    np.testing.assert_allclose(b.xforms[0][:, :3], a.xforms[0][:, :3],
                               atol=1e-6)


def test_cameras_converge_near_content(fox):
    """With the fork mapping, fox content sits near the NGP origin —
    optical axes should pass within ~1 unit of it (convention lock)."""
    dists = []
    for i in range(fox.n_images):
        o = fox.xforms[i][:, 3]
        f = fox.xforms[i][:, 2]
        f = f / np.linalg.norm(f)
        t = np.dot(-o, f)
        assert t > 0  # looking TOWARD the content
        dists.append(np.linalg.norm(o + t * f))
    assert np.mean(dists) < 1.0, dists


def test_lazy_images_match_eager_conversion(fox):
    """LDR captures defer the float conversion (fox on a 1-core host:
    234 s eager → ~6 s); the lazy view must reproduce load_stbi bit for
    bit, and editing an image (pyngp set_image) must still work."""
    from ngp_jax.data.image_io import load_stbi
    from ngp_jax.data.nerf_loader import LazyImageArray
    assert isinstance(fox.images, LazyImageArray)
    assert fox.images.shape == fox.images_u8.shape
    eager = load_stbi(fox.paths[1])[::8, ::8]   # fixture downscale=8
    h, w = eager.shape[:2]
    lazy = fox.images[1]
    assert np.array_equal(eager, lazy[:h, :w])
    # whole-array access (np.asarray) materializes
    dense = np.asarray(fox.images)
    assert dense.dtype == np.float32
    assert np.array_equal(dense[1], lazy)
