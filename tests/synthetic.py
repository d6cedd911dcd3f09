"""Shared synthetic NeRF dataset helpers for tests."""
import numpy as np

from ngp_jax.data.nerf_loader import NerfDataset


def make_orbit_dataset(n_images=4, res=32, radius=1.5, images=None,
                       aabb_scale=1, focal=30.0):
    """Cameras on a circle in the z=0.5 plane looking at the center
    (NGP convention: x-right, y-down, z-forward camera axes)."""
    xforms = []
    for i in range(n_images):
        ang = i * 2 * np.pi / n_images
        fwd = np.array([np.cos(ang), np.sin(ang), 0.0])
        eye = np.array([0.5, 0.5, 0.5]) - radius * fwd
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        xf = np.stack([right, -up, fwd, eye], axis=1).astype(np.float32)
        xforms.append(xf)
    if images is None:
        images = np.full((n_images, res, res, 4), 0.5, np.float32)
    return NerfDataset(
        images=images.astype(np.float32),
        xforms=np.stack(xforms), xforms_end=np.stack(xforms),
        focal=np.full((n_images, 2), focal, np.float32),
        principal=np.full((n_images, 2), 0.5, np.float32),
        resolution=np.full((n_images, 2), res, np.int32),
        lens_params=np.zeros((n_images, 4), np.float32),
        lens_is_opencv=False, depth_images=None,
        aabb_scale=aabb_scale, scale=1.0,
        offset=np.zeros(3, np.float32), n_extra_learnable_dims=0,
        sharpness=np.ones(n_images, np.float32), paths=[],
        up=np.array([0.0, 0.0, 1.0], np.float32))
