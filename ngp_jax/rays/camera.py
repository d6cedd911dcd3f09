"""Camera/ray math: pixel→ray mapping, lens distortion, AABB intersection.

Functional equivalents of the reference's device helpers
(ref: common_device.cuh:236-317 pixel_to_ray et al., camera_models.cuh) as
vectorized jnp ops usable inside jit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def iterative_opencv_undistort(u, v, k1, k2, p1, p2, iters: int = 8):
    """Invert the Brown-Conrady distortion by fixed-point iteration
    (ref: iterative_opencv_lens_undistortion, common_device.cuh)."""
    x, y = u, v
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * k2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (u - dx) / radial
        y = (v - dy) / radial
    return x, y


def pixel_to_ray_train(xy, xform, focal, principal, resolution, lens_params,
                       use_opencv, lens_mode: str = None):
    """Training-ray generation (ref: generate_training_samples_nerf,
    src/testbed_nerf.cu:1166-1184 — perspective / OpenCV undistort /
    F-theta fisheye / LatLong equirect).

    xy: (N,2) in [0,1]; xform (N,3,4); focal (N,2); principal (N,2);
    resolution (N,2) float; lens_params (N,≥4).
    Returns (origin (N,3), dir_unnormalized (N,3)).
    """
    if lens_mode is None:
        lens_mode = "opencv" if use_opencv else "perspective"
    if lens_mode == "latlong":
        d = latlong_to_dir(xy)
    elif lens_mode == "ftheta":
        d = f_theta_undistort(xy - principal, lens_params,
                              jnp.asarray([0.0, 0.0, 1.0]))
    else:
        d = jnp.stack([
            (xy[:, 0] - principal[:, 0]) * resolution[:, 0] / focal[:, 0],
            (xy[:, 1] - principal[:, 1]) * resolution[:, 1] / focal[:, 1],
            jnp.ones_like(xy[:, 0]),
        ], axis=-1)
        if lens_mode == "opencv":
            x, y = iterative_opencv_undistort(
                d[:, 0], d[:, 1], lens_params[:, 0], lens_params[:, 1],
                lens_params[:, 2], lens_params[:, 3])
            d = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    origin = xform[:, :, 3]
    world_d = jnp.einsum("nij,nj->ni", xform[:, :, :3], d,
                         precision="highest")
    return origin, world_d


def ray_aabb_intersect(o, d, aabb_min, aabb_max):
    """Slab test; returns (tmin, tmax), empty when tmin > tmax
    (ref: BoundingBox::ray_intersect, bounding_box.cuh)."""
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d >= 0, 1e-12, -1e-12), d)
    t0 = (aabb_min - o) * inv
    t1 = (aabb_max - o) * inv
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return tmin, tmax


def latlong_to_dir(xy):
    """Equirectangular pixel → direction (ref: common_device.cuh:248-258)."""
    theta = (xy[:, 1] - 0.5) * jnp.pi
    phi = (xy[:, 0] - 0.5) * 2.0 * jnp.pi
    ct = jnp.cos(theta)
    return jnp.stack([ct * jnp.sin(phi), jnp.sin(theta), ct * jnp.cos(phi)], -1)


def f_theta_undistort(xy_rel, params, default_dir):
    """F-theta (fisheye polynomial) undistortion
    (ref: f_theta_undistortion, common_device.cuh:236-249).
    params: (...,7) = p0..p4 polynomial + the intrinsics' native (w, h) —
    uv offsets are rescaled into that pixel frame before the polynomial."""
    p = params
    xpix = xy_rel[..., 0] * p[..., 5]
    ypix = xy_rel[..., 1] * p[..., 6]
    r = jnp.sqrt(xpix * xpix + ypix * ypix)
    theta = p[..., 0] + r * (p[..., 1] + r * (p[..., 2] + r * (p[..., 3] + r * p[..., 4])))
    cos_t = jnp.cos(theta)
    sin_r = jnp.sin(theta) / jnp.maximum(r, 1e-9)
    d = jnp.stack([sin_r * xpix, sin_r * ypix, cos_t], axis=-1)
    bad = (cos_t <= 1e-37) | (r == 0.0)
    return jnp.where(bad[..., None], default_dir, d)


# --------------------------------------------------------------------------
# per-ray camera interpolation (rolling shutter / motion blur)
# --------------------------------------------------------------------------

def quat_from_mat(m: jnp.ndarray) -> jnp.ndarray:
    """(3,3) rotation → quaternion (w,x,y,z), robust for ALL rotations.

    Shepperd's method with a branch-free pivot select: the naive
    w-only construction degenerates for trace ≤ 0 (a 180° rotation
    silently became the identity — round-2 bug that corrupted every
    rendered camera with a backwards-facing view)."""
    m00, m11, m22 = m[0, 0], m[1, 1], m[2, 2]
    # 4·{w,x,y,z}² (before normalization)
    s = jnp.stack([1.0 + m00 + m11 + m22,
                   1.0 + m00 - m11 - m22,
                   1.0 - m00 + m11 - m22,
                   1.0 - m00 - m11 + m22])
    pivot = jnp.argmax(s)
    r = jnp.sqrt(jnp.maximum(s[pivot], 1e-12))
    inv = 0.5 / r               # = 1/(2r)
    cands = jnp.stack([
        jnp.stack([0.5 * r, (m[2, 1] - m[1, 2]) * inv,
                   (m[0, 2] - m[2, 0]) * inv, (m[1, 0] - m[0, 1]) * inv]),
        jnp.stack([(m[2, 1] - m[1, 2]) * inv, 0.5 * r,
                   (m[0, 1] + m[1, 0]) * inv, (m[0, 2] + m[2, 0]) * inv]),
        jnp.stack([(m[0, 2] - m[2, 0]) * inv, (m[0, 1] + m[1, 0]) * inv,
                   0.5 * r, (m[1, 2] + m[2, 1]) * inv]),
        jnp.stack([(m[1, 0] - m[0, 1]) * inv, (m[0, 2] + m[2, 0]) * inv,
                   (m[1, 2] + m[2, 1]) * inv, 0.5 * r]),
    ])
    q = cands[pivot]
    return q / jnp.linalg.norm(q)


def quat_slerp(qa, qb, t):
    """Short-path slerp; qa/qb (..., 4), t (N,) → (N, 4)."""
    dot = jnp.sum(qa * qb, axis=-1)
    qb = jnp.where(dot[..., None] < 0, -qb, qb)
    dot = jnp.abs(dot)
    theta = jnp.arccos(jnp.clip(dot, -1.0, 1.0))
    s = jnp.maximum(jnp.sin(theta), 1e-6)
    w1 = jnp.sin((1 - t) * theta) / s
    w2 = jnp.sin(t * theta) / s
    lin = (1 - t)[..., None] * qa + t[..., None] * qb
    sph = w1[..., None] * qa + w2[..., None] * qb
    q = jnp.where((dot > 0.9995)[..., None], lin, sph)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """(N,4) quaternion (w,x,y,z) → (N,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], -1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], -1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   2 * 0 + 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def xform_slerp(xf_a: jnp.ndarray, xf_b: jnp.ndarray, t: jnp.ndarray):
    """Interpolate (3,4) camera matrices: translation lerp + rotation
    slerp (ref: get_xform_given_rolling_shutter,
    common_device.cuh:224-234). Broadcasts (3,4)+(N,) or (N,3,4)+(N,)."""
    if xf_a.ndim == 2:
        pos = xf_a[:, 3][None] + (xf_b[:, 3] - xf_a[:, 3])[None] * t[:, None]
        qa = quat_from_mat(xf_a[:, :3])[None]
        qb = quat_from_mat(xf_b[:, :3])[None]
    else:
        pos = xf_a[:, :, 3] + (xf_b[:, :, 3] - xf_a[:, :, 3]) * t[:, None]
        qa = jax.vmap(quat_from_mat)(xf_a[:, :, :3])
        qb = jax.vmap(quat_from_mat)(xf_b[:, :, :3])
    q = quat_slerp(qa, qb, t)
    R = quat_to_mat(q)
    return jnp.concatenate([R, pos[:, :, None]], axis=-1)


# --------------------------------------------------------------------------
# VR / lenticular-display helpers (ref: common_device.cuh:320-400,541-560)
# --------------------------------------------------------------------------

def apply_quilting(x, y, resolution, parallax_shift, quilting_dims):
    """Map full-frame pixel coords onto a quilt of per-view panels and
    derive each panel's parallax head shift (ref: apply_quilting,
    common_device.cuh:541-560). ``quilting_dims == (2, 1)`` is the VR
    stereo case (parallax_shift.x = IPD); otherwise a HoloPlay-style
    lenticular fan of views (max 17.5° parallax).

    x, y: (N,) pixel coords; parallax_shift: (3,) base shift.
    Returns (x_panel, y_panel, parallax_shift (N, 3)).
    """
    qx, qy = int(quilting_dims[0]), int(quilting_dims[1])
    resx = resolution[0] / qx
    resy = resolution[1] / qy
    panelx = jnp.floor(x / resx)
    panely = jnp.floor(y / resy)
    x = x - panelx * resx
    y = y - panely * resy
    idx = panelx + qx * panely
    ps = jnp.broadcast_to(jnp.asarray(parallax_shift, jnp.float32),
                          x.shape + (3,))
    if (qx, qy) == (2, 1):
        px = jnp.where(idx > 0, -0.5 * ps[..., 0], 0.5 * ps[..., 0])
    else:
        max_parallax_angle = 17.5
        ang = max_parallax_angle * jnp.pi / 180.0 * \
            ((idx + 0.5) * 2.0 / float(qx * qy) - 1.0)
        px = jnp.arctan(ang) / jnp.maximum(ps[..., 2], 1e-9)
    ps = ps.at[..., 0].set(px)
    return x, y, ps


def pos_to_pixel(pos, resolution, focal, xform, screen_center,
                 parallax_shift=(0.0, 0.0, 0.0), lens_params=None,
                 lens_is_opencv=False):
    """Project world positions back to pixel coordinates — the inverse of
    pixel_to_ray (ref: pos_to_pixel, common_device.cuh:320-355).

    pos: (N, 3); xform: (3, 4) camera→world. Returns (N, 2) pixels.
    """
    ps = jnp.asarray(parallax_shift, jnp.float32)
    head = jnp.array([ps[0], ps[1], 0.0])
    R = xform[:, :3]
    origin = jnp.matmul(R, head, precision="highest") + xform[:, 3]
    d = pos - origin[None]
    # R^-1 = R^T applied row-wise: d·R == R^T·d
    d = jnp.matmul(d, R, precision="highest")
    d = d / d[:, 2:3]
    d = d + head[None] * ps[2]
    u, v = d[:, 0], d[:, 1]
    if lens_is_opencv and lens_params is not None:
        k1, k2, p1, p2 = (float(lens_params[i]) for i in range(4))
        r2 = u * u + v * v
        rad = k1 * r2 + k2 * r2 * r2
        du = u * rad + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
        dv = v * rad + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
        u, v = u + du, v + dv
    return jnp.stack([
        u * focal[0] + screen_center[0] * resolution[0],
        v * focal[1] + screen_center[1] * resolution[1]], -1)


def motion_vector_3d(pixel_xy, resolution, focal, xform, prev_xform,
                     screen_center, depth, parallax_shift=(0.0, 0.0, 0.0),
                     lens_params=None, lens_is_opencv=False):
    """Screen-space 3D motion vectors: reproject each pixel's hit point
    (at ``depth`` along its ray) through the PREVIOUS camera and return
    prev_pixel - pixel (ref: motion_vector_3d, common_device.cuh:356-400;
    consumed by TAA/DLSS in the GUI build — headless parity surface).

    pixel_xy: (N, 2) sub-pixel coords; depth: (N,).
    """
    ps = jnp.asarray(parallax_shift, jnp.float32)
    u = (pixel_xy[:, 0] / resolution[0] - screen_center[0]) * \
        resolution[0] / focal[0]
    v = (pixel_xy[:, 1] / resolution[1] - screen_center[1]) * \
        resolution[1] / focal[1]
    d_cam = jnp.stack([u, v, jnp.ones_like(u)], -1)
    head = jnp.array([ps[0], ps[1], 0.0])
    d_cam = d_cam - head[None] * ps[2]
    R = xform[:, :3]
    d_world = jnp.matmul(d_cam, R.T, precision="highest")
    origin = jnp.matmul(R, head, precision="highest") + xform[:, 3]
    pos = origin[None] + d_world * depth[:, None]
    prev = pos_to_pixel(pos, resolution, focal, prev_xform, screen_center,
                        parallax_shift, lens_params, lens_is_opencv)
    return prev - pixel_xy
