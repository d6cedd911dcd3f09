#!/usr/bin/env python3
"""Generate a self-contained synthetic NeRF scene with ANALYTIC ground
truth — a second holdout-protocol scene for environments without the
nerf-synthetic dataset (protocol: the reference's scripts/run.py:216-303).

The scene is a handful of constant-density colored spheres in the unit
cube. Ground-truth images are volume-rendered analytically along the
EXACT rays the loader/renderer produce for the written transforms (the
transforms round-trip through ngp_matrix_to_nerf, so the dataset
exercises the same loader path real captures do).

    python scripts/make_synth_scene.py --out /tmp/synth_scene \
        [--views 20] [--test_views 4] [--res 128]

Then the reference eval protocol runs unchanged:

    python scripts/run.py --scene /tmp/synth_scene --n_steps 2000 \
        --test_transforms /tmp/synth_scene/transforms_test.json
"""
import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# spheres: (center, radius, rgb linear, sigma)
SPHERES = [
    ((0.50, 0.50, 0.45), 0.16, (0.9, 0.25, 0.2), 60.0),
    ((0.34, 0.62, 0.58), 0.10, (0.2, 0.8, 0.3), 60.0),
    ((0.66, 0.38, 0.60), 0.09, (0.25, 0.35, 0.9), 60.0),
    ((0.50, 0.50, 0.22), 0.07, (0.9, 0.85, 0.3), 80.0),
]


def field(pos, xp=np):
    """Analytic (rgb, sigma) at positions (N, 3) in ngp world space.
    ``xp`` is the array module: numpy here, jax.numpy on the device."""
    sigma = xp.zeros(pos.shape[0], xp.float32)
    rgb = xp.zeros((pos.shape[0], 3), xp.float32)
    for (c, r, col, s) in SPHERES:
        d = xp.linalg.norm(pos - xp.asarray(c, xp.float32), axis=-1)
        # smooth shell so the surface is learnable, constant core
        m = xp.clip((r - d) / (0.15 * r), 0.0, 1.0)
        add = s * m
        w = add / xp.maximum(sigma + add, 1e-9)
        rgb = rgb * (1 - w[:, None]) + xp.asarray(col, xp.float32) * w[:, None]
        sigma = sigma + add
    return rgb, sigma


def render_gt(o, d, n_steps=384, t0=0.05, t1=2.5):
    """Brute-force volume render along rays o + t d (linear rgb, alpha)."""
    ts = np.linspace(t0, t1, n_steps, dtype=np.float32)
    dt = ts[1] - ts[0]
    rgb_acc = np.zeros((o.shape[0], 3), np.float32)
    T = np.ones(o.shape[0], np.float32)
    for t in ts:
        pos = o + t * d
        rgb, sigma = field(pos)
        alpha = 1.0 - np.exp(-sigma * dt)
        rgb_acc += (T * alpha)[:, None] * rgb
        T *= 1.0 - alpha
    return rgb_acc, 1.0 - T


def orbit_ngp_xforms(n, radius=1.05, center=(0.5, 0.5, 0.5), seed=0):
    """Cameras on a jittered orbit looking at the scene center, in NGP
    convention (x-right, y-down, z-forward columns)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ang = i * 2 * math.pi / n
        elev = 0.25 + 0.4 * rng.rand()
        fwd = -np.array([math.cos(ang) * math.cos(elev),
                         math.sin(ang) * math.cos(elev),
                         math.sin(elev)], np.float32)
        eye = np.asarray(center, np.float32) - radius * fwd
        up = np.array([0, 0, 1], np.float32)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        out.append(np.stack([right, down, fwd, eye], 1).astype(np.float32))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--views", type=int, default=20)
    p.add_argument("--test_views", type=int, default=4)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--focal_mult", type=float, default=1.1)
    args = p.parse_args()

    from ngp_jax.data.image_io import save_stbi
    from ngp_jax.data.nerf_loader import ngp_matrix_to_nerf

    W = H = args.res
    fl = args.focal_mult * W
    os.makedirs(os.path.join(args.out, "images"), exist_ok=True)
    xfs = orbit_ngp_xforms(args.views + args.test_views)

    def frames(idx):
        out = []
        for i in idx:
            m = ngp_matrix_to_nerf(xfs[i], 1.0, np.zeros(3, np.float32))
            m4 = np.concatenate([m, [[0, 0, 0, 1]]], 0)
            out.append({"file_path": f"images/{i:04d}.png",
                        "transform_matrix": m4.tolist()})
        return out

    meta = {
        "camera_angle_x": 2 * math.atan(W / (2 * fl)),
        "fl_x": fl, "fl_y": fl, "cx": W / 2, "cy": H / 2,
        # aabb_scale 2 turns cone stepping on (cone_angle_for) so a
        # CPU-scale march_steps still covers the whole camera-to-scene
        # range — at aabb_scale 1 the lattice is uniform dt=sqrt(3)/1024
        # and 192 steps span only 0.32 world units
        "w": W, "h": H, "aabb_scale": 2,
    }
    train_idx = list(range(args.views))
    test_idx = list(range(args.views, args.views + args.test_views))
    with open(os.path.join(args.out, "transforms.json"), "w") as f:
        json.dump({**meta, "frames": frames(train_idx)}, f, indent=1)
    with open(os.path.join(args.out, "transforms_test.json"), "w") as f:
        json.dump({**meta, "frames": frames(test_idx)}, f, indent=1)

    # ground truth along the loader's own rays: pixel (k+0.5)/res through
    # the ngp camera (centered principal, no distortion)
    px = (np.arange(W, dtype=np.float32) + 0.5) / W
    py = (np.arange(H, dtype=np.float32) + 0.5) / H
    u, v = np.meshgrid(px, py)
    d_cam = np.stack([(u - 0.5) * W / fl, (v - 0.5) * H / fl,
                      np.ones_like(u)], -1).reshape(-1, 3)
    for i, xf in enumerate(xfs):
        d = d_cam @ xf[:, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(xf[:, 3], d.shape)
        rgb, alpha = render_gt(o, d)
        img = np.concatenate([rgb, alpha[:, None]], -1).reshape(H, W, 4)
        save_stbi(os.path.join(args.out, f"images/{i:04d}.png"), img,
                  from_linear=True)
    print(f"wrote {args.views} train + {args.test_views} test views at "
          f"{W}x{H} -> {args.out}")


if __name__ == "__main__":
    main()
