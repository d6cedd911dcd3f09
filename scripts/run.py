#!/usr/bin/env python3
"""Train/evaluate/render driver — CLI-compatible re-implementation of the
reference's scripts/run.py workflow on this framework:

  python scripts/run.py --scene data/nerf/fox --n_steps 2000 \
      --save_snapshot out.msgpack --test_transforms transforms_test.json \
      --screenshot_transforms ... --video_camera_path path.json

Covers: mode inference, config resolution, training with loss prints,
snapshot save/load, held-out PSNR/SSIM eval (black background, spp 8,
snap-to-centers protocol, ref: run.py:216-303), screenshots, marching-cubes
mesh export, and camera-path video rendering (ffmpeg if available).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


import common  # noqa: F401  (sets sys.path)
from common import mse2psnr, ssim, write_image

from ngp_jax.api.testbed import Testbed, mode_from_scene
from ngp_jax.common import TestbedMode


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", "--training_data", default="",
                   help="scene dir / transforms.json / mesh / image / volume")
    p.add_argument("--mode", default="",
                   help="nerf|sdf|image|volume (inferred from scene if empty)")
    p.add_argument("--network", default="", help="network config json")
    p.add_argument("--load_snapshot", default="")
    p.add_argument("--save_snapshot", default="")
    p.add_argument("--n_steps", type=int, default=-1)
    p.add_argument("--test_transforms", default="",
                   help="transforms.json with held-out views for PSNR/SSIM")
    p.add_argument("--screenshot_transforms", default="")
    p.add_argument("--screenshot_frames", nargs="*")
    p.add_argument("--screenshot_dir", default="")
    p.add_argument("--screenshot_spp", type=int, default=16)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--save_mesh", default="")
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--video_camera_path", default="")
    p.add_argument("--video_fps", type=int, default=30)
    p.add_argument("--video_n_seconds", type=int, default=1)
    p.add_argument("--video_spp", type=int, default=8)
    p.add_argument("--video_output", default="video.mp4")
    p.add_argument("--video_playback", action="store_true",
                   help="render the camera path from the baked playback "
                        "cache (frozen-model fast path) instead of the "
                        "live network")
    p.add_argument("--nerf_compatibility", action="store_true",
                   help="upstream instant-ngp semantics: sRGB colors, cone "
                        "angle 0, world scale 0.33/offset .5 (ref: "
                        "run.py:155-176 + upstream loader defaults)")
    p.add_argument("--world_scale", type=float, default=None)
    p.add_argument("--world_offset", type=float, nargs=3, default=None)
    p.add_argument("--train", action="store_true")
    return p.parse_args()


def main():
    args = parse_args()
    mode = TestbedMode(args.mode) if args.mode else \
        (mode_from_scene(args.scene) or TestbedMode.NERF)
    testbed = Testbed(mode)
    if os.environ.get("NGP_TESTBED_BATCH"):
        testbed.training_batch_size = int(os.environ["NGP_TESTBED_BATCH"])

    if args.network:
        testbed.reload_network_from_file(args.network)
    if args.world_scale is not None or args.nerf_compatibility:
        testbed.nerf.training.world_scale = (
            args.world_scale if args.world_scale is not None else 0.33)
        testbed.nerf.training.world_offset = (
            args.world_offset if args.world_offset is not None
            else [0.5, 0.5, 0.5])
    if args.scene:
        testbed.load_training_data(args.scene)
    if args.load_snapshot:
        testbed.load_snapshot(args.load_snapshot)

    if args.nerf_compatibility:
        # ref: run.py:155-176 — sRGB color space + cone angle 0
        from ngp_jax.common import ColorSpace
        testbed.color_space = ColorSpace.SRGB
        testbed.nerf.cone_angle_constant = 0.0
        if testbed.trainer is not None:
            testbed.trainer.cone_angle = 0.0

    n_steps = args.n_steps
    if n_steps < 0 and (not args.load_snapshot or args.train):
        n_steps = 35000  # ref default

    if n_steps > 0 and testbed.trainer is not None:
        print(f"Training for {n_steps} steps")
        t0 = time.time()
        # report on grid-update boundaries: off-cadence chunk lengths
        # each compile a fresh scan
        report = max(((n_steps // 20 + 15) // 16) * 16, 16)
        while testbed.training_step < n_steps:
            k = min(report, n_steps - testbed.training_step)
            loss = testbed.train(k)
            print(f"iteration={testbed.training_step} loss={loss:.6f} "
                  f"({testbed.training_step / (time.time() - t0):.1f} steps/s)")

    if args.save_snapshot:
        testbed.save_snapshot(args.save_snapshot)
        print("saved snapshot to", args.save_snapshot)

    if args.save_mesh and mode in (TestbedMode.NERF, TestbedMode.SDF):
        from ngp_jax.render.mesh_export import (extract_mesh_from_density,
                                                marching_tetrahedra, save_obj,
                                                save_ply, vertex_normals)
        if mode == TestbedMode.NERF:
            tr = testbed.trainer
            v, f = extract_mesh_from_density(
                tr.density_at, res=args.marching_cubes_res,
                aabb_min=float(tr.aabb_min), aabb_size=float(tr.aabb_size))
        else:
            from ngp_jax.render.mesh_export import density_field_on_grid
            field = common.np.reshape(
                testbed.trainer.distance_at(_grid_points(args.marching_cubes_res)),
                (args.marching_cubes_res,) * 3)
            v, f = marching_tetrahedra(field, 0.0)
        n = vertex_normals(v, f)
        if args.save_mesh.endswith(".ply"):
            save_ply(args.save_mesh, v, f)
        else:
            save_obj(args.save_mesh, v, f, n)
        print(f"saved mesh ({len(v)} verts, {len(f)} faces) to", args.save_mesh)

    if args.test_transforms:
        evaluate_test_transforms(testbed, args)

    if args.screenshot_transforms:
        render_screenshots(testbed, args)

    if args.video_camera_path:
        render_video(testbed, args)


def _grid_points(res):
    lin = (np.arange(res, dtype=np.float32) + 0.5) / res
    return np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)


def evaluate_test_transforms(testbed, args):
    """Held-out PSNR/SSIM (protocol of ref run.py:216-303: black background,
    spp 8, snap to pixel centers, linear render → sRGB blend vs target)."""
    from ngp_jax.common import linear_to_srgb_np
    from ngp_jax.data.image_io import load_stbi

    with open(args.test_transforms) as f:
        test = json.load(f)
    base = Path(args.test_transforms).parent
    testbed.background_color = np.array([0, 0, 0, 1], np.float32)
    testbed.snap_to_pixel_centers = True
    # render with the dataset's lens + principal like training rays
    # (ref: render_with_lens_distortion on for dataset views,
    # src/testbed.cu:278; fox: off-center cx + k1/k2 — rendering with a
    # centered undistorted camera warps the frame several dB)
    testbed.nerf.render_with_lens_distortion = True
    # the ref protocol is spp 8 WITH snap-to-pixel-centers — under snap
    # every sample traces the identical deterministic center ray (no
    # jitter, no DoF), so spp 1 computes the same image 8× cheaper
    spp = 1
    psnrs, ssims = [], []
    frames = test.get("frames", [])
    for i, frame in enumerate(frames):
        ip = base / frame["file_path"]
        if not ip.exists():
            for ext in (".png", ".jpg", ".jpeg"):
                if ip.with_suffix(ext).exists():
                    ip = ip.with_suffix(ext)
                    break
        if not ip.exists():
            continue
        ref = load_stbi(ip)                                   # linear premult
        H, W = ref.shape[:2]
        # focal for this eval view (fl_x or camera_angle_x; per-frame
        # overrides win, like the loader)
        src = {**test, **frame}
        if "fl_x" in src:
            fx = float(src["fl_x"])
            fy = float(src.get("fl_y", fx))
        elif "camera_angle_x" in src:
            fx = fy = 0.5 * W / np.tan(0.5 * float(src["camera_angle_x"]))
        else:
            fx = fy = float(H)
        testbed._view_focal = np.array([fx, fy], np.float32)
        testbed.set_nerf_camera_matrix(
            np.asarray(frame["transform_matrix"], np.float32)[:3])
        img = testbed.render(W, H, spp=spp, linear=True)
        # sRGB-blend compat: A-over-black in linear, compare in sRGB
        pred = linear_to_srgb_np(np.clip(img[..., :3], 0, 1))
        gt = linear_to_srgb_np(np.clip(ref[..., :3], 0, 1))
        mse = float(np.mean((pred - gt) ** 2))
        psnrs.append(mse2psnr(mse))
        ssims.append(ssim(pred, gt))
        print(f"frame {i}: psnr={psnrs[-1]:.2f} ssim={ssims[-1]:.3f}")
    if psnrs:
        print(f"PSNR={np.mean(psnrs):.3f} (min={np.min(psnrs):.2f} "
              f"max={np.max(psnrs):.2f}) SSIM={np.mean(ssims):.4f}")


def render_screenshots(testbed, args):
    with open(args.screenshot_transforms) as f:
        ref = json.load(f)
    outdir = Path(args.screenshot_dir or "screenshots")
    outdir.mkdir(parents=True, exist_ok=True)
    frames = ref.get("frames", [])
    if args.screenshot_frames:
        frames = [frames[int(i)] for i in args.screenshot_frames]
    W = args.width or int(ref.get("w", 1920))
    H = args.height or int(ref.get("h", 1080))
    for frame in frames:
        testbed.set_nerf_camera_matrix(
            np.asarray(frame["transform_matrix"], np.float32)[:3])
        img = testbed.render(W, H, spp=args.screenshot_spp, linear=True)
        name = Path(frame.get("file_path", "frame")).stem + ".png"
        write_image(outdir / name, img)
        print("wrote", outdir / name)


def render_video(testbed, args):
    testbed.load_camera_path(args.video_camera_path)
    n_frames = args.video_n_seconds * args.video_fps
    W = args.width or 1920
    H = args.height or 1080
    tmp = Path("tmp_video_frames")
    tmp.mkdir(exist_ok=True)
    if args.video_playback:
        testbed.bake_playback()
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        if args.video_playback:
            img = testbed.render_playback(W, H, start_time=t)
        else:
            img = testbed.render(W, H, spp=args.video_spp, linear=True,
                                 start_time=t, end_time=t,
                                 fps=args.video_fps, shutter_fraction=0.5)
        write_image(tmp / f"{i:04d}.jpg", img)
        print(f"video frame {i + 1}/{n_frames}")
    if shutil.which("ffmpeg"):
        subprocess.run(["ffmpeg", "-y", "-framerate", str(args.video_fps),
                        "-i", str(tmp / "%04d.jpg"), "-c:v", "libx264",
                        "-pix_fmt", "yuv420p", args.video_output], check=False)
        print("wrote", args.video_output)
    else:
        print("ffmpeg not found; frames left in", tmp)


if __name__ == "__main__":
    sys.exit(main())
