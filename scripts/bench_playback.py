#!/usr/bin/env python3
"""Frozen-model playback benchmark: bake a trained fox snapshot into the
voxel cache, then measure camera-path playback fps at 1080p and the
PSNR cost vs the live renderer (BASELINE render row: the reference
plays trained scenes at "tens of ms" per 1080p frame on a 3090,
docs/index.html:317).

    python scripts/bench_playback.py --load_snapshot /tmp/fox.msgpack
        [--width 1920 --height 1080] [--frames 8] [--d 256 --d_inner 512]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return -10 * np.log10(max(mse, 1e-10))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="/root/reference/data/nerf/fox")
    p.add_argument("--load_snapshot", required=True)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--d", type=int, default=256)
    p.add_argument("--d_list", type=int, nargs="*", default=None,
                   help="per-cascade bake resolutions, e.g. 512 512 256")
    p.add_argument("--d_inner", type=int, default=512)
    p.add_argument("--int_scale", type=float, default=1.0)
    p.add_argument("--outer_int_scale", type=float, default=0.5)
    p.add_argument("--eval_view", type=int, default=0)
    p.add_argument("--eval_scale", type=int, default=4,
                   help="live-render A/B view at 1/k res (live 1080p "
                        "takes minutes; the A/B only needs equal frames)")
    p.add_argument("--skip_live", action="store_true")
    p.add_argument("--skip_path", action="store_true")
    p.add_argument("--save_cache", default="")
    p.add_argument("--load_cache", default="")
    p.add_argument("--sh", type=int, default=0,
                   help="spherical-harmonic degree for the view-"
                        "dependence bake (0 = diffuse)")
    p.add_argument("--ref_view", type=int, default=-1,
                   help="bake rgb toward this training view's camera "
                        "instead of the mean camera (view-dependence "
                        "ablation); -2 = nearest camera per voxel")
    p.add_argument("--dump", default="",
                   help="prefix: write <p>_pb.png/<p>_live.png/<p>_gt.png")
    args = p.parse_args()

    import jax
    from ngp_jax.common import linear_to_srgb_np
    from ngp_jax.config import load_network_config
    from ngp_jax.data.nerf_loader import load_nerf
    from ngp_jax.opt.optimizers import inference_params
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
    from ngp_jax.render.playback import (PlaybackOptions, PlaybackRenderer,
                                         bake_playback_cache)
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    print("platform:", jax.devices()[0].platform, flush=True)
    ds = load_nerf(args.scene, scale=0.33, offset=[0.5, 0.5, 0.5])
    cfg = load_network_config("configs/nerf/base.json")
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=1024, adapt_rays=False))
    tr.load_snapshot_state(args.load_snapshot)
    print("snapshot step", tr.training_step, flush=True)

    from ngp_jax.render.playback import (load_playback_cache,
                                         save_playback_cache)
    t0 = time.time()
    if args.load_cache and os.path.exists(args.load_cache):
        cache = load_playback_cache(args.load_cache)
        print("cache loaded: %.1fs" % (time.time() - t0), flush=True)
    else:
        if args.ref_view == -2:
            ref_eye = "nearest"
        else:
            ref_eye = None if args.ref_view < 0 else \
                np.asarray(ds.xforms[args.ref_view][:, 3])
        cache = bake_playback_cache(
            tr, D=args.d_list if args.d_list else args.d,
            D_inner=args.d_inner, ref_eye=ref_eye, sh_degree=args.sh)
        occ_frac = [float((np.asarray(v[..., -1], np.float32) > 0).mean())
                    for v in cache.vols]
        print("bake: %.1fs  (D=%d inner=%d, occ %s)" % (
            time.time() - t0, args.d, args.d_inner,
            ", ".join("%.3f" % f for f in occ_frac)), flush=True)
        if args.save_cache:
            save_playback_cache(args.save_cache, cache)

    view = args.eval_view
    k = args.eval_scale
    W = int(ds.resolution[view][0]) // k
    H = int(ds.resolution[view][1]) // k
    focal = (float(ds.focal[view][0]) / k, float(ds.focal[view][1]) / k)
    gt = ds.images[view].astype(np.float32)
    yi = np.minimum(np.arange(H) * gt.shape[0] // H + gt.shape[0] // (2 * H),
                    gt.shape[0] - 1)
    xi = np.minimum(np.arange(W) * gt.shape[1] // W + gt.shape[1] // (2 * W),
                    gt.shape[1] - 1)
    gt_srgb = linear_to_srgb_np(np.clip(gt[yi][:, xi][..., :3], 0, 1))

    lens = dict(principal=tuple(float(x) for x in ds.principal[view]),
                lens_params=tuple(float(x) for x in ds.lens_params[view][:4]),
                lens_mode="opencv" if ds.lens_is_opencv else "auto")
    params = inference_params(tr.params, tr.opt_state, tr.opt_cfg)

    pr = PlaybackRenderer(cache, PlaybackOptions(
        width=W, height=H, background=(0, 0, 0, 0), linear_out=True,
        int_scale=args.int_scale, outer_int_scale=args.outer_int_scale,
        **lens))
    t0 = time.time()
    img_p = pr.render(ds.xforms[view], W, H, focal=focal)
    print("playback eval frame (compile): %.1fs" % (time.time() - t0),
          flush=True)
    pb_srgb = linear_to_srgb_np(np.clip(img_p[..., :3], 0, 1))
    print("playback vs GT: %.2f dB" % psnr(pb_srgb, gt_srgb), flush=True)
    if args.dump:
        from ngp_jax.data.image_io import save_stbi
        save_stbi(args.dump + "_pb.png", img_p, from_linear=True)
        save_stbi(args.dump + "_gt.png",
                  np.concatenate([gt[yi][:, xi][..., :3],
                                  np.ones((H, W, 1), np.float32)], -1),
                  from_linear=True)

    if not args.skip_live:
        r_live = NerfRenderer.for_trainer(tr, RenderOptions(
            width=W, height=H, background=(0, 0, 0, 0), linear_out=True,
            chunk=1 << 15, **lens))
        t0 = time.time()
        img_l = r_live.render(params, tr.grid.bitfield, ds.xforms[view],
                              W, H, focal=focal)
        print("live eval frame: %.1fs" % (time.time() - t0), flush=True)
        lv_srgb = linear_to_srgb_np(np.clip(
            np.asarray(img_l)[..., :3], 0, 1))
        print("live vs GT: %.2f dB   playback vs live: %.2f dB" % (
            psnr(lv_srgb, gt_srgb), psnr(pb_srgb, lv_srgb)), flush=True)
        if args.dump:
            from ngp_jax.data.image_io import save_stbi
            save_stbi(args.dump + "_live.png", np.asarray(img_l),
                      from_linear=True)

    if args.skip_path:
        return

    # camera-path playback at full target resolution
    Wt, Ht = args.width, args.height
    ft = (float(ds.focal[view][0]) * Wt / float(ds.resolution[view][0]),
          float(ds.focal[view][1]) * Ht / float(ds.resolution[view][1]))
    prt = PlaybackRenderer(cache, PlaybackOptions(
        width=Wt, height=Ht, background=(0, 0, 0, 0), linear_out=True,
        int_scale=args.int_scale, outer_int_scale=args.outer_int_scale,
        **lens))
    xfs = [np.asarray(ds.xforms[i % len(ds.xforms)])
           for i in range(args.frames)]
    t0 = time.time()
    img = prt.render(xfs[0], Wt, Ht, focal=ft)
    print("path frame (compile): %.1fs" % (time.time() - t0), flush=True)
    t0 = time.time()
    for i in range(args.frames):
        img = prt.render(xfs[i], Wt, Ht, focal=ft)
    np.asarray(img[:1])
    dt = (time.time() - t0) / args.frames
    print("%dx%d playback: %.1f ms/frame = %.2f fps" % (
        Wt, Ht, dt * 1e3, 1.0 / dt), flush=True)


if __name__ == "__main__":
    main()
