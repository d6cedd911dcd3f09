#!/usr/bin/env python3
"""Fox NeRF benchmark: training throughput + (optionally) time-to-PSNR on a
held-out training view. Run on the real chip:

    python scripts/bench_fox.py --n_steps 1000 [--eval_every 250]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="/root/reference/data/nerf/fox")
    p.add_argument("--downscale", type=int, default=1,
                   help="dataset downscale (CPU-scale ablations)")
    p.add_argument("--batch", type=int, default=0,
                   help="override target_batch_size")
    p.add_argument("--march_steps", type=int, default=0)
    p.add_argument("--n_steps", type=int, default=1000)
    p.add_argument("--eval_every", type=int, default=250)
    p.add_argument("--eval_view", type=int, default=0)
    p.add_argument("--eval_scale", type=int, default=4,
                   help="downscale factor for the eval render")
    p.add_argument("--grid_impl", default="blocked")
    p.add_argument("--fixed_rays", type=int, default=0,
                   help="pin n_rays (avoids recompiles on shape changes)")
    p.add_argument("--dynamic_rays", type=int, default=0, metavar="RMAX",
                   help="static ray batch RMAX with a TRACED live count "
                        "(ray adaptation, zero recompiles)")
    p.add_argument("--save_snapshot", default="")
    p.add_argument("--load_snapshot", default="")
    p.add_argument("--diag", action="store_true",
                   help="also eval view PSNR through the TRAINING march "
                        "path (isolates renderer vs model quality)")
    p.add_argument("--dump", default="",
                   help="save pred/gt npz + regional PSNR breakdown")
    p.add_argument("--world_scale", type=float, default=0.33,
                   help="upstream instant-ngp mapping for classic captures")
    p.add_argument("--world_offset", type=float, nargs=3,
                   default=[0.5, 0.5, 0.5])
    p.add_argument("--adapt_capacity", action="store_true",
                   help="shrink the static sample-stream bucket to the "
                        "measured batch as the grid prunes (extra "
                        "compiles, faster late steps)")
    p.add_argument("--importance", action="store_true",
                   help="error-map importance sampling (image + focal "
                        "plane CDFs; ref default-on via transforms.json)")
    p.add_argument("--lr_decay", type=int, default=0,
                   help="ExponentialDecay decay_start override (steps); "
                        "0 keeps the config (20k = never in short runs)")
    p.add_argument("--lr_decay_interval", type=int, default=500)
    p.add_argument("--lr_decay_base", type=float, default=0.33)
    args = p.parse_args()
    os.environ["NGP_GRID_IMPL"] = args.grid_impl

    import time as _t
    from ngp_jax.common import linear_to_srgb_np
    from ngp_jax.config import load_network_config
    from ngp_jax.data.nerf_loader import load_nerf
    from ngp_jax.opt.optimizers import inference_params
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    tl = _t.time()
    ds = load_nerf(args.scene, scale=args.world_scale,
                   offset=args.world_offset, downscale=args.downscale)
    print("load_nerf %.1fs" % (_t.time() - tl), flush=True)
    cfg = load_network_config("configs/nerf/base.json")
    tcfg = NerfTrainerConfig()
    if args.batch:
        tcfg.target_batch_size = args.batch
    if args.march_steps:
        tcfg.march_steps = args.march_steps
    if args.fixed_rays:
        tcfg.n_rays = args.fixed_rays
        tcfg.adapt_rays = False
    if args.dynamic_rays:
        tcfg.n_rays = args.dynamic_rays
        tcfg.adapt_rays = False
        tcfg.dynamic_rays = True
    if args.importance:
        tcfg.sample_image_proportional_to_error = True
        tcfg.sample_focal_plane_proportional_to_error = True
    if args.adapt_capacity:
        tcfg.adapt_capacity = True
    if args.lr_decay:
        opt = cfg["optimizer"]["nested"]
        opt["decay_start"] = args.lr_decay
        opt["decay_interval"] = args.lr_decay_interval
        opt["decay_base"] = args.lr_decay_base
    tl = _t.time()
    tr = NerfTrainer(ds, cfg, tcfg=tcfg)
    print("init done %.1fs; grid impl: %s" % (_t.time() - tl,
                                              args.grid_impl), flush=True)

    W = int(ds.resolution[args.eval_view][0]) // args.eval_scale
    H = int(ds.resolution[args.eval_view][1]) // args.eval_scale
    gt = ds.images[args.eval_view].astype(np.float32)
    # CENTER-aligned subsample: eval rays go through downsampled pixel
    # centers = original pixel (k*s + s/2); a corner-aligned gt[k*s] is
    # half a pixel off — pure noise in fur (cost ~2-4 dB in round 2)
    yi = np.minimum(np.arange(H) * gt.shape[0] // H +
                    gt.shape[0] // (2 * H), gt.shape[0] - 1)
    xi = np.minimum(np.arange(W) * gt.shape[1] // W +
                    gt.shape[1] // (2 * W), gt.shape[1] - 1)
    gt_small = gt[yi][:, xi]
    gt_srgb = linear_to_srgb_np(np.clip(gt_small[..., :3], 0, 1))
    renderer = None

    if args.load_snapshot:
        tr.load_snapshot_state(args.load_snapshot)
        print("loaded snapshot at step", tr.training_step, flush=True)

    def train_path_psnr(view, scale):
        """View PSNR with rays evaluated through the TRAINING march +
        composite (not the renderer) — isolates renderer divergence."""
        import jax
        import jax.numpy as jnp
        from ngp_jax.opt.optimizers import inference_params as iparams
        from ngp_jax.rays.marching import (composite_samples,
                                           march_and_compact_hier)
        p = iparams(tr.params, tr.opt_state, tr.opt_cfg)
        Wv = int(ds.resolution[view][0]) // scale
        Hv = int(ds.resolution[view][1]) // scale
        ys, xs = np.meshgrid(np.arange(Hv), np.arange(Wv), indexing="ij")
        xy_all = np.stack([(xs.ravel() + 0.5) / Wv,
                           (ys.ravel() + 0.5) / Hv], -1).astype(np.float32)
        n = 1024
        S = n * 1024    # = n * march_steps: truncation IMPOSSIBLE (scanline
        #                 chunks are all-dense; prefix drops showed as 12.8 dB)

        @jax.jit
        def run_chunk(params, bitfield, coarse, xy):
            img = jnp.full((n,), view, jnp.int32)
            o, d, _ = tr._build_rays(tr.data, tr.cam_params, img, xy)
            s_t, s_dt, s_ray, counts, offsets, fits, total, _, s_k = \
                march_and_compact_hier(
                    bitfield, coarse, o, d, None, n, tr.tcfg.march_steps,
                    tr.cone_angle, tr.max_cascade, tr.aabb_min,
                    tr.aabb_size, S)
            rid = jnp.clip(s_ray, 0, n - 1)
            pos = o[rid] + s_t[:, None] * d[rid]
            pw = (pos - tr.aabb_min) / tr.aabb_size
            dw = d[rid] * 0.5 + 0.5
            rgb_raw, dens_raw = tr.model.apply(params, pw, dw)
            rgb = jax.nn.sigmoid(rgb_raw.astype(jnp.float32))
            sigma = jnp.exp(jnp.clip(dens_raw.astype(jnp.float32),
                                     -15., 15.))
            rgb_ray, opac, _ = composite_samples(
                sigma, rgb, s_dt, s_ray, offsets, counts, n,
                s_k=s_k, n_k=tr.tcfg.march_steps)
            return rgb_ray

        out = np.zeros((Hv * Wv, 3), np.float32)
        for i in range(0, Hv * Wv, n):
            sl = slice(i, min(i + n, Hv * Wv))
            xy = np.zeros((n, 2), np.float32)
            xy[: sl.stop - sl.start] = xy_all[sl]
            out[sl] = np.asarray(run_chunk(
                p, tr.grid.bitfield, tr.grid.coarse,
                jnp.asarray(xy)))[: sl.stop - sl.start]
        gt = ds.images[view].astype(np.float32)
        yi = np.minimum(np.arange(Hv) * gt.shape[0] // Hv +
                        gt.shape[0] // (2 * Hv), gt.shape[0] - 1)
        xi = np.minimum(np.arange(Wv) * gt.shape[1] // Wv +
                        gt.shape[1] // (2 * Wv), gt.shape[1] - 1)
        gts = linear_to_srgb_np(np.clip(gt[yi][:, xi][..., :3], 0, 1))
        # the training composite is ALREADY in sRGB space (network heads
        # are sRGB when train_in_linear_colors is off) — no re-encode
        pred = np.clip(out.reshape(Hv, Wv, 3), 0, 1)
        mse = float(np.mean((pred - gts) ** 2))
        return -10 * np.log10(max(mse, 1e-10))

    if args.load_snapshot and tr.training_step >= args.n_steps:
        pass    # eval-only invocation: skip the warm-up training chunk
    else:
        t0 = time.time()
        tr.train(tr.tcfg.n_steps_between_grid_updates)
        print("first chunk (compile) %.1fs" % (time.time() - t0),
              flush=True)

    t_train0 = time.time()
    steps_done = tr.training_step
    first_pass = True
    while steps_done < args.n_steps or first_pass:
        first_pass = False
        k = max(min(args.eval_every, args.n_steps - steps_done), 0)
        ts = time.time()
        loss = tr.train(k)
        dt = time.time() - ts
        steps_done += k
        live = f" live={tr._n_live}" if tr.tcfg.dynamic_rays else ""
        print(f"step {steps_done}: loss={loss:.5f} "
              f"{k / dt:.2f} steps/s n_rays={tr.tcfg.n_rays}{live} "
              f"elapsed={time.time() - t_train0:.0f}s", flush=True)
        if renderer is None:
            # dataset intrinsics: principal point + OpenCV distortion —
            # training rays use them; rendering without warps the frame
            # (fox: cx 14.5 px off center, k1 0.058 → ~8 dB of the
            # round-2 'plateau' was this mismatch)
            renderer = NerfRenderer.for_trainer(tr, RenderOptions(
                width=W, height=H, background=(0, 0, 0, 0),
                linear_out=True, chunk=1 << 15,
                principal=tuple(float(x) for x in ds.principal[args.eval_view]),
                lens_params=tuple(float(x) for x in
                                  ds.lens_params[args.eval_view][:4]),
                lens_mode="opencv" if ds.lens_is_opencv else "auto"))
        params = inference_params(tr.params, tr.opt_state, tr.opt_cfg)
        te = time.time()
        img = renderer.render(
            params, tr.grid.bitfield, ds.xforms[args.eval_view], W, H,
            focal=(ds.focal[args.eval_view][0] / args.eval_scale,
                   ds.focal[args.eval_view][1] / args.eval_scale))
        pred = linear_to_srgb_np(np.clip(img[..., :3], 0, 1))
        mse = float(np.mean((pred - gt_srgb) ** 2))
        psnr = -10 * np.log10(max(mse, 1e-10))
        print(f"  eval view {args.eval_view} ({W}x{H}): "
              f"PSNR={psnr:.2f} dB (render {time.time() - te:.1f}s)",
              flush=True)
        if args.dump:
            np.savez(args.dump, pred=pred, gt=gt_srgb,
                     opacity=img[..., 3])
            # regional breakdown: where is the error?
            e2 = ((pred - gt_srgb) ** 2).mean(-1)
            hq, wq = H // 4, W // 4
            cen = e2[hq: 3 * hq, wq: 3 * wq]
            ring = e2.sum() - cen.sum()
            ring /= (e2.size - cen.size)

            def db(m): return -10 * np.log10(max(float(m), 1e-10))
            print(f"  regions: center={db(cen.mean()):.2f} dB "
                  f"border={db(ring):.2f} dB "
                  f"worst rows: {np.argsort(e2.mean(1))[-3:]} "
                  f"opacity mean={float(img[..., 3].mean()):.3f}",
                  flush=True)
        if args.diag:
            td = time.time()
            dpsnr = train_path_psnr(args.eval_view, args.eval_scale)
            print(f"  diag train-path PSNR={dpsnr:.2f} dB "
                  f"({time.time() - td:.1f}s)", flush=True)

    if args.save_snapshot:
        from ngp_jax.config import load_network_config as _l
        tr.save_snapshot(args.save_snapshot, cfg,
                         include_optimizer_state=True)
        print("saved snapshot →", args.save_snapshot, flush=True)


if __name__ == "__main__":
    main()
