#!/usr/bin/env python3
"""Fox NeRF benchmark: prints ONE JSON line.

Metric: training time to reach 30 dB PSNR on fox training view 0 at ¼
resolution; vs_baseline is target_seconds / our_seconds (≥ 1.0 = target
met). If 30 dB isn't reached inside the budget, reports the PSNR actually
reached (vs_baseline = psnr/30).

    python bench.py --scene <fox dataset directory>

Needs a GPU: without one it exits non-zero and prints no result.
"""
import argparse
import json
import sys
import time

import jax
import numpy as np

TARGET_DB = 30.0
TARGET_SECONDS = 60.0
TRAIN_BUDGET_S = 1500


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", required=True,
                    help="directory of the fox capture (transforms.json)")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(f"bench.py needs a GPU; JAX found {dev.platform}\n")
        return 1

    from ngp_jax.common import linear_to_srgb_np
    from ngp_jax.config import load_network_config
    from ngp_jax.data.nerf_loader import load_nerf
    from ngp_jax.opt.optimizers import inference_params
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    # upstream instant-ngp world mapping — REQUIRED for the classic fox capture
    ds = load_nerf(args.scene, scale=0.33, offset=[0.5, 0.5, 0.5])
    cfg = load_network_config("configs/nerf/base.json")
    # static 4096-ray batch with a TRACED live count (the reference's
    # per-step rays_per_batch adaptation, testbed_nerf.cu:2890-2891, with
    # zero recompiles) and error-map importance sampling, as the
    # reference enables from transforms.json
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=4096, adapt_rays=False, dynamic_rays=True,
        sample_image_proportional_to_error=True,
        sample_focal_plane_proportional_to_error=True))

    view, scale = 0, 4
    W = int(ds.resolution[view][0]) // scale
    H = int(ds.resolution[view][1]) // scale
    gt = ds.images[view].astype(np.float32)
    yi = np.minimum(np.arange(H) * gt.shape[0] // H + gt.shape[0] // (2 * H),
                    gt.shape[0] - 1)
    xi = np.minimum(np.arange(W) * gt.shape[1] // W + gt.shape[1] // (2 * W),
                    gt.shape[1] - 1)
    gt = gt[yi][:, xi]
    gt_srgb = linear_to_srgb_np(np.clip(gt[..., :3], 0, 1))
    renderer = NerfRenderer.for_trainer(tr, RenderOptions(
        width=W, height=H, background=(0, 0, 0, 0), linear_out=True,
        chunk=1 << 15,
        # dataset intrinsics: off-center principal + OpenCV distortion —
        # rendering with defaults warps the frame vs GT
        principal=tuple(float(x) for x in ds.principal[view]),
        lens_params=tuple(float(x) for x in ds.lens_params[view][:4]),
        lens_mode="opencv" if ds.lens_is_opencv else "auto"))
    focal = (float(ds.focal[view][0]) / scale,
             float(ds.focal[view][1]) / scale)

    def eval_psnr():
        p = inference_params(tr.params, tr.opt_state, tr.opt_cfg)
        img = renderer.render(p, tr.grid.bitfield, ds.xforms[view], W, H,
                              focal=focal)
        pred = linear_to_srgb_np(np.clip(img[..., :3], 0, 1))
        mse = float(np.mean((pred - gt_srgb) ** 2))
        return -10 * np.log10(max(mse, 1e-10))

    tr.train(16)          # compile train path outside the timed region
    eval_psnr()           # compile render path

    train_s, elapsed, psnr = 0.0, None, 0.0
    for chunk in [64, 112, 128, 192, 256, 256, 512, 256, 256, 256,
                  256, 256, 256, 512, 512, 1024]:
        t0 = time.time()
        tr.train(chunk)
        jax.block_until_ready(tr.params)
        train_s += time.time() - t0
        psnr = eval_psnr()
        sys.stderr.write("steps=%d train_s=%.1f psnr=%.2f\n"
                         % (tr.training_step, train_s, psnr))
        if psnr >= TARGET_DB:
            elapsed = train_s
            break
        if train_s > TRAIN_BUDGET_S:
            break

    if elapsed is None:
        print(json.dumps({
            "metric": "fox NeRF: PSNR after %.0fs training" % train_s,
            "value": round(psnr, 2), "unit": "dB",
            "vs_baseline": round(psnr / TARGET_DB, 3)}))
    else:
        print(json.dumps({
            "metric": "fox NeRF: train time to %.0f dB PSNR" % TARGET_DB,
            "value": round(elapsed, 2), "unit": "s",
            "vs_baseline": round(TARGET_SECONDS / elapsed, 4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
