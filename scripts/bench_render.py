#!/usr/bin/env python3
"""1080p render throughput on the current accelerator (BASELINE: ≥30 fps
camera-path render at 1920×1080).

    python scripts/bench_render.py [--width 1920 --height 1080]
    [--occupancy 0.02] [--frames 8]

Uses a realistic sparse occupancy grid + untrained weights (the network
cost is weight-independent) so it runs without a dataset.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--occupancy", type=float, default=0.02)
    p.add_argument("--aabb_scale", type=int, default=16)
    # rays per chunk: bounds the (chunk, march_steps) lattice of one scan
    # step
    p.add_argument("--chunk", type=int, default=1 << 14)
    p.add_argument("--grid_impl", default="blocked")
    p.add_argument("--wave", action="store_true",
                   help="live-sample wave path (dynamic block dispatch)")
    p.add_argument("--multichip", type=int, default=0, metavar="N",
                   help="also time render_multichip over an N-device mesh "
                        "(frame-parallel pixel sharding; on the chip N=1 "
                        "checks path overhead, on the virtual CPU mesh "
                        "N=8 checks the sharded program)")
    args = p.parse_args()
    os.environ["NGP_GRID_IMPL"] = args.grid_impl

    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tests"))
    from synthetic import make_orbit_dataset
    from ngp_jax.config import load_network_config
    from ngp_jax.grid import occupancy as occ
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    print("platform:", jax.devices()[0].platform, flush=True)
    ds = make_orbit_dataset(n_images=4, res=64, radius=1.2,
                            aabb_scale=args.aabb_scale, focal=64.0)
    cfg = load_network_config("configs/nerf/base.json")
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(n_rays=1024,
                                                     march_steps=512))
    dens = jnp.where(
        jax.random.uniform(jax.random.PRNGKey(0),
                           tr.grid.density.shape) < args.occupancy, 1.0, 0.0)
    grid = occ.rebuild_bitfield(tr.grid._replace(density=dens),
                                tr.max_cascade)

    W, H = args.width, args.height
    fx = H * 1.2
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        width=W, height=H, background=(0, 0, 0, 0), linear_out=False,
        chunk=args.chunk, wave=args.wave))
    xf = ds.xforms[0]

    t0 = time.time()
    img = r.render(tr.params, grid.bitfield, xf, W, H, focal=(fx, fx))
    print(f"first frame (compile): {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    for i in range(args.frames):
        img = r.render(tr.params, grid.bitfield, xf, W, H, focal=(fx, fx),
                       seed=i)
    dt = (time.time() - t0) / args.frames
    extra = ""
    if args.wave:
        extra = f" wave_samples={getattr(r, 'last_wave_samples', 0)}"
    print(f"{W}x{H} spp1: {dt * 1e3:.1f} ms/frame = {1.0 / dt:.2f} fps "
          f"(mean alpha {float(img[..., 3].mean()):.3f}){extra}",
          flush=True)

    if args.multichip:
        # Frame-parallel scale-out evidence: rendering has NO cross-device
        # traffic until the final per-shard image gather (out_specs
        # P('data')), so per-device work is exactly total/N. Time the
        # sharded program and print the projection from the measured
        # single-device rate.
        from ngp_jax.dist.mesh import make_mesh
        nd = args.multichip
        mesh = make_mesh(n_data=nd, devices=jax.devices()[:nd])
        t0 = time.time()
        img_m = r.render_multichip(mesh, tr.params, grid.bitfield, xf,
                                   W, H, focal=(fx, fx))
        print(f"multichip({nd}) first frame (compile): "
              f"{time.time() - t0:.1f}s", flush=True)
        t0 = time.time()
        for i in range(max(args.frames // 2, 1)):
            img_m = r.render_multichip(mesh, tr.params, grid.bitfield, xf,
                                       W, H, focal=(fx, fx), seed=i)
        dtm = (time.time() - t0) / max(args.frames // 2, 1)
        err = float(np.abs(np.asarray(img_m) - np.asarray(img)).max()) \
            if args.frames else 0.0
        print(f"multichip({nd}) {W}x{H} spp1: {dtm * 1e3:.1f} ms/frame "
              f"(vs single-path {dt * 1e3:.1f} ms; max|Δ| {err:.2e})",
              flush=True)
        px_s = W * H / dt
        for target_fps in (30.0,):
            need = target_fps * W * H / px_s
            print(f"projection: {px_s / 1e3:.1f} k px/s/chip → "
                  f"{need:.0f} chips for {W}x{H}@{target_fps:.0f}fps "
                  f"(frame-parallel, no collectives in the hot path)",
                  flush=True)


if __name__ == "__main__":
    main()
