#!/usr/bin/env python3
"""Per-phase timing of the playback frame: which part of the slice
compositing costs the most at 1080p.

    python scripts/profile_playback.py --load_cache /tmp/fox_cache.npz
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, reps=3):
    jax.block_until_ready(fn(*args))
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / reps


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--load_cache", required=True)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--zb", type=int, default=8)
    p.add_argument("--extra", action="store_true")
    args = p.parse_args()
    from ngp_jax.render.playback import (PlaybackOptions, PlaybackRenderer,
                                         load_playback_cache)
    print("platform:", jax.devices()[0].platform, flush=True)
    cache = load_playback_cache(args.load_cache)
    W, H = args.width, args.height
    r = PlaybackRenderer(cache, PlaybackOptions(width=W, height=H,
                                                zb=args.zb))
    xf = np.eye(4, dtype=np.float32)[:3]
    xf[:, 3] = (0.5, 0.5, -1.2)
    img = r.render(xf, W, H, focal=(H * 1.1, H * 1.1))   # compile + run
    t0 = time.time()
    img = r.render(xf, W, H, focal=(H * 1.1, H * 1.1))
    np.asarray(img[:1])
    print("full frame: %.0f ms" % ((time.time() - t0) * 1e3), flush=True)

    # per-cascade program timing with real inputs (reuse cached programs)
    D0 = int(cache.vols[0].shape[0])
    P, Q = W, H
    Cc = int(np.asarray(cache.vols[0]).shape[-1])
    prog = r._program(D0, P, Q, args.zb, Cc)
    vol = r._get_vol(0, 2, False)
    zs = jnp.linspace(0.0, 1.0, D0)
    e = jnp.asarray([0.5, 0.5, -1.2], jnp.float32)
    pr = jnp.asarray([-0.45, 0.9 / P], jnp.float32)
    qr = jnp.asarray([-0.3, 0.6 / Q], jnp.float32)
    inf2 = jnp.full((Q, P), np.inf, jnp.float32)
    Bb = (Cc - 1) // 3
    ones_b = jnp.ones((Bb, Q, P), jnp.float32)
    t = timeit(prog, vol, zs, e, pr, qr, jnp.float32(1.0), inf2, inf2,
               ones_b)
    print("cascade0 program (D=%d, %dx%d): %.0f ms" % (D0, P, Q, t * 1e3),
          flush=True)

    # resample-only variant: same scan, no composite
    def resample_only(vol, zs, e, prange, qrange, side):
        alpha = prange[0] + (jnp.arange(P, dtype=jnp.float32) + 0.5) \
            * prange[1]
        beta = qrange[0] + (jnp.arange(Q, dtype=jnp.float32) + 0.5) \
            * qrange[1]
        rx = jnp.tan(alpha)[None, :]
        ry = jnp.tan(beta)[:, None]
        vox = side / D0

        def block(acc, xs):
            slabs, z_blk = xs
            h_k = (z_blk - e[2])
            xs_w = e[0] + rx[0][None, :] * h_k[:, None]
            ys_w = e[1] + ry[:, 0][None, :] * h_k[:, None]
            lo = 0.5 - side / 2
            ux = (xs_w - lo) / vox - 0.5
            uy = (ys_w - lo) / vox - 0.5

            def weights(u, n_in):
                j = jnp.arange(n_in, dtype=jnp.float32)
                return jnp.clip(1.0 - jnp.abs(u[..., None] - j),
                                0.0, 1.0).astype(jnp.bfloat16)

            Wx = weights(ux, D0)
            Wy = weights(uy, D0)
            a = jnp.einsum("kqy,kcyx->kcqx", Wy,
                           slabs.astype(jnp.bfloat16),
                           preferred_element_type=jnp.bfloat16)
            smp = jnp.einsum("kpx,kcqx->kcqp", Wx, a,
                             preferred_element_type=jnp.float32)
            return acc + smp.sum(0), None

        acc0 = jnp.zeros((Cc, Q, P), jnp.float32)
        acc, _ = jax.lax.scan(block, acc0,
                              (vol.reshape(D0 // args.zb, args.zb, Cc,
                                           D0, D0),
                               zs.reshape(D0 // args.zb, args.zb)))
        return acc

    f = jax.jit(resample_only)
    t = timeit(f, vol, zs, e, pr, qr, jnp.float32(1.0))
    print("resample-only: %.0f ms" % (t * 1e3), flush=True)

    # weights-only: how much is the on-the-fly W construction
    def weights_only(vol, zs, e, prange, qrange, side):
        alpha = prange[0] + (jnp.arange(P, dtype=jnp.float32) + 0.5) \
            * prange[1]
        rx = jnp.tan(alpha)[None, :]
        vox = side / D0

        def block(acc, xs):
            slabs, z_blk = xs
            h_k = (z_blk - e[2])
            xs_w = e[0] + rx[0][None, :] * h_k[:, None]
            lo = 0.5 - side / 2
            ux = (xs_w - lo) / vox - 0.5
            j = jnp.arange(D0, dtype=jnp.float32)
            Wx = jnp.clip(1.0 - jnp.abs(ux[..., None] - j),
                          0.0, 1.0).astype(jnp.bfloat16)
            return acc + Wx.sum(), None

        acc, _ = jax.lax.scan(block, jnp.zeros((), jnp.float32),
                              (vol.reshape(D0 // args.zb, args.zb, Cc,
                                           D0, D0),
                               zs.reshape(D0 // args.zb, args.zb)))
        return acc

    f = jax.jit(weights_only)
    t = timeit(f, vol, zs, e, pr, qr, jnp.float32(1.0))
    print("weights+volscan-only: %.0f ms" % (t * 1e3), flush=True)

    if args.extra:
        extra_variants(cache, W, H, zb=args.zb)


def extra_variants(cache, W, H, zb=8):
    """Try resample reformulations: fused-N big matmuls vs batched
    einsums (chases the 9% MXU util of the default lowering)."""
    import jax
    import jax.numpy as jnp
    D0 = int(cache.vols[0].shape[0])
    C = int(np.asarray(cache.vols[0]).shape[-1])
    P, Q = W, H
    v = cache.vols[0]  # (D,D,D,C) storage (z,y,x,c)
    vol_yc = jax.device_put(jnp.transpose(v, (0, 1, 3, 2)))  # (z,y,c,x)
    e = jnp.asarray([0.5, 0.5, -1.2], jnp.float32)
    pr = jnp.asarray([-0.45, 0.9 / P], jnp.float32)
    qr = jnp.asarray([-0.3, 0.6 / Q], jnp.float32)

    def fused(vol, zs, e, prange, qrange, side):
        alpha = prange[0] + (jnp.arange(P, dtype=jnp.float32) + 0.5) \
            * prange[1]
        beta = qrange[0] + (jnp.arange(Q, dtype=jnp.float32) + 0.5) \
            * qrange[1]
        rx = jnp.tan(alpha)
        ry = jnp.tan(beta)
        vox = side / D0

        def block(acc, xs):
            slabs, z_blk = xs                       # (zb, D, C, D)
            h_k = (z_blk - e[2])
            ux = (e[0] + rx[None, :] * h_k[:, None]
                  - (0.5 - side / 2)) / vox - 0.5
            uy = (e[1] + ry[None, :] * h_k[:, None]
                  - (0.5 - side / 2)) / vox - 0.5
            j = jnp.arange(D0, dtype=jnp.float32)
            Wx = jnp.clip(1.0 - jnp.abs(ux[..., None] - j),
                          0, 1).astype(jnp.bfloat16)
            Wy = jnp.clip(1.0 - jnp.abs(uy[..., None] - j),
                          0, 1).astype(jnp.bfloat16)
            rhs = slabs.reshape(zb, D0, C * D0).astype(jnp.bfloat16)
            a = jnp.einsum("kqy,kyX->kqX", Wy, rhs,
                           preferred_element_type=jnp.bfloat16)
            a = a.reshape(zb, Q, C, D0).transpose(0, 2, 1, 3)  # k,c,q,x
            smp = jnp.einsum("kpx,kcqx->kcqp", Wx, a,
                             preferred_element_type=jnp.float32)
            return acc + smp.sum(0), None

        acc0 = jnp.zeros((C, Q, P), jnp.float32)
        acc, _ = jax.lax.scan(block, acc0,
                              (vol.reshape(D0 // zb, zb, D0, C, D0),
                               jnp.linspace(0., 1., D0).reshape(
                                   D0 // zb, zb)))
        return acc

    f = jax.jit(fused)
    t = timeit(f, vol_yc, None, e, pr, qr, jnp.float32(1.0))
    print("fused-N resample: %.0f ms" % (t * 1e3), flush=True)


if __name__ == "__main__" and os.environ.get("PB_EXTRA"):
    pass


if __name__ == "__main__":
    main()
