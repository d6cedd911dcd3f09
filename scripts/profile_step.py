#!/usr/bin/env python3
"""Per-phase timing of the NeRF training step on the current accelerator.

Times each pipeline stage with the iteration loop INSIDE one jit (lax.scan)
so per-dispatch overhead doesn't pollute the numbers.

    python scripts/profile_step.py [--n_rays 4096] [--steps 1024]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def timed(fn, *args, k=8):
    jax.block_until_ready(fn(*args))  # compile
    t0 = time.time()
    jax.block_until_ready(fn(*args))
    return (time.time() - t0) / k


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n_rays", type=int, default=4096)
    p.add_argument("--steps", type=int, default=1024)   # march K
    p.add_argument("--batch", type=int, default=1 << 18)
    p.add_argument("--grid_impl", default="blocked")
    p.add_argument("--k", type=int, default=8)          # scan length
    p.add_argument("--occupancy", type=float, default=0.3)
    args = p.parse_args()
    os.environ["NGP_GRID_IMPL"] = args.grid_impl

    import jax.numpy as jnp
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig
    from ngp_jax.rays.marching import march_rays, compact_samples
    from tests.synthetic import make_orbit_dataset

    print("platform:", jax.devices()[0].platform, flush=True)
    R, K, S = args.n_rays, args.steps, args.batch

    ds = make_orbit_dataset(n_images=8, res=256, radius=1.2, aabb_scale=16,
                            focal=256.0)
    cfg = load_network_config("configs/nerf/base.json")
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=R, target_batch_size=S, march_steps=K))

    key = jax.random.PRNGKey(0)
    kb, key = jax.random.split(key)
    bits = jax.random.bernoulli(
        kb, args.occupancy, (tr.grid.bitfield.size * 8,))
    bitfield = jnp.packbits(bits, bitorder="little").reshape(
        tr.grid.bitfield.shape)

    def scanner(body, init_args):
        @jax.jit
        def run(*a):
            def step(c, _):
                out = body(*c)
                # fold a scalar back in so iterations serialize
                c2 = (c[0] + 1e-30 * out, *c[1:])
                return c2, out
            (_, *_r), outs = jax.lax.scan(step, a, None, length=args.k)
            return outs.sum()
        return run

    # phase 1: ray build + march (lattice + occupancy gather)
    img = jnp.zeros((R,), jnp.int32)
    def do_march(seed_f):
        kk = jax.random.fold_in(key, (seed_f).astype(jnp.int32))
        k1, k2 = jax.random.split(kk)
        xy = jax.random.uniform(k1, (R, 2))
        o, d, _ = tr._build_rays(tr.data, tr.cam_params, img, xy)
        t, dt, emit = march_rays(bitfield, o, d, k2, R, K,
                                 tr.cone_angle, tr.max_cascade,
                                 tr.aabb_min, tr.aabb_size)
        return emit.sum().astype(jnp.float32)
    dt_march = timed(scanner(do_march, None), jnp.float32(1.0), k=args.k)
    print(f"march (lattice+occupancy {R}x{K}): {dt_march*1e3:8.2f} ms",
          flush=True)

    # phase 2: march + compaction
    def do_compact(seed_f):
        kk = jax.random.fold_in(key, (seed_f).astype(jnp.int32))
        k1, k2 = jax.random.split(kk)
        xy = jax.random.uniform(k1, (R, 2))
        o, d, _ = tr._build_rays(tr.data, tr.cam_params, img, xy)
        t, dt, emit = march_rays(bitfield, o, d, k2, R, K,
                                 tr.cone_angle, tr.max_cascade,
                                 tr.aabb_min, tr.aabb_size)
        s_t, s_dt, s_ray, counts, offsets, fits, total, _ = compact_samples(
            t, dt, emit, R, S)
        return s_t.sum() + s_dt.sum() + total.astype(jnp.float32)
    dt_mc = timed(scanner(do_compact, None), jnp.float32(1.0), k=args.k)
    print(f"march + compaction:                {dt_mc*1e3:8.2f} ms "
          f"(compaction ≈ {(dt_mc-dt_march)*1e3:.2f})", flush=True)

    # phase 3: encode+MLP+composite loss fwd+bwd on a fixed compacted batch
    kk1, kk2, kk3 = jax.random.split(key, 3)
    s_t = jnp.sort(jax.random.uniform(kk1, (S,)) * 2.0)
    s_dt = jnp.full((S,), 1e-3)
    s_ray = jnp.sort(jax.random.randint(kk2, (S,), 0, R))
    counts = jnp.bincount(s_ray, length=R).astype(jnp.int32)
    offsets = jnp.cumsum(counts) - counts
    o = jnp.full((R, 3), 0.1)
    d = jax.random.normal(kk3, (R, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tgt = jax.random.uniform(kk3, (R, 3))

    def net_loss(p, s_t):
        rid = jnp.clip(s_ray, 0, R - 1)
        s_pos = o[rid] + s_t[:, None] * d[rid]
        s_pos = (s_pos - tr.aabb_min) / tr.aabb_size
        s_dir = d[rid] * 0.5 + 0.5
        rgb_raw, dens_raw = tr.model.apply(p, s_pos, s_dir)
        rgb = jax.nn.sigmoid(rgb_raw.astype(jnp.float32))
        sigma = jnp.exp(jnp.clip(dens_raw.astype(jnp.float32), -15., 15.))
        sdt = sigma * s_dt
        cum = jnp.cumsum(sdt)
        excl = cum - sdt
        seg = excl[jnp.clip(offsets, 0, S - 1)]
        T = jnp.exp(-(excl - seg[rid]))
        w = T * (1.0 - jnp.exp(-sdt))
        rgb_ray = jnp.zeros((R, 3)).at[s_ray].add(w[:, None] * rgb,
                                                  mode="drop")
        return jnp.mean((rgb_ray - tgt) ** 2) * 128.0

    def do_net(seed_f):
        l, g = jax.value_and_grad(net_loss)(tr.params, s_t + 1e-9 * seed_f)
        return l + sum(jnp.sum(x) * 0.0 for x in jax.tree.leaves(g)) * 0.0
    dt_net = timed(scanner(do_net, None), jnp.float32(1.0), k=args.k)
    print(f"encode+MLP+composite fwd+bwd (S={S}): {dt_net*1e3:6.2f} ms",
          flush=True)

    # phase 3a: pos-encode alone fwd+bwd
    enc = tr.model.pos_encoding
    s_pos_fix = jax.random.uniform(kk1, (S, 3))

    ptbl = tr.params["pos_encoding"]

    def do_enc(seed_f):
        def f(t):
            return jnp.sum(enc.apply(t, s_pos_fix + 1e-9 * seed_f) ** 2)
        l, g = jax.value_and_grad(f)(ptbl)
        return l + sum(jnp.sum(x) * 0.0 for x in jax.tree.leaves(g))
    dt_enc = timed(scanner(do_enc, None), jnp.float32(1.0), k=args.k)
    print(f"  encode alone fwd+bwd:            {dt_enc*1e3:8.2f} ms",
          flush=True)

    def do_enc_fwd(seed_f):
        return jnp.sum(enc.apply(ptbl, s_pos_fix + 1e-9 * seed_f) ** 2)
    dt_encf = timed(scanner(do_enc_fwd, None), jnp.float32(1.0), k=args.k)
    print(f"  encode alone fwd:                {dt_encf*1e3:8.2f} ms",
          flush=True)

    print(f"  (MLP+composite ~= {(dt_net-dt_enc)*1e3:.2f} ms by subtraction)",
          flush=True)

    # phase 4: full training step (jitted once, timed per dispatch since it
    # carries trainer state; k dispatches amortize the fetch)
    tr.train(1)
    t0 = time.time()
    tr.train(16)
    jax.block_until_ready(tr.params)
    dt_full = (time.time() - t0) / 16
    print(f"full train step:                   {dt_full*1e3:8.2f} ms",
          flush=True)

    # phase 5: occupancy grid update cost (amortized every 16 steps)
    kk, _ = jax.random.split(key)
    g2 = jax.block_until_ready(
        tr._grid_update(tr.params, tr.grid, kk, full_sweep=False))
    t0 = time.time()
    g2 = jax.block_until_ready(
        tr._grid_update(tr.params, g2, kk, full_sweep=False))
    print(f"grid update (every 16 steps):      {(time.time()-t0)*1e3:8.2f} ms",
          flush=True)


if __name__ == "__main__":
    main()
