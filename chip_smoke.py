#!/usr/bin/env python3
"""GPU smoke run of the NeRF main path at the full width of
configs/nerf/base.json, through the entry points a user calls.

    python chip_smoke.py [--seed 0]     # one card: phases (a)-(d)
    python chip_smoke.py --four         # data-parallel path on 4 cards

Phases on one card:
  (a) device: JAX must see a GPU; prints its kind, the device count and
      nvidia-smi's name and power limit.
  (b) blocked-grid encode at 2^18 samples x 16 levels: forward, table
      gradient and position gradient against ``encode_reference`` on the
      card, the forward against float64 numpy on 4096 samples, and the
      fwd+bwd time of both XLA formulations.
  (c) NerfTrainer on a scene generated from --seed (analytic spheres,
      orbit cameras): ray directions against float64 numpy, three 16-step
      chunks whose loss must be finite and fall, steps/s and samples/s of
      the last, and the compiled step's memory analysis.
  (d) NerfRenderer: one held-out view at its own resolution (PSNR against
      the analytic ground truth) and one 1920x1080 frame from the same
      camera.
``--four`` runs only DpNerfTrainer over a data=4 mesh (three chunks, the
last one timed) and compares one DP step's loss with four single-device
steps.

Every failure raises, so the process exits non-zero; the JSON line
``{"ok": true, ...}`` is printed last, and only when every phase passed.
"""
import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ngp_jax.config import autofill_hashgrid_config, load_network_config
from ngp_jax.data.nerf_loader import NerfDataset
from ngp_jax.kernels.blocked_grid import (BlockedGridMeta, _block_geom,
                                          _HASH_PRIMES, encode,
                                          encode_reference)
from scripts.make_synth_scene import field, orbit_ngp_xforms

CONFIG = ROOT / "configs" / "nerf" / "base.json"
AABB_SCALE = 2          # the synthetic scene's own setting
RES = 400               # train and held-out views are RES x RES
N_TRAIN, N_TEST = 24, 4
FOCAL_MULT = 1.1        # focal = 1.1 * width, as the scene generator uses
N_ENCODE = 1 << 18      # samples per step at base.json's target batch
ENCODE_META = (16, 2, 13)   # base.json: levels, features, log2 rows
TRAIN_CFG = dict(n_rays=4096, adapt_rays=False, dynamic_rays=True)


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [l.strip() for l in out.stdout.strip().splitlines()]


def phase_device(n_expected):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX runs on "
                         f"{devs[0].platform}")
    if len(devs) < n_expected:
        raise SystemExit(f"needs {n_expected} GPUs, found {len(devs)}")
    cards = card_lines()
    print(f"(a) jax device_kind={devs[0].device_kind} count={len(devs)}")
    for line in cards:
        print(f"(a) nvidia-smi: {line}")
    return cards


def check_close(name, got, want, atol, rtol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = np.abs(got - want)
    bound = atol + rtol * np.abs(want)
    worst = float(np.max(err - bound))
    print(f"    {name}: max|diff|={float(err.max()):.3e} "
          f"(atol {atol:.1e}, rtol {rtol:.1e}) shape={got.shape}")
    if worst > 0:
        raise AssertionError(f"{name}: exceeds tolerance by {worst:.3e}")


# ---------------------------------------------------------------------------
# (b) blocked-grid encode
# ---------------------------------------------------------------------------

def encode_f64(table, pos, meta):
    """Independent float64 numpy forward of the blocked grid (prime-hashed
    rows, raster rows on dense levels)."""
    assert meta.row_hash == "prime" and meta.n_dims == 3
    side, stride = _block_geom(3)
    F = meta.n_features_per_level
    table = np.asarray(table, np.float64)
    pos = np.asarray(pos, np.float64)
    out = np.zeros((pos.shape[0], meta.n_levels, F))
    for l in range(meta.n_levels):
        x = pos * np.float64(np.float32(meta.level_scales[l])) + 0.5
        base = np.floor(x).astype(np.int64)
        frac = x - base
        nblk = meta.level_blocks_per_dim[l]
        block = np.clip(base // stride, 0, nblk - 1)
        local = base - (base // stride) * stride
        if meta.level_is_dense[l]:
            row = block[:, 0] + nblk * (block[:, 1] + nblk * block[:, 2])
        else:
            b = block.astype(np.uint64)
            h = b[:, 0] * np.uint64(_HASH_PRIMES[0])
            for d in (1, 2):
                h = h ^ ((b[:, d] * np.uint64(_HASH_PRIMES[d]))
                         & np.uint64(0xFFFFFFFF))
            row = (h & np.uint64(meta.rows - 1)).astype(np.int64)
        for c in range(8):
            bit = np.array([(c >> d) & 1 for d in range(3)])
            v = local + bit
            lane = (v[:, 0] + side * v[:, 1] + side * side * v[:, 2]) * F
            w = np.prod(np.where(bit > 0, frac, 1.0 - frac), axis=-1)
            for f in range(F):
                out[:, l, f] += w * table[l, row, lane + f]
    return out.reshape(pos.shape[0], -1)


def off_boundary_positions(key, meta, n):
    """n positions whose cell coordinates stay 1e-3 away from every cell
    boundary at every level, so f32 and f64 pick the same corners."""
    cand = np.asarray(jax.random.uniform(key, (4 * n, 3)), np.float32)
    ok = np.ones(len(cand), bool)
    for s in meta.level_scales:
        x = cand.astype(np.float64) * np.float32(s) + 0.5
        fr = x - np.floor(x)
        ok &= np.all((fr > 1e-3) & (fr < 1 - 1e-3), axis=-1)
    sel = cand[ok][:n]
    if len(sel) < n:
        raise AssertionError(f"only {len(sel)} of {n} positions off the "
                             "cell boundaries")
    return jnp.asarray(sel)


def time_ms(fn, *args, reps=10):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def bytes_accessed(fn, *args):
    cost = fn.lower(*args).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost.get("bytes accessed", float("nan")))


def phase_encode(seed, card):
    cfg = load_network_config(CONFIG)
    enc = autofill_hashgrid_config(cfg["encoding"], 3, 2048.0,
                                   aabb_scale=AABB_SCALE)
    meta = BlockedGridMeta.from_hashgrid_config(enc)
    if (meta.n_levels, meta.n_features_per_level,
            meta.log2_rows) != ENCODE_META:
        raise AssertionError(f"encode phase is not at base.json width: "
                             f"{meta}")
    k_t, k_p, k_g, k_s = jax.random.split(jax.random.PRNGKey(seed), 4)
    table = jax.random.uniform(k_t, (meta.n_levels, meta.rows, 128),
                               minval=-1.0, maxval=1.0)
    pos = jax.random.uniform(k_p, (N_ENCODE, 3))
    g_out = jax.random.normal(k_g, (N_ENCODE, meta.n_output_dims))
    print(f"(b) blocked-grid encode: N={N_ENCODE} L={meta.n_levels} "
          f"F={meta.n_features_per_level} rows=2^{meta.log2_rows}")

    def fwd_bwd(f):
        def run(t, p):
            out, vjp = jax.vjp(lambda t, p: f(t, p, meta), t, p)
            return (out,) + vjp(g_out)
        return jax.jit(run)

    new, ref = fwd_bwd(encode), fwd_bwd(encode_reference)
    out_n, gt_n, gp_n = new(table, pos)
    with jax.default_matmul_precision("highest"):
        out_r, gt_r, gp_r = ref(table, pos)
    # forward: the same gathered f32 values and f32 weights, summed over
    # the 8 corners in possibly another order — a few f32 ulps of |T| ≤ 1
    check_close("forward vs encode_reference", out_n, out_r, atol=2e-6)
    # table gradient: a scatter-add of ~10^3 terms per coarse-level
    # entry, in an order GPU atomics leave nondeterministic; f32 rounding
    # grows as n·eps ≈ 6e-5 of the largest entry
    gmax = float(jnp.max(jnp.abs(gt_r)))
    check_close("table grad vs encode_reference", gt_n, gt_r,
                atol=1e-4 * gmax, rtol=1e-5)
    # position gradient: per-level corner differences times level scales
    # up to ~2^12, summed over levels in possibly another order
    pmax = float(jnp.max(jnp.abs(gp_r)))
    check_close("position grad vs encode_reference", gp_n, gp_r,
                atol=1e-5 * pmax, rtol=1e-5)

    pos64 = off_boundary_positions(k_s, meta, 4096)
    got = jax.jit(lambda t, p: encode(t, p, meta))(table, pos64)
    # f32 x = pos * scale with scale up to ~2^12 rounds by up to
    # ulp(4096)/2 = 2.4e-4 per dimension, which moves the interpolation
    # weights by as much; with |T| ≤ 1 a level's output can move by
    # 3 dims x 2 x 2.4e-4 ≈ 1.5e-3
    check_close("forward vs float64 numpy (4096 samples)", got,
                encode_f64(table, pos64, meta), atol=3e-3)

    ms_n, ms_r = time_ms(new, table, pos), time_ms(ref, table, pos)
    b_n, b_r = bytes_accessed(new, table, pos), bytes_accessed(ref, table, pos)
    print(f"(b) fwd+bwd gather form:  {ms_n:.3f} ms, XLA bytes accessed "
          f"{b_n / 1e9:.3f} GB [{card}]")
    print(f"(b) fwd+bwd row-gather reference: {ms_r:.3f} ms, XLA bytes "
          f"accessed {b_r / 1e9:.3f} GB [{card}]")


# ---------------------------------------------------------------------------
# (c) training on a generated scene
# ---------------------------------------------------------------------------

def render_gt(o, d, n_steps=384, t0=0.05, t1=2.5):
    """Analytic ground truth along rays: make_synth_scene's quadrature
    (uniform steps, linear rgb premultiplied, alpha) on the device."""
    ts = jnp.linspace(t0, t1, n_steps, dtype=jnp.float32)
    dt = ts[1] - ts[0]

    def step(carry, t):
        rgb_acc, T = carry
        rgb, sigma = field(o + t * d, jnp)
        alpha = 1.0 - jnp.exp(-sigma * dt)
        return (rgb_acc + (T * alpha)[:, None] * rgb, T * (1.0 - alpha)), None

    init = (jnp.zeros(o.shape, jnp.float32), jnp.ones(o.shape[0], jnp.float32))
    (rgb, T), _ = jax.lax.scan(step, init, ts)
    return jnp.concatenate([rgb, (1.0 - T)[:, None]], -1)


def camera_dirs(W, H, fl):
    """Camera-space pixel-center directions, (H*W, 3) float64."""
    u, v = np.meshgrid((np.arange(W) + 0.5) / W, (np.arange(H) + 0.5) / H)
    return np.stack([(u - 0.5) * W / fl, (v - 0.5) * H / fl,
                     np.ones_like(u)], -1).reshape(-1, 3)


def make_scene(seed):
    """Train dataset and held-out views of the analytic sphere scene."""
    fl = FOCAL_MULT * RES
    xfs = np.stack(orbit_ngp_xforms(N_TRAIN + N_TEST, seed=seed))
    d_cam = jnp.asarray(camera_dirs(RES, RES, fl), jnp.float32)

    @jax.jit
    def gt_view(xf):
        d = jnp.matmul(d_cam, xf[:, :3].T, precision="highest")
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return render_gt(jnp.broadcast_to(xf[:, 3], d.shape), d)

    imgs = np.stack([np.asarray(gt_view(jnp.asarray(x))).reshape(RES, RES, 4)
                     for x in xfs])
    n = N_TRAIN
    ds = NerfDataset(
        images=imgs[:n], xforms=xfs[:n], xforms_end=xfs[:n],
        focal=np.full((n, 2), fl, np.float32),
        principal=np.full((n, 2), 0.5, np.float32),
        resolution=np.full((n, 2), RES, np.int32),
        lens_params=np.zeros((n, 4), np.float32), lens_is_opencv=False,
        depth_images=None, aabb_scale=AABB_SCALE, scale=1.0,
        offset=np.zeros(3, np.float32), n_extra_learnable_dims=0,
        sharpness=np.ones(n, np.float32), paths=[],
        up=np.array([0.0, 0.0, 1.0], np.float32))
    return ds, xfs[n:], imgs[n:], fl


def check_ray_dirs(ds, seed):
    """The trainer's ray generation against float64 numpy."""
    from ngp_jax.rays.camera import pixel_to_ray_train
    n = 1 << 16
    rng = np.random.default_rng(seed)
    img = rng.integers(0, ds.n_images, n)
    xy = rng.random((n, 2)).astype(np.float32)

    @jax.jit
    def dirs(xy, xf, focal, principal, res, lens):
        _, d = pixel_to_ray_train(xy, xf, focal, principal, res, lens, False)
        return d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    got = dirs(xy, ds.xforms[img], ds.focal[img], ds.principal[img],
               ds.resolution[img].astype(np.float32), ds.lens_params[img])
    xy64 = xy.astype(np.float64)
    d_cam = np.stack([(xy64[:, 0] - 0.5) * RES / ds.focal[img, 0],
                      (xy64[:, 1] - 0.5) * RES / ds.focal[img, 1],
                      np.ones(n)], -1)
    want = np.einsum("nij,nj->ni", ds.xforms[img, :, :3].astype(np.float64),
                     d_cam)
    want /= np.linalg.norm(want, axis=-1, keepdims=True)
    # unit vectors from a handful of f32 operations: ~1e-7 each; TF32
    # (10-bit mantissa) would be off by ~1e-3
    check_close("ray directions vs float64 numpy", got, want, atol=1e-5)


def chunk_memory(tr):
    """memory_analysis() of the compiled 16-step training chunk."""
    tc = tr.tcfg
    fn = tr._chunk_fn(tc.n_rays, tc.n_steps_between_grid_updates,
                      capacity=tc.target_batch_size)
    args = (tr.params, tr.opt_state, tr.cam_params, tr.cam_m, tr.cam_v,
            tr.error_map, tr.sharpness_grid, tr._error_state(), tr.grid,
            tr.key, tr.data, jnp.int32(tr._n_live))
    return fn.lower(*args).compile().memory_analysis()


def train_chunks(tr, card, label, n_chunks):
    """16-step chunks (each begins with an occupancy-grid update). The
    loss must stay finite and fall from the first chunk to the last;
    throughput is read from the last chunk, after every compile."""
    tc = tr.tcfg
    losses = []
    for i in range(n_chunks):
        t0 = time.perf_counter()
        losses.append(tr.train(16))
        jax.block_until_ready(tr.params)
        dt = time.perf_counter() - t0
        print(f"{label} chunk {i + 1}: loss {losses[-1]:.6f}, {dt:.2f} s "
              f"[{card}]")
    n_dev = getattr(tr, "n_devices", 1)
    samples = min(tr.last_measured_samples, tc.target_batch_size) * n_dev
    print(f"{label} steps/s {16 / dt:.3f}, samples/s "
          f"{samples * 16 / dt:.4e} (compacted samples of the last step "
          f"x 16 / last chunk s, chunk includes one grid update) [{card}]")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")


def phase_train(seed, card):
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig
    t0 = time.perf_counter()
    ds, test_xfs, test_imgs, fl = make_scene(seed)
    print(f"(c) scene: {N_TRAIN} train + {N_TEST} held-out views at "
          f"{RES}x{RES}, generated in {time.perf_counter() - t0:.1f} s")
    check_ray_dirs(ds, seed)
    cfg = load_network_config(CONFIG)
    tr = NerfTrainer(ds, cfg, seed=seed, tcfg=NerfTrainerConfig(**TRAIN_CFG))
    tc = tr.tcfg
    print(f"(c) NerfTrainer base.json: target_batch_size={tc.target_batch_size}"
          f" march_steps={tc.march_steps} n_rays={tc.n_rays}")
    # the second chunk's inputs are the first chunk's (committed) outputs,
    # so it may still compile; the third is timed
    train_chunks(tr, card, "(c)", 3)
    mem = chunk_memory(tr)
    print("(c) chunk memory_analysis: "
          f"arguments {mem.argument_size_in_bytes / 2**20:.1f} MiB, "
          f"outputs {mem.output_size_in_bytes / 2**20:.1f} MiB, "
          f"temps {mem.temp_size_in_bytes / 2**20:.1f} MiB, "
          f"aliased {mem.alias_size_in_bytes / 2**20:.1f} MiB")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"(c) device peak_bytes_in_use "
          f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB [{card}]")
    return tr, test_xfs, test_imgs, fl


# ---------------------------------------------------------------------------
# (d) rendering
# ---------------------------------------------------------------------------

def psnr_srgb(pred, gt):
    from ngp_jax.common import linear_to_srgb_np
    a = linear_to_srgb_np(np.clip(pred[..., :3], 0, 1))
    b = linear_to_srgb_np(np.clip(gt[..., :3], 0, 1))
    return -10 * math.log10(max(float(np.mean((a - b) ** 2)), 1e-10))


def check_image(name, img, shape):
    if img.shape != shape:
        raise AssertionError(f"{name}: shape {img.shape} != {shape}")
    if not np.isfinite(img).all():
        raise AssertionError(f"{name}: non-finite pixels")
    if not float(img[..., :3].std()) > 0:
        raise AssertionError(f"{name}: constant image")


def phase_render(tr, test_xfs, test_imgs, fl, card):
    from ngp_jax.opt.optimizers import inference_params
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
    params = inference_params(tr.params, tr.opt_state, tr.opt_cfg)
    renderer = NerfRenderer.for_trainer(tr, RenderOptions(
        background=(0.0, 0.0, 0.0, 0.0), linear_out=True,
        march_steps=tr.tcfg.march_steps))
    xf = test_xfs[0]
    img = renderer.render(params, tr.grid.bitfield, xf, RES, RES,
                          focal=(fl, fl))
    check_image("held-out view", img, (RES, RES, 4))
    print(f"(d) held-out view {RES}x{RES}: PSNR "
          f"{psnr_srgb(img, test_imgs[0]):.2f} dB vs analytic ground truth "
          f"({tr.training_step} training steps)")
    W, H = 1920, 1080
    f_hd = fl * H / RES
    renderer.render(params, tr.grid.bitfield, xf, W, H, focal=(f_hd, f_hd))
    t0 = time.perf_counter()
    frame = renderer.render(params, tr.grid.bitfield, xf, W, H,
                            focal=(f_hd, f_hd))
    ms = 1e3 * (time.perf_counter() - t0)
    check_image("1080p frame", frame, (H, W, 4))
    print(f"(d) 1920x1080 frame: {ms:.1f} ms (second call, to host) [{card}]")


# ---------------------------------------------------------------------------
# --four: data parallelism over 4 cards
# ---------------------------------------------------------------------------

def phase_four(seed, label):
    from ngp_jax.dist.mesh import make_mesh
    from ngp_jax.dist.nerf_dp import (DpNerfTrainer, make_dp_train_step,
                                      null_error_state)
    from ngp_jax.train.nerf import NerfTrainerConfig
    devs = jax.devices()[:4]
    mesh = make_mesh(n_data=4, devices=devs)
    ds, _, _, _ = make_scene(seed)
    cfg = load_network_config(CONFIG)
    dtr = DpNerfTrainer(ds, cfg, mesh, seed=seed,
                        tcfg=NerfTrainerConfig(**TRAIN_CFG))
    print(f"(dp) DpNerfTrainer data=4, per device n_rays="
          f"{dtr.tcfg.n_rays} target_batch_size="
          f"{dtr.tcfg.target_batch_size} march_steps={dtr.tcfg.march_steps}")
    # the second chunk's inputs are the first chunk's mesh-replicated
    # outputs, so it may still compile; the third is timed
    train_chunks(dtr, label, "(dp)", 3)

    # one DP step == four single-device steps on the per-device keys,
    # with the loss re-normalized by the global ray count
    tr = dtr._impl
    R, S = tr.tcfg.n_rays, tr.tcfg.target_batch_size
    err, key = null_error_state(), jax.random.PRNGKey(seed + 7)
    state = (tr.params, tr.opt_state, tr.cam_params, tr.cam_m, tr.cam_v,
             tr.error_map, tr.sharpness_grid)
    grid = (tr.grid.bitfield, tr.grid.coarse, tr.grid.mean)
    step = make_dp_train_step(tr, mesh, n_rays_per_device=R,
                              samples_per_device=S)
    with mesh:
        loss_dp = float(step(*state, err, *grid, key, tr.data)[-1])
    single = jax.jit(lambda *a: tr._train_step_impl(
        *a, n_rays=R, capacity=S)[7])
    local = jax.device_put((state, grid, tr.data), devs[0])
    num = den = 0.0
    for i in range(4):
        st = single(*local[0], err, *local[1],
                    jax.random.fold_in(key, i), local[2])
        n_i = float(st.n_rays_with_samples)
        num += float(st.loss) * n_i
        den += n_i
    loss_single = num / den
    print(f"(dp) one step: DP(4) loss {loss_dp:.7f}, four single-device "
          f"steps {loss_single:.7f}")
    # same per-device arithmetic, but two programs: where XLA contracts
    # multiply-adds differently, a lattice point within rounding of an
    # occupancy-cell or AABB boundary can be kept by one and dropped by
    # the other, and the scatter-adds sum in other orders. On the card
    # the difference varied from run to run, up to 9e-4 relative; a wrong
    # ray stream or normalization moves the loss by far more.
    check_close("DP(4) loss vs single device", loss_dp, loss_single,
                atol=0.0, rtol=5e-3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the data-parallel path on 4 cards")
    args = ap.parse_args()
    cards = phase_device(4 if args.four else 1)
    card = cards[0]
    if args.four:
        phase_four(args.seed, " | ".join(cards[:4]))
    else:
        phase_encode(args.seed, card)
        tr, test_xfs, test_imgs, fl = phase_train(args.seed, card)
        phase_render(tr, test_xfs, test_imgs, fl, card)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
