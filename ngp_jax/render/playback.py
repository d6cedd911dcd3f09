"""Frozen-model playback: bake a trained NeRF into a dense cascaded
voxel cache and render camera paths from it at interactive rates.

The reference renders trained scenes "in tens of milliseconds at
1920x1080" (ref: docs/index.html:317) by pointing its CUDA megakernel at
the live network. The playback path instead trades one bake pass for
gather-free frames:

  * BAKE: evaluate the trained field once on a dense D^3 lattice per
    occupancy cascade (sigma + sigma-premultiplied rgb), masked by the
    occupancy bitfield, into (D, D, D, 4) bf16 volumes.
  * RENDER: perspective slice compositing with NO per-sample gathers.
    Rays are reparameterized by their intersection (p, q) with a fixed
    reference plane perpendicular to the dominant view axis; on that
    parameterization the map from ray space to each volume slice z_k is
    a pure per-slice scale+translate (the shear-warp factorization,
    Lacroute & Levoy '94, perspective variant), so resampling every
    slice onto the ray grid is TWO SMALL MATMULS (one interpolation
    matrix per axis, built on the fly from iota math).
    Slices composite front-to-back under a lax.scan in blocks of ``zb``
    (one carry round-trip per block, not per slice); nested cascades
    composite exactly via a per-ray front/back split at the inner
    cube's entry/exit times. The only gather in the whole frame is the
    final 2D ray-grid -> screen warp (4 taps/pixel), which also absorbs
    lens distortion for free.

Device-memory traffic per frame is the volumes once plus one ray-grid
tile per slice block, and almost every FLOP is a matmul. Whether this
beats a direct trilinear march on the H100 has not been measured.
Supported camera model: pinhole + OpenCV distortion
(the fox eval protocol); DoF / rolling-shutter playback falls back to
the live renderer.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.common import srgb_to_linear_np
from ngp_jax.grid import occupancy as occ
from ngp_jax.rays.camera import (iterative_opencv_undistort,
                                 ray_aabb_intersect)


class PlaybackCache(NamedTuple):
    """Baked radiance/density volumes, one per occupancy cascade.

    vols[c] has shape (Dz, Dy, Dx, 4) = [r*sigma, g*sigma, b*sigma,
    sigma] (sigma-premultiplied so trilinear interpolation near
    occupancy boundaries is a density-weighted color average instead of
    a bleed toward black), covering the cube centered at 0.5 with side
    2^c (the occupancy cascade convention, ref: mip_from_pos /
    src/testbed_nerf.cu grid cascades). The region covered by a finer
    cascade keeps its values — the renderer's per-ray front/back split
    excludes that t-interval exactly, and live boundary values keep the
    trilinear taps at cascade seams correct.

    With ``sh_degree`` >= 1 the color channels hold sigma-premultiplied
    SPHERICAL-HARMONIC coefficients instead of a single diffuse rgb:
    channels [c_0 rgb, c_1 rgb, ..., sigma] with rgb(d) = sum_b c_b
    Y_b(d) (the plenoxels-style distillation of the MLP's view
    dependence — a single-direction bake misrenders surfaces whose
    training-dir coverage is narrow, e.g. fox's walls).
    """
    vols: tuple            # per-cascade (D, D, D, 3B+1) arrays
    sides: tuple           # per-cascade world cube side (2^c)
    sh_degree: int = 0     # 0 = diffuse (B=1), L -> B=(L+1)^2 coeffs


def sh_basis(dirs: np.ndarray, degree: int) -> np.ndarray:
    """Real spherical harmonics up to degree 2 evaluated at unit dirs
    (..., 3) → (..., (degree+1)^2). Standard constants."""
    x, y, zc = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [np.full_like(x, 0.282095)]
    if degree >= 1:
        out += [0.488603 * y, 0.488603 * zc, 0.488603 * x]
    if degree >= 2:
        out += [1.092548 * x * y, 1.092548 * y * zc,
                0.315392 * (3 * zc * zc - 1.0),
                1.092548 * x * zc,
                0.546274 * (x * x - y * y)]
    if degree >= 3:
        raise ValueError("sh_degree <= 2 supported")
    return np.stack(out, -1).astype(np.float32)


def _fibonacci_dirs(m: int) -> np.ndarray:
    i = np.arange(m, dtype=np.float64) + 0.5
    phi = np.pi * (1 + 5 ** 0.5) * i
    z = 1 - 2 * i / m
    r = np.sqrt(np.maximum(1 - z * z, 0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    -1).astype(np.float32)


def _cascade_lattice(D: int, side: float) -> np.ndarray:
    """World-space voxel-center coordinates (1D per axis) of a cascade
    cube (centered at 0.5, side ``side``)."""
    lo = 0.5 - side / 2
    return (lo + (np.arange(D, dtype=np.float64) + 0.5)
            * (side / D)).astype(np.float32)


def bake_playback_cache(trainer, D: int = 256, D_inner: Optional[int] = None,
                        params=None, ref_eye=None, batch: int = 1 << 17,
                        extra=None, sh_degree: int = 0,
                        sh_dirs: int = 0) -> PlaybackCache:
    """Evaluate the trained field on dense cascade lattices.

    Only voxels whose occupancy-grid cell bit is set are evaluated (the
    rest stay zero) — on typical scenes that is a few percent of the
    lattice, so even a 512^3 inner cascade bakes in seconds of device
    time. View-dependence: ``sh_degree`` 0 bakes diffuse rgb toward
    ``ref_eye`` (default: the mean training-camera position); degree
    L >= 1 least-squares fits (L+1)^2 spherical-harmonic coefficients
    from ``sh_dirs`` (default 2x the basis size) Fibonacci directions —
    the distillation that survives narrow training-dir coverage.
    """
    from ngp_jax.opt.optimizers import inference_params
    if params is None:
        params = inference_params(trainer.params, trainer.opt_state,
                                  trainer.opt_cfg)
    nearest_cams = None
    if isinstance(ref_eye, str) and ref_eye == "nearest":
        # per-voxel direction toward the NEAREST training camera: always
        # an in-distribution viewing direction (a single mean eye
        # extrapolates the MLP's dir response at poorly-covered surfaces)
        nearest_cams = jnp.asarray(
            np.asarray(trainer.dataset.xforms)[:, :3, 3])
        ref_eye = np.asarray(trainer.dataset.xforms)[:, :3, 3].mean(0)
    if ref_eye is None:
        ref_eye = np.asarray(trainer.dataset.xforms)[:, :3, 3].mean(0)
    ref_eye = np.asarray(ref_eye, np.float32)
    bitfield = np.asarray(trainer.grid.bitfield)
    n_casc = trainer.max_cascade + 1
    aabb_min = np.float32(trainer.aabb_min)
    aabb_size = np.float32(trainer.aabb_size)

    eye_dev = jnp.asarray(ref_eye)
    B = (sh_degree + 1) ** 2 if sh_degree else 1
    if sh_degree:
        M = sh_dirs or max(2 * B, 12)
        dirs_m = _fibonacci_dirs(M)                       # (M, 3)
        Y = sh_basis(dirs_m, sh_degree)                   # (M, B)
        pinv = jnp.asarray(np.linalg.pinv(Y))             # (B, M)
        dirs_dev = jnp.asarray(dirs_m)

    @functools.partial(jax.jit, static_argnums=(1,))
    def eval_batch(idx, Dc, ax_dev, side):
        # positions derived ON DEVICE from int32 voxel ids — a tenth of
        # the host→device bytes of shipping f32 pos+dirs
        iz = idx // (Dc * Dc)
        iy = (idx // Dc) % Dc
        ix = idx % Dc
        pos = jnp.stack([ax_dev[ix], ax_dev[iy], ax_dev[iz]], -1)
        pos01 = (pos - aabb_min) / aabb_size
        n = pos.shape[0]
        if sh_degree:
            # rgb at M directions -> least-squares SH coefficients
            outs = []
            for m in range(dirs_dev.shape[0]):
                dm = jnp.broadcast_to(dirs_dev[m], (n, 3))
                rgb_m, sigma = trainer.model.rgb_sigma(
                    params, pos01, dm * 0.5 + 0.5, extra=extra)
                outs.append(rgb_m.astype(jnp.float32))
            rgbs = jnp.stack(outs, 1)                     # (n, M, 3)
            coef = jnp.einsum("bm,nmc->nbc", pinv, rgbs)  # (n, B, 3)
            sigma = sigma.astype(jnp.float32)[:, None]
            return jnp.concatenate(
                [coef.reshape(n, 3 * B) * sigma, sigma], -1)
        if nearest_cams is not None:
            d2 = ((pos[:, None, :] - nearest_cams[None]) ** 2).sum(-1)
            eye_v = nearest_cams[jnp.argmin(d2, axis=1)]
        else:
            eye_v = eye_dev[None]
        d = pos - eye_v
        d = d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)
        rgb, sigma = trainer.model.rgb_sigma(params, pos01,
                                             d * 0.5 + 0.5, extra=extra)
        rgb = rgb.astype(jnp.float32)
        sigma = sigma.astype(jnp.float32)[:, None]
        return jnp.concatenate([rgb * sigma, sigma], -1)

    vols, sides = [], []
    d_list = list(D) if isinstance(D, (list, tuple)) else None
    for c in range(n_casc):
        side = float(2.0 ** c)
        if d_list is not None:
            Dc = d_list[min(c, len(d_list) - 1)]
        else:
            Dc = D_inner if (c == 0 and D_inner) else D
        ax = _cascade_lattice(Dc, side)
        # occupancy ownership per voxel: its 128^3 cell bit at mip c
        # small dtypes + per-axis factorization: a naive (Dc,Dc,Dc) int64
        # broadcast at Dc=512 allocates multiple 1 GB temps and swaps the
        # single-core host for minutes
        cell = np.minimum((np.arange(Dc, dtype=np.uint32)
                           * occ.NERF_GRIDSIZE) // Dc,
                          occ.NERF_GRIDSIZE - 1)
        lvl = bitfield[c * (occ.GRID_VOLUME // 8):
                       (c + 1) * (occ.GRID_VOLUME // 8)]
        half = (cell >> 1).astype(np.uint32)
        byte = ((half[:, None, None] * occ.GH
                 + half[None, :, None]) * occ.GH
                + half[None, None, :])                         # (z, y, x)
        par = (cell & 1).astype(np.uint8)
        bit = (par[None, None, :] | (par[None, :, None] << 1)
               | (par[:, None, None] << 2))
        occ_mask = (lvl[byte] >> bit) & 1 > 0
        del byte, bit
        # NOTE: voxels inside the finer cascade's cube are KEPT (not
        # zeroed): the renderer's per-ray front/back split already
        # excludes the inner t-interval exactly, and live boundary
        # values make trilinear taps near the cascade seam correct
        # instead of bleeding to zero (a half-voxel dark band otherwise)
        idx = np.nonzero(occ_mask.reshape(-1))[0]
        C = 3 * B + 1
        vol = np.zeros((Dc * Dc * Dc, C), np.float32)
        if idx.size:
            ax_dev = jnp.asarray(ax)
            handles = []          # enqueue ALL batches, fetch afterwards
            for s in range(0, idx.size, batch):
                ib = idx[s:s + batch].astype(np.int32)
                n = ib.shape[0]
                if n < batch:
                    # pad the tail to the static batch shape: every
                    # distinct shape is a fresh XLA compile
                    ib = np.concatenate(
                        [ib, np.zeros(batch - n, np.int32)])
                handles.append((n, eval_batch(
                    jnp.asarray(ib), Dc, ax_dev, np.float32(side))))
            vol[idx] = np.concatenate(
                [np.asarray(h)[:n] for n, h in handles], 0)
        vols.append(jnp.asarray(vol.reshape(Dc, Dc, Dc, C), jnp.bfloat16))
        sides.append(side)
    return PlaybackCache(vols=tuple(vols), sides=tuple(sides),
                         sh_degree=sh_degree)


def save_playback_cache(path: str, cache: PlaybackCache):
    np.savez_compressed(path, n=len(cache.vols),
                        sides=np.asarray(cache.sides, np.float32),
                        sh_degree=int(cache.sh_degree),
                        **{f"vol{i}": np.asarray(v, np.float32)
                           for i, v in enumerate(cache.vols)})


def load_playback_cache(path: str) -> PlaybackCache:
    z = np.load(path)
    n = int(z["n"])
    return PlaybackCache(
        vols=tuple(jnp.asarray(z[f"vol{i}"], jnp.bfloat16)
                   for i in range(n)),
        sides=tuple(float(s) for s in z["sides"]),
        sh_degree=int(z["sh_degree"]) if "sh_degree" in z else 0)


@dataclass(frozen=True)
class PlaybackOptions:
    width: int = 1920
    height: int = 1080
    background: tuple = (0.0, 0.0, 0.0, 0.0)
    linear_out: bool = True
    principal: tuple = (0.5, 0.5)
    lens_params: tuple = (0.0, 0.0, 0.0, 0.0)
    lens_mode: str = "auto"        # auto | perspective | opencv
    # ray-grid (intermediate image) resolution relative to the screen;
    # outer cascades composite at a coarser grid (their content is 2x+
    # coarser per voxel anyway) and are upsampled onto the fine grid
    int_scale: float = 1.0
    outer_int_scale: float = 0.5
    # slices composited per scan step: one carry round-trip per block
    zb: int = 8
    # minimum z'-component of the unit ray direction along the dominant
    # axis; rays below it (extreme off-axis) see background only
    min_dz: float = 0.05
    t_start_min: float = 0.05      # near clip (matches the live renderer)



@functools.partial(jax.jit, static_argnums=())
def _frame_angles(d_cam, M, min_dz):
    """Per-frame ray angles on device: d_cam (HW,3) camera dirs, M (3,3)
    rotation+permutation+flip. Returns ab (HW,2) angle coords, dz_ok
    (HW,), and [amin, amax, bmin, bmax]."""
    d_p = jnp.matmul(d_cam, M.T, precision="highest")
    d_p = d_p / (jnp.linalg.norm(d_p, axis=-1, keepdims=True) + 1e-9)
    dz_ok = d_p[:, 2] > min_dz
    safe = jnp.where(dz_ok, d_p[:, 2], 1.0)
    ab = jnp.stack([jnp.arctan(d_p[:, 0] / safe),
                    jnp.arctan(d_p[:, 1] / safe)], -1)
    big = jnp.float32(1e9)
    a = jnp.where(dz_ok, ab[:, 0], big)
    b = jnp.where(dz_ok, ab[:, 1], big)
    rng = jnp.stack([a.min(), jnp.where(dz_ok, ab[:, 0], -big).max(),
                     b.min(), jnp.where(dz_ok, ab[:, 1], -big).max()])
    return ab, dz_ok, rng


def _sh_basis_jnp(d, degree):
    x, y, zc = d[..., 0], d[..., 1], d[..., 2]
    out = [jnp.full_like(x, 0.282095)]
    if degree >= 1:
        out += [0.488603 * y, 0.488603 * zc, 0.488603 * x]
    if degree >= 2:
        out += [1.092548 * x * y, 1.092548 * y * zc,
                0.315392 * (3 * zc * zc - 1.0),
                1.092548 * x * zc,
                0.546274 * (x * x - y * y)]
    return jnp.stack(out, 0)


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _grid_setup(prange, qrange, e, P, Q, degree, has_inner, S, s_in):
    """Per-cascade grid-ray geometry on device: inner-cube entry/exit
    t per grid ray + SH basis from world dirs (S maps permuted dirs to
    world dirs)."""
    ag = prange[0] + (jnp.arange(P, dtype=jnp.float32) + 0.5) * prange[1]
    bg = qrange[0] + (jnp.arange(Q, dtype=jnp.float32) + 0.5) * qrange[1]
    rx = jnp.broadcast_to(jnp.tan(ag)[None, :], (Q, P))
    ry = jnp.broadcast_to(jnp.tan(bg)[:, None], (Q, P))
    nrm = jnp.sqrt(rx * rx + ry * ry + 1.0)
    d_p = jnp.stack([rx / nrm, ry / nrm, 1.0 / nrm], -1)   # (Q, P, 3)
    if has_inner:
        lo = 0.5 - s_in / 2
        hi = 0.5 + s_in / 2
        t0x, t1x = ray_aabb_intersect(
            jnp.broadcast_to(e, (Q, P, 3)), d_p,
            jnp.stack([lo, lo, lo]), jnp.stack([hi, hi, hi]))
        miss = t0x > t1x
        t_in = jnp.where(miss, jnp.inf, t0x)
        t_out = jnp.where(miss, jnp.inf, t1x)
    else:
        t_in = jnp.full((Q, P), jnp.inf, jnp.float32)
        t_out = t_in
    if degree:
        d_w = jnp.einsum("ij,qpj->qpi", S, d_p, precision="highest")
        basis = _sh_basis_jnp(d_w, degree)                 # (B, Q, P)
    else:
        basis = jnp.ones((1, Q, P), jnp.float32)
    return t_in, t_out, basis


# axis permutations: _PERMS[a] = world axes taking the (x', y', z') slots
# when world axis ``a`` is the dominant (z') one
_PERMS = ((2, 1, 0), (0, 2, 1), (0, 1, 2))


class PlaybackRenderer:
    """Camera-path renderer over a PlaybackCache (see module docstring).

    One jitted slice-compositing program per (cascade size, ray-grid
    size) is reused across frames and cascades; volumes pre-permuted /
    flipped per dominant view axis are cached (a camera path changes
    its dominant axis rarely).
    """

    def __init__(self, cache: PlaybackCache, opts: PlaybackOptions):
        self.cache = cache
        self.opts = opts
        self._vol_cache = {}
        self._program_cache = {}

    # -- per-frame host-side setup ------------------------------------

    def _screen_dirs(self, W, H, fx, fy):
        """(H*W, 3) camera-space ray directions incl. lens distortion,
        cached per intrinsics (snap-to-pixel-centers — the eval
        protocol's deterministic sampling, ref: scripts/run.py:228-241).
        Returned as a DEVICE array; all per-frame camera math runs on
        device (host numpy at 2M pixels per frame is the slower path)."""
        key = ("dirs", W, H, float(fx), float(fy))
        hit = self._vol_cache.get(key)
        if hit is not None:
            return hit
        o = self.opts
        cx, cy = o.principal
        px = (np.arange(W, dtype=np.float32) + 0.5) / W
        py = (np.arange(H, dtype=np.float32) + 0.5) / H
        u, v = np.meshgrid(px, py)
        dx = (u - cx) * W / fx
        dy = (v - cy) * H / fy
        mode = o.lens_mode
        if mode == "auto":
            mode = "opencv" if any(abs(p) > 0 for p in o.lens_params[:4]) \
                else "perspective"
        if mode == "opencv":
            k1, k2, p1, p2 = o.lens_params[:4]
            dx, dy = iterative_opencv_undistort(
                jnp.asarray(dx.ravel()), jnp.asarray(dy.ravel()),
                k1, k2, p1, p2)
            dx, dy = np.asarray(dx), np.asarray(dy)
        out = jax.device_put(np.stack(
            [np.ravel(dx).astype(np.float32),
             np.ravel(dy).astype(np.float32),
             np.ones(H * W, np.float32)], -1))
        self._vol_cache[key] = out
        return out

    def _get_vol(self, ci, axis, flip):
        key = (ci, axis, flip)
        if key not in self._vol_cache:
            v = self.cache.vols[ci]
            perm = _PERMS[axis]
            # storage is (worldZ, worldY, worldX, 4); the program wants
            # CHANNEL-SECOND (z', 4, y', x')
            t = (2 - perm[2], 3, 2 - perm[1], 2 - perm[0])
            v = jnp.transpose(v, t)          # (z', C, y', x')
            if flip:
                v = v[::-1]
            self._vol_cache[key] = jax.device_put(v)
        return self._vol_cache[key]

    # -- the jitted compositing program --------------------------------

    def _program(self, D, P, Q, zb, C):
        key = (D, P, Q, zb, C)
        if key in self._program_cache:
            return self._program_cache[key]
        t_near = float(self.opts.t_start_min)
        B = (C - 1) // 3

        def run(vol, zs, e, prange, qrange, side, t_in, t_out, basis):
            """Composite one cascade onto the (Q, P) ray grid.

            vol     (D, 4, D, D)  channel-second slabs, t-ascending z'
            zs      (D,)          z' of each slab center (ascending)
            e       (3,)          eye in permuted (flip-normalized) coords
            prange  (2,)          [alpha_min, d_alpha] of the ray grid
            qrange  (2,)          [beta_min, d_beta]
            side    ()            cascade cube side
            t_in/t_out (Q, P)     inner-cube entry/exit per ray
                                  (+inf => innermost: everything front)
            basis   (B, Q, P)     per-ray SH basis values (ones for
                                  diffuse caches)
            Returns (rgb_f (3,Q,P), od_f (Q,P), rgb_b, od_b).
            """
            # ANGLE-uniform ray grid: grid cell i holds the ray with
            # tan(alpha_i) slope along x'. A plane-uniform grid blows up
            # as 1/d_z for oblique rays (fox's 53-degree half-FOV maps
            # the frame to |pq| up to ~80 while the content sits in
            # |pq|~2, collapsing effective resolution); the two-matmul
            # resample only needs SEPARABILITY x(i,k), y(j,k) — not an
            # affine map — so tan() grids cost nothing.
            alpha = prange[0] + (jnp.arange(P, dtype=jnp.float32) + 0.5) \
                * prange[1]
            beta = qrange[0] + (jnp.arange(Q, dtype=jnp.float32) + 0.5) \
                * qrange[1]
            rx = jnp.tan(alpha)[None, :]                       # (1, P)
            ry = jnp.tan(beta)[:, None]                        # (Q, 1)
            norm = jnp.sqrt(rx * rx + ry * ry + 1.0)           # (Q, P)
            vox = side / D
            dt_img = vox * norm                                # (Q, P)

            def block(carry, xs):
                rgb_f, od_f, rgb_b, od_b = carry
                slabs, z_blk = xs               # (zb, C, D, D), (zb,)
                # per-slice separable map onto the ray grid, as two
                # interpolation matmuls
                h_k = (z_blk - e[2])                           # (zb,)
                xs_w = e[0] + rx[0][None, :] * h_k[:, None]
                ys_w = e[1] + ry[:, 0][None, :] * h_k[:, None]
                lo = 0.5 - side / 2
                ux = (xs_w - lo) / vox - 0.5                   # (zb, P)
                uy = (ys_w - lo) / vox - 0.5                   # (zb, Q)

                def weights(u, n_in):
                    j = jnp.arange(n_in, dtype=jnp.float32)
                    w = 1.0 - jnp.abs(u[..., None] - j)
                    return jnp.clip(w, 0.0, 1.0).astype(jnp.bfloat16)

                Wx = weights(ux, D)                            # (zb, P, D)
                Wy = weights(uy, D)                            # (zb, Q, D)
                a = jnp.einsum("kqy,kcyx->kcqx", Wy,
                               slabs.astype(jnp.bfloat16),
                               preferred_element_type=jnp.bfloat16)
                smp = jnp.einsum("kpx,kcqx->kcqp", Wx, a,
                                 preferred_element_type=jnp.float32)
                # composite the zb sub-slices front-to-back (elementwise
                # chain, fused by XLA into one pass over the block)
                for i in range(zb):
                    t_k = (z_blk[i] - e[2]) * norm             # (Q, P)
                    sig = jnp.maximum(smp[i, C - 1], 0.0)
                    cols = smp[i, :3 * B].reshape(B, 3, Q, P)
                    rgb_k = jnp.maximum(
                        (cols * basis[:, None]).sum(0), 0.0) \
                        / jnp.maximum(sig, 1e-9)[None]
                    od_k = sig * dt_img
                    live = t_k > t_near
                    f_m = live & (t_k < t_in)
                    b_m = live & (t_k > t_out)
                    od_kf = jnp.where(f_m, od_k, 0.0)
                    od_kb = jnp.where(b_m, od_k, 0.0)
                    w_f = jnp.exp(-od_f) * (1.0 - jnp.exp(-od_kf))
                    w_b = jnp.exp(-od_b) * (1.0 - jnp.exp(-od_kb))
                    rgb_f = rgb_f + w_f[None] * rgb_k
                    rgb_b = rgb_b + w_b[None] * rgb_k
                    od_f = od_f + od_kf
                    od_b = od_b + od_kb
                return (rgb_f, od_f, rgb_b, od_b), None

            zeros3 = jnp.zeros((3, Q, P), jnp.float32)
            zeros1 = jnp.zeros((Q, P), jnp.float32)
            carry, _ = jax.lax.scan(
                block, (zeros3, zeros1, zeros3, zeros1),
                (vol.reshape(D // zb, zb, C, D, D),
                 zs.reshape(D // zb, zb)))
            return carry

        fn = jax.jit(run)
        self._program_cache[key] = fn
        return fn

    # -- frame driver ---------------------------------------------------

    def render(self, xform, W=None, H=None, focal=None):
        """Render one frame; returns (H, W, 4) float32 (rgb + alpha)."""
        opts = self.opts
        W = W or opts.width
        H = H or opts.height
        if focal is None:
            raise ValueError("focal required")
        fx, fy = (focal, focal) if np.isscalar(focal) else focal
        xf = np.asarray(xform, np.float32).reshape(3, 4)
        e_w = xf[:, 3]
        d_cam = self._screen_dirs(W, H, fx, fy)              # (HW, 3) dev

        fwd = xf[:, 2]
        axis = int(np.argmax(np.abs(fwd)))
        perm = _PERMS[axis]
        flip = bool(fwd[axis] < 0)
        e = e_w[list(perm)].copy()
        if flip:
            # mirror z' -> 1 - z' (cascade cubes are centered at 0.5, so
            # they map onto themselves; volumes are flipped in _get_vol)
            e[2] = 1.0 - e[2]
        # fold world rotation + axis permutation + flip into ONE 3x3:
        # row j of M produces permuted-dir component j
        M = np.asarray(xf[:, :3])[list(perm), :].copy()
        if flip:
            M[2] *= -1.0
        ab, dz_ok, rng = _frame_angles(d_cam, jnp.asarray(M),
                                       np.float32(opts.min_dz))
        pmin, pmax, qmin, qmax = (float(v) for v in np.asarray(rng))

        n_casc = len(self.cache.vols)

        grids = []   # per cascade: (result, P, Q, prange, qrange)
        for ci in range(n_casc):
            D = int(self.cache.vols[ci].shape[0])
            scale = opts.int_scale if ci == 0 else opts.outer_int_scale
            P = max(int(round(W * scale)), 64)
            Q = max(int(round(H * scale)), 64)
            side = self.cache.sides[ci]
            vol = self._get_vol(ci, axis, flip)
            zs = np.ascontiguousarray(_cascade_lattice(D, side))

            prange = np.asarray([pmin, (pmax - pmin) / P], np.float32)
            qrange = np.asarray([qmin, (qmax - qmin) / Q], np.float32)
            # grid-ray geometry (inner-cube split t's, SH basis from
            # world dirs) computed ON DEVICE; S maps permuted dirs back
            # to world axes (transpose of the pure perm/flip part of M)
            S = np.zeros((3, 3), np.float32)
            S[perm[0], 0] = 1.0
            S[perm[1], 1] = 1.0
            S[perm[2], 2] = -1.0 if flip else 1.0
            t_in, t_out, basis = _grid_setup(
                jnp.asarray(prange), jnp.asarray(qrange),
                jnp.asarray(e, jnp.float32), P, Q,
                int(self.cache.sh_degree), ci > 0, jnp.asarray(S),
                jnp.float32(self.cache.sides[ci - 1] if ci else 1.0))

            C = int(vol.shape[1])
            fn = self._program(D, P, Q, opts.zb, C)
            res = fn(vol, jnp.asarray(zs), jnp.asarray(e, jnp.float32),
                     jnp.asarray(prange),
                     jnp.asarray(qrange), jnp.float32(side),
                     t_in, t_out, basis)
            grids.append((res, P, Q, prange, qrange))

        # combine innermost-out on the FINE (cascade-0) ray grid:
        # R_c = F_c OVER (R_{c-1} OVER B_c)
        (rgb0, od0, _, _), P0, Q0, prange0, qrange0 = grids[0]
        comb_rgb, comb_od = rgb0, od0
        for ci in range(1, n_casc):
            (rgb_f, od_f, rgb_b, od_b), P, Q, prange, qrange = grids[ci]
            rgb_f, od_f = _regrid(rgb_f, od_f, prange, qrange,
                                  prange0, qrange0, P0, Q0)
            rgb_b, od_b = _regrid(rgb_b, od_b, prange, qrange,
                                  prange0, qrange0, P0, Q0)
            inner_rgb = comb_rgb + jnp.exp(-comb_od)[None] * rgb_b
            inner_od = comb_od + od_b
            comb_rgb = rgb_f + jnp.exp(-od_f)[None] * inner_rgb
            comb_od = od_f + inner_od

        img = _warp_to_screen(comb_rgb, comb_od, jnp.asarray(prange0),
                              jnp.asarray(qrange0), P0, Q0,
                              jnp.asarray(ab), jnp.asarray(dz_ok),
                              jnp.asarray(opts.background, jnp.float32),
                              H, W)
        img = np.asarray(img, np.float32)
        # the baked rgb lives in the MODEL'S composite space — sRGB
        # unless the trainer used train_in_linear_colors (the reference
        # trains against sRGB targets); linear_out converts the
        # composite exactly like the live renderer does
        # (nerf_render.py:1176). Skipping this double-applies the sRGB
        # curve downstream and brightens dark regions catastrophically
        # (fox: 13.6 dB of the playback-vs-live gap).
        if opts.linear_out:
            img = np.concatenate(
                [srgb_to_linear_np(np.clip(img[..., :3], 0.0, None)),
                 img[..., 3:4]], -1)
        return img


@functools.partial(jax.jit, static_argnums=(6, 7))
def _regrid(rgb, od, prange_s, qrange_s, prange_d, qrange_d, P, Q):
    """Bilinearly resample a (rgb (3,Q,P), od (Q,P)) ray grid onto
    another grid of the same ray parameterization (different resolution)
    — two interpolation matmuls, the same trick as the slices."""
    Qs, Ps = rgb.shape[1], rgb.shape[2]
    pd = prange_d[0] + (jnp.arange(P, dtype=jnp.float32) + 0.5) \
        * prange_d[1]
    qd = qrange_d[0] + (jnp.arange(Q, dtype=jnp.float32) + 0.5) \
        * qrange_d[1]
    up = (pd - prange_s[0]) / prange_s[1] - 0.5
    uq = (qd - qrange_s[0]) / qrange_s[1] - 0.5
    Wp = jnp.clip(1.0 - jnp.abs(
        up[:, None] - jnp.arange(Ps, dtype=jnp.float32)), 0, 1)
    Wq = jnp.clip(1.0 - jnp.abs(
        uq[:, None] - jnp.arange(Qs, dtype=jnp.float32)), 0, 1)
    # renormalize edge rows (clip would otherwise dim the borders)
    Wp = Wp / jnp.maximum(Wp.sum(-1, keepdims=True), 1e-9)
    Wq = Wq / jnp.maximum(Wq.sum(-1, keepdims=True), 1e-9)
    x = jnp.concatenate([rgb, od[None]], 0)                  # (4, Qs, Ps)
    a = jnp.einsum("qy,cyp->cqp", Wq, x)
    b = jnp.einsum("px,cqx->cqp", Wp, a)
    return b[:3], b[3]


@functools.partial(jax.jit, static_argnums=(4, 5, 9, 10))
def _warp_to_screen(rgb, od, prange, qrange, P, Q, pq, dz_ok, bg, H, W):
    """Bilinear ray-grid -> screen warp + background composite (the one
    gather of the frame: 4 taps/pixel)."""
    u = (pq[:, 0] - prange[0]) / prange[1] - 0.5
    v = (pq[:, 1] - qrange[0]) / qrange[1] - 0.5
    u = jnp.clip(u, 0.0, P - 1.0)
    v = jnp.clip(v, 0.0, Q - 1.0)
    u0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, P - 2)
    v0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, Q - 2)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    # one transpose of the small final grid so the gather reads (N, 4)
    # rows (the hot loop stays channel-first)
    x = jnp.concatenate([rgb, od[None]], 0).transpose(1, 2, 0)
    x = x.reshape(Q * P, 4)
    i00 = v0 * P + u0
    g = (jnp.take(x, i00, axis=0) * (1 - fu) * (1 - fv)
         + jnp.take(x, i00 + 1, axis=0) * fu * (1 - fv)
         + jnp.take(x, i00 + P, axis=0) * (1 - fu) * fv
         + jnp.take(x, i00 + P + 1, axis=0) * fu * fv)
    od_s = jnp.where(dz_ok, g[:, 3], 0.0)
    T = jnp.exp(-od_s)
    rgb_s = jnp.where(dz_ok[:, None], g[:, :3], 0.0) \
        + T[:, None] * bg[None, :3]
    return jnp.concatenate([rgb_s, (1.0 - T)[:, None]],
                           -1).reshape(H, W, 4)
