"""Single-NeRF renderer.

Equivalent of the reference's NerfTracer pipeline
(ref: src/testbed_nerf.cu:2047-2500: init_rays_from_camera → trace →
composite → shade). Instead of the iterative compact-march-infer loop with
a host-synced alive counter, each pixel chunk is rendered with the same
closed-form lattice + occupancy filter + compaction as training, then one
batched network call and a segmented composite. Network output space is
sRGB (logistic activation); compositing happens there and the background
is blended with remaining transmittance, matching the training-time math.

Round-2 rework (ref parity + throughput): pixel/ray generation and the
spp accumulation run device-side (per-pixel jitter per sample like the
reference's LD pixel offsets, ref: common_device.cuh:260-317), with
per-ray rolling-shutter/motion-blur camera interpolation
(ref: get_xform_given_rolling_shutter, common_device.cuh:224-234),
thin-lens depth of field (ref: pixel_to_ray aperture branch), a render
AABB crop (ref: m_render_aabb), Mask3D alpha modulation and envmap
background (ref: composite_kernel_nerf :767-989), and the Slice /
EncodingVis render modes (ref: :2412-2476).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.common import RenderMode, TonemapCurve, srgb_to_linear
from ngp_jax.grid import occupancy as occupancy_mod
from ngp_jax.rays.camera import ray_aabb_intersect, xform_slerp
from ngp_jax.rays.marching import (compact_samples, composite_samples,
                                   march_rays, march_rays_hier,
                                   merge_excess_samples)
from ngp_jax.render.buffer import tonemap


@dataclasses.dataclass
class RenderOptions:
    width: int = 1080
    height: int = 1920
    fov_axis_focal: float = 1375.0       # focal length in pixels (x)
    focal_y: Optional[float] = None
    principal: tuple = (0.5, 0.5)
    spp: int = 1
    render_mode: RenderMode = RenderMode.SHADE
    lens_params: tuple = (0.0, 0.0, 0.0, 0.0)   # OpenCV k1 k2 p1 p2
    background: tuple = (0.0, 0.0, 0.0, 0.0)
    linear_out: bool = True              # return linear RGB (like run.py eval)
    min_transmittance: float = 1e-4
    # rays per chunk: bounds the (chunk, march_steps) march lattice each
    # scan step materializes. Not measured on the H100.
    chunk: int = 1 << 14
    # max pixel chunks per jitted dispatch. Not measured on the H100.
    dispatch_chunks: int = 16
    march_steps: int = 1024
    samples_per_chunk_factor: int = 48   # per-ray sample cap per segment
    march_segments: int = 4              # early-out granularity
    # thin-lens DoF (ref: pixel_to_ray aperture, common_device.cuh:260-317)
    aperture_size: float = 0.0
    focus_z: float = 1.0
    # crop box (ref: m_render_aabb); None → full training AABB
    render_aabb_min: Optional[tuple] = None
    render_aabb_max: Optional[tuple] = None
    exposure: float = 0.0
    tonemap_curve: TonemapCurve = TonemapCurve.IDENTITY
    snap_to_pixel_centers: bool = False  # eval protocol (ref run.py:228-241)
    # VR / lenticular quilting + parallax head shift
    # (ref: apply_quilting common_device.cuh:541-560; pixel_to_ray
    # parallax handling :302-306). quilting_dims (2,1) = stereo VR
    # (parallax_shift.x = IPD); larger grids = HoloPlay view fans.
    parallax_shift: tuple = (0.0, 0.0, 0.0)
    quilting_dims: tuple = (1, 1)
    slice_plane_z: float = 0.0           # SLICE mode plane offset
    visualized_level: int = 0            # ENCODING_VIS level
    # density-grid visualization (ref: m_nerf.show_accel, GUI slider −1..7;
    # POSITIONS mode colors each first-hit cell by its mip + cell hash,
    # ref: testbed_nerf.cu:948-957). −1 = off.
    show_accel: int = -1
    # glow bitmask (ref: glow_mode/glow_y_cutoff, composite_kernel_nerf
    # :843-940): 1 green grid, 2 cutline, 4 mask-to-alpha, 8 radial,
    # 16 grid-only
    glow_mode: int = 0
    glow_y_cutoff: float = 0.0
    # lens model for ray generation (ref: ELensMode in pixel_to_ray)
    lens_mode: str = "auto"   # auto|perspective|opencv|ftheta|latlong
    # Wave (live-sample) mode: network evaluation runs on dynamically
    # COUNTED fixed-shape sample blocks instead of the static
    # march_segments × samples_per_chunk_factor slot budget — empty sky
    # and saturated rays stop paying for slots (the reference gets this
    # from its compact-march-infer loop, ref: NerfTracer::trace
    # src/testbed_nerf.cu:2140-2267). Falls back to the static path for
    # the exotic render modes (Slice/EncodingVis/Normals/…).
    wave: bool = False
    wave_cap: int = 64            # per-ray samples per segment (decimated)
    # Fused wave (DEFAULT): collapse the per-chunk segment loop into ONE
    # compact→eval→composite dispatch over the whole ray (per-ray cap =
    # wave_cap × march_segments). In "bulk" sync the per-segment bucket
    # bound is transmittance-FREE, so 4 segment bodies already evaluate
    # the network on exactly the same sample total as one fused body —
    # the segmentation buys nothing but 4× the dispatches, 4× the pow2
    # bucket padding, and 4× the lattice-sized merge/compact overhead.
    # Early-out only helps the "exact" sync mode, which pays a blocking
    # host sync per segment. Fused = one march + one count + one body
    # per chunk. Set False to restore segmented waves.
    wave_fused: bool = True
    # "bulk": ONE count dispatch + ONE host sync per chunk — per-segment
    # stream buckets are sized from the transmittance-free upper bound
    # Σ_rays min(live_r, cap). "exact": one count+sync per SEGMENT with
    # the true post-early-out total (smallest buckets, 8× the host
    # roundtrips).
    wave_sync: str = "bulk"
    # wave-march occupancy filter: "hier" culls 8-step segments on the
    # conservative 16³ coarse mask (built from the bitfield in the same
    # dispatch) before fine bitfield tests — fewer occupancy gathers.
    # Bit-identical to "flat"
    # (march_rays) while the surviving-segment count fits the stream
    # bound; overflow auto-falls back to flat for that chunk.
    wave_march: str = "hier"      # hier | flat
    wave_hier_frac: int = 8       # seg stream bound = R·n_seg/frac
    # Wave dispatch strategy. "device" (DEFAULT): the ENTIRE frame runs
    # in one jitted scan per chunk group — march to a compacted segment
    # stream (march_segment_stream: no (R,K) lattice, closed-form sample
    # times), count live samples, and pick the power-of-2 stream bucket
    # with lax.switch ON DEVICE — zero host syncs on the hot path.
    # "host": per-chunk count fetch sizes the bucket.
    # The reference's equivalent is its single-stream trace loop with one
    # n_alive sync per 8-step round (ref: NerfTracer::trace,
    # src/testbed_nerf.cu:2140-2267).
    wave_dispatch: str = "device"
    # seg stream bound = R·n_seg/frac. 2 holds dense indoor scenes (fox:
    # most inside segments survive the coarse test — frac 4 overflowed
    # every chunk and fell back to the flat lattice)
    wave2_frac: int = 2
    wave2_top_bucket: int = 1 << 18   # largest switch branch; beyond it
    # the per-ray cap is halved on device until the stream fits


class NerfRenderer:
    """Renders frames from a trained NeRF (model+params+occupancy grid)."""

    def __init__(self, model, aabb_min, aabb_size, cone_angle, max_cascade,
                 opts: Optional[RenderOptions] = None, masks=None,
                 envmap_sampler=None, distortion_sampler=None):
        self.model = model
        self.aabb_min = aabb_min
        self.aabb_size = aabb_size
        self.cone_angle = cone_angle
        self.max_cascade = max_cascade
        self.opts = opts or RenderOptions()
        self.masks = masks or []          # list of multi_nerf.Mask3D
        self.envmap_sampler = envmap_sampler  # d_world (N,3) → rgba (N,4)
        self.distortion_sampler = distortion_sampler  # uv (N,2) → (N,2)

    @classmethod
    def for_trainer(cls, trainer, opts: Optional[RenderOptions] = None,
                    **kw):
        return cls(trainer.model, trainer.aabb_min, trainer.aabb_size,
                   trainer.cone_angle, trainer.max_cascade, opts, **kw)

    # ------------------------------------------------------------------
    # device-side ray generation
    # ------------------------------------------------------------------

    def _gen_rays(self, key, pix0, n_rays, W, H, fx, fy, xf_s, xf_e,
                  rshutter, jitter_on, motion):
        """Pixel idx → (o, d) world rays, all on device. Applies per-pixel
        jitter, lens undistortion, rolling-shutter/motion-blur transform
        interpolation and thin-lens DoF."""
        opts = self.opts
        cx, cy = opts.principal
        idx = pix0 + jnp.arange(n_rays, dtype=jnp.int32)
        px = (idx % W).astype(jnp.float32)
        py = (idx // W).astype(jnp.float32)
        ps = jnp.broadcast_to(
            jnp.asarray(opts.parallax_shift, jnp.float32), (n_rays, 3))
        qx, qy = (int(q) for q in opts.quilting_dims)
        We, He = W, H
        if (qx, qy) != (1, 1):
            from ngp_jax.rays.camera import apply_quilting
            px, py, ps = apply_quilting(px, py, (W, H),
                                        opts.parallax_shift,
                                        (qx, qy))
            We, He = W // qx, H // qy
        kj, kt, ka = jax.random.split(key, 3)
        jit = jnp.where(jitter_on, jax.random.uniform(kj, (n_rays, 2)), 0.5)
        u = (px + jit[:, 0]) / We
        v = (py + jit[:, 1]) / He
        lens_mode = opts.lens_mode
        if lens_mode == "auto":
            lens_mode = "opencv" if any(abs(p) > 0 for p in
                                        opts.lens_params[:4]) \
                else "perspective"
        if lens_mode == "latlong":
            from ngp_jax.rays.camera import latlong_to_dir
            d_cam = latlong_to_dir(jnp.stack([u, v], -1))
        elif lens_mode == "ftheta":
            from ngp_jax.rays.camera import f_theta_undistort
            lp = jnp.broadcast_to(
                jnp.asarray(opts.lens_params, jnp.float32), (n_rays, 7))
            d_cam = f_theta_undistort(
                jnp.stack([u - cx, v - cy], -1), lp,
                jnp.asarray([0.0, 0.0, 1.0]))
        else:
            dx = (u - cx) * We / fx
            dy = (v - cy) * He / fy
            if lens_mode == "opencv":
                from ngp_jax.rays.camera import iterative_opencv_undistort
                k1, k2, p1, p2 = opts.lens_params[:4]
                dx, dy = iterative_opencv_undistort(dx, dy, k1, k2, p1, p2)
            d_cam = jnp.stack([dx, dy, jnp.ones_like(dx)], -1)

        if motion:
            # per-ray camera: pixel_t = rs.x + rs.y·u + rs.z·v + rs.w·t
            # (ref: get_xform_given_rolling_shutter)
            time = jax.random.uniform(kt, (n_rays,))
            pixel_t = jnp.clip(rshutter[0] + rshutter[1] * u
                               + rshutter[2] * v + rshutter[3] * time,
                               0.0, 1.0)
            xf = xform_slerp(xf_s, xf_e, pixel_t)            # (N, 3, 4)
        else:
            xf = jnp.broadcast_to(xf_s[None], (n_rays, 3, 4))

        # parallax head shift (ref: pixel_to_ray :302-306): rays originate
        # from the (camera-space) head position and tilt toward it
        head = ps.at[:, 2].set(0.0)
        o_cam = head
        d_cam = d_cam - head * ps[:, 2:3]
        if opts.aperture_size > 0.0:
            # Shirley square→disk (ref: square2disk_shirley)
            ab = jax.random.uniform(ka, (n_rays, 2)) * 2.0 - 1.0
            a, b = ab[:, 0], ab[:, 1]
            cond = jnp.abs(a) > jnp.abs(b)
            r = jnp.where(cond, a, b)
            phi = jnp.where(cond, (jnp.pi / 4) * (b / jnp.where(a == 0, 1, a)),
                            (jnp.pi / 2) - (jnp.pi / 4) *
                            (a / jnp.where(b == 0, 1, b)))
            blur = opts.aperture_size * jnp.stack(
                [r * jnp.cos(phi), r * jnp.sin(phi)], -1)
            lookat = o_cam + d_cam * opts.focus_z
            o_cam = o_cam + jnp.concatenate(
                [blur, jnp.zeros((n_rays, 1))], -1)
            d_cam = (lookat - o_cam) / opts.focus_z

        d_world = jnp.einsum("nij,nj->ni", xf[:, :, :3], d_cam,
                             precision="highest")
        o_world = xf[:, :, 3] + jnp.einsum("nij,nj->ni", xf[:, :, :3], o_cam,
                                           precision="highest")
        d_world = d_world / (jnp.linalg.norm(d_world, axis=-1,
                                             keepdims=True)
                             + 1e-9)
        return o_world, d_world, u, v

    # ------------------------------------------------------------------

    @functools.cached_property
    def _render_chunk(self):
        """Single-chunk jitted entry (kept for tools/tests; ``render``
        dispatches whole frames via ``_frame_fn``)."""
        return functools.partial(
            jax.jit(self._chunk_core,
                    static_argnames=("n_rays", "W", "H", "motion")))

    @functools.cached_property
    def _chunk_core(self):
        opts = self.opts
        mode = opts.render_mode
        has_crop = opts.render_aabb_min is not None
        crop_min = jnp.asarray(opts.render_aabb_min or (0, 0, 0), jnp.float32)
        crop_max = jnp.asarray(opts.render_aabb_max or (1, 1, 1), jnp.float32)

        def run(params, bitfield, xf_s, xf_e, rshutter, bg, key, pix0,
                jitter_on, fx, fy, n_rays, W, H, motion=False):
            o, d, u, v = self._gen_rays(key, pix0, n_rays, W, H, fx, fy,
                                        xf_s, xf_e, rshutter, jitter_on,
                                        motion)
            if mode == RenderMode.SLICE:
                return self._slice_mode(params, o, d, xf_s, bg, n_rays)
            if mode == RenderMode.DISTORTION:
                # visualize the learned ray-distortion grid as 2D flow
                # (ref: ERenderMode::Distortion overlay)
                uv = jnp.stack([u, v], -1)
                off = self.distortion_sampler(uv) \
                    if self.distortion_sampler is not None \
                    else jnp.zeros((n_rays, 2))
                rgb = jnp.concatenate(
                    [0.5 + off * 10.0, jnp.full((n_rays, 1), 0.5)], -1)
                return rgb, jnp.ones((n_rays,)), jnp.zeros((n_rays,)), \
                    jnp.zeros((), jnp.int32)

            per_ray = opts.samples_per_chunk_factor
            S = opts.chunk * per_ray
            t, dt, emit = march_rays(
                bitfield, o, d, None, n_rays, opts.march_steps,
                self.cone_angle, self.max_cascade,
                self.aabb_min, self.aabb_size, t_start_min=0.05)
            if has_crop:
                ct0, ct1 = ray_aabb_intersect(o, d, crop_min, crop_max)
                emit = emit & (t >= ct0[:, None]) & (t <= ct1[:, None])

            # env-map or constant background per ray
            if self.envmap_sampler is not None:
                env = self.envmap_sampler(d)
                bg_ray = env[:, :3] + bg[None, :3] * (1.0 - env[:, 3:4])
            else:
                bg_ray = jnp.broadcast_to(bg[None, :3], (n_rays, 3))

            # Segmented front-to-back evaluation with transmittance
            # early-out: saturated rays stop consuming network evals in
            # later segments (the reference gets this from its per-8-step
            # trace loop + min_transmittance cutoff).
            nseg = max(opts.march_segments, 1)
            seg_len = opts.march_steps // nseg
            rgb_acc = jnp.zeros((n_rays, 3))
            depth_acc = jnp.zeros((n_rays,))
            cost_acc = jnp.zeros((n_rays,))
            logT = jnp.zeros((n_rays,))
            total = jnp.zeros((), jnp.int32)
            for si in range(nseg):
                sl = slice(si * seg_len, (si + 1) * seg_len)
                alive = jnp.exp(-logT) > opts.min_transmittance
                emit_s = emit[:, sl] & alive[:, None]
                # decimate-with-dt-compensation instead of truncating:
                # optical depth is preserved for rays over the budget
                # (the ref marches to completion, nerf_renderer.cu:661-791)
                emit_s, dt_m = merge_excess_samples(emit_s, dt[:, sl],
                                                    per_ray)
                s_t, s_dt, s_ray, counts, offsets, fits, tot, s_k = \
                    compact_samples(t[:, sl], dt_m, emit_s, n_rays, S)
                total = total + tot
                rid = jnp.clip(s_ray, 0, n_rays - 1)
                pos = o[rid] + s_t[:, None] * d[rid]
                pos_w = (pos - self.aabb_min) / self.aabb_size
                dir_w = d[rid] * 0.5 + 0.5
                if mode == RenderMode.NORMALS:
                    # input-gradient normals (density gradient w.r.t. pos)
                    def dens_of(pw):
                        return jnp.sum(self.model.density(params, pw))
                    g = jax.grad(dens_of)(pos_w)
                    nrm = -g / (jnp.linalg.norm(g, axis=-1,
                                                keepdims=True) + 1e-9)
                    _, dens_raw = self.model.apply(params, pos_w, dir_w)
                    rgb = nrm * 0.5 + 0.5
                elif mode == RenderMode.ENCODING_VIS:
                    # visualize |features| of one hash level at the sample
                    # (ref: visualize_activation / EncodingVis)
                    feats = self.model.pos_encoding.apply(
                        params["pos_encoding"], pos_w)
                    lvl = opts.visualized_level
                    f = feats[:, 2 * lvl: 2 * lvl + 2].astype(jnp.float32)
                    rgb = jnp.stack([jnp.abs(f[:, 0]), jnp.abs(f[:, 1]),
                                     jnp.abs(f).mean(-1)], -1) * 16.0
                    _, dens_raw = self.model.apply(params, pos_w, dir_w)
                else:
                    rgb_raw, dens_raw = self.model.apply(params, pos_w, dir_w)
                    rgb = jax.nn.sigmoid(rgb_raw.astype(jnp.float32))
                if mode == RenderMode.POSITIONS:
                    if opts.show_accel >= 0:
                        # color by occupancy-grid mip + per-cell hash; every
                        # sample fully opaque so the first cell wins
                        # (ref: show_accel branch, testbed_nerf.cu:948-957
                        # + alpha=1 at :827-829)
                        from ngp_jax.grid.occupancy import mip_from_pos
                        mip = jnp.maximum(opts.show_accel,
                                          mip_from_pos(pos,
                                                       self.max_cascade))
                        res = (128 >> jnp.clip(mip, 0, 7)).astype(
                            jnp.float32)
                        cell = (pos * res[:, None]).astype(jnp.int32)
                        seed = (cell[:, 0] + cell[:, 1] * 232323 +
                                cell[:, 2] * 727272).astype(jnp.uint32)
                        h1 = (seed * jnp.uint32(2654435761)) >> 24
                        h2 = (seed * jnp.uint32(805459861)) >> 24
                        rgb = jnp.stack(
                            [1.0 - mip / 7.0, h1 / 255.0, h2 / 255.0], -1)
                    else:
                        rgb = pos_w
                sigma = jnp.exp(jnp.clip(dens_raw.astype(jnp.float32),
                                         -15., 15.))
                if mode == RenderMode.POSITIONS and opts.show_accel >= 0:
                    sigma = jnp.full_like(sigma, 1e6)
                if opts.glow_mode:
                    rgb, glow_mask = _apply_glow(
                        rgb, pos, xf_s[:, 3], opts.glow_mode,
                        opts.glow_y_cutoff)
                s_dt_eff = s_dt
                alpha_mult = None
                if self.masks:
                    from ngp_jax.render.multi_nerf import apply_masks
                    alpha_mult = apply_masks(self.masks, pos)
                if opts.glow_mode & 4:
                    alpha_mult = glow_mask if alpha_mult is None \
                        else alpha_mult * glow_mask
                if alpha_mult is not None:
                    # alpha modulation α' = m·α, folded exactly into the
                    # optical depth: σΔt' = -log(1 - m·(1-e^{-σΔt}))
                    # (ref: composite_kernel_nerf mask sampling + glow
                    # mask_to_alpha)
                    alpha = 1.0 - jnp.exp(-sigma * s_dt)
                    s_dt_eff = -jnp.log1p(-jnp.clip(alpha_mult * alpha, 0.0,
                                                    1.0 - 1e-7)) / \
                        jnp.maximum(sigma, 1e-10)
                rgb_seg, opac_seg, w = composite_samples(
                    sigma, rgb, s_dt_eff, s_ray, offsets, counts, n_rays,
                    s_k=s_k, n_k=seg_len)
                T_in = jnp.exp(-logT)
                rgb_acc = rgb_acc + T_in[:, None] * rgb_seg
                depth_acc = depth_acc + T_in * jnp.zeros(
                    (n_rays,)).at[s_ray].add(w * s_t, mode="drop")
                cost_acc = cost_acc + counts.astype(jnp.float32)
                logT = logT - jnp.log(jnp.maximum(1.0 - opac_seg, 1e-10))

            opacity = 1.0 - jnp.exp(-logT)
            rgb_out = rgb_acc + jnp.exp(-logT)[:, None] * bg_ray
            if mode == RenderMode.DEPTH:
                rgb_out = jnp.repeat(
                    (depth_acc / jnp.maximum(opacity, 1e-6))[:, None], 3, 1)
            elif mode == RenderMode.AO:
                rgb_out = jnp.repeat(opacity[:, None], 3, axis=1)
            elif mode == RenderMode.COST:
                rgb_out = jnp.repeat(cost_acc[:, None] / 128.0, 3, axis=1)
            return rgb_out, opacity, depth_acc, total

        return run

    # ------------------------------------------------------------------
    # wave (live-sample) rendering path
    # ------------------------------------------------------------------

    def _wave_cache(self):
        c = getattr(self, "_wave_fns", None)
        if c is None:
            c = self._wave_fns = {}
        return c

    def _wave_layout(self):
        """(nseg, seg_len, per_ray_cap) for the wave path. Fused mode
        (``wave_fused``) collapses the segment loop to one body per chunk
        with the whole-ray cap; segmented mode keeps march_segments
        bodies with the per-segment cap."""
        o = self.opts
        if o.wave_fused:
            cap = min(o.wave_cap * max(o.march_segments, 1),
                      o.march_steps)
            return 1, o.march_steps, cap
        nseg = max(o.march_segments, 1)
        return nseg, o.march_steps // nseg, o.wave_cap

    def _wave_march_fn(self, n_rays, W, H, motion, impl="flat"):
        """March a pixel chunk: rays + full lattice + occupancy filter
        (+ crop + per-ray background) in ONE dispatch. ``impl="hier"``
        culls 8-step segments on the conservative coarse mask (derived
        from the bitfield in-dispatch) before the fine tests and
        additionally returns the surviving-segment count for the
        overflow check."""
        cache = self._wave_cache()
        key_ = ("march", n_rays, W, H, motion, impl)
        if key_ in cache:
            return cache[key_]
        opts = self.opts
        has_crop = opts.render_aabb_min is not None
        crop_min = jnp.asarray(opts.render_aabb_min or (0, 0, 0),
                               jnp.float32)
        crop_max = jnp.asarray(opts.render_aabb_max or (1, 1, 1),
                               jnp.float32)
        hier = impl == "hier"
        seg_cap = max(n_rays * (opts.march_steps // 8)
                      // max(opts.wave_hier_frac, 1), 512)

        @jax.jit
        def run(bitfield, xf_s, xf_e, rsh, bg, key, pix0, jitter_on,
                fx, fy):
            o, d, _, _ = self._gen_rays(key, pix0, n_rays, W, H, fx, fy,
                                        xf_s, xf_e, rsh, jitter_on, motion)
            if hier:
                from ngp_jax.grid import occupancy as occ
                coarse = occ._build_coarse_mask(bitfield.reshape(
                    occ.NERF_CASCADES, occ.GH, occ.GH, occ.GH))
                t, dt, emit, seg_total = march_rays_hier(
                    bitfield, coarse, o, d, None, n_rays,
                    opts.march_steps, self.cone_angle, self.max_cascade,
                    self.aabb_min, self.aabb_size, t_start_min=0.05,
                    seg_capacity=seg_cap)
            else:
                t, dt, emit = march_rays(
                    bitfield, o, d, None, n_rays, opts.march_steps,
                    self.cone_angle, self.max_cascade,
                    self.aabb_min, self.aabb_size, t_start_min=0.05)
                seg_total = jnp.zeros((), jnp.int32)
            if has_crop:
                ct0, ct1 = ray_aabb_intersect(o, d, crop_min, crop_max)
                emit = emit & (t >= ct0[:, None]) & (t <= ct1[:, None])
            if self.envmap_sampler is not None:
                env = self.envmap_sampler(d)
                bg_ray = env[:, :3] + bg[None, :3] * (1.0 - env[:, 3:4])
            else:
                bg_ray = jnp.broadcast_to(bg[None, :3], (n_rays, 3))
            return o, d, t, dt, emit, bg_ray, seg_total

        cache[key_] = (run, seg_cap)
        return cache[key_]

    def _wave_count_fn(self, n_rays, si):
        """wave_sync="exact": one dispatch per segment — apply the
        transmittance early-out + per-ray decimation and COUNT the live
        samples. The count crosses to the host and picks the bucket the
        fused body compiles at (one host roundtrip per segment)."""
        cache = self._wave_cache()
        nseg, seg_len, cap = self._wave_layout()
        key_ = ("count", n_rays, si, nseg, cap)
        if key_ in cache:
            return cache[key_]
        opts = self.opts
        sl = slice(si * seg_len, (si + 1) * seg_len)

        @jax.jit
        def run(t, dt, emit, logT):
            alive = jnp.exp(-logT) > opts.min_transmittance
            emit_s = emit[:, sl] & alive[:, None]
            emit_m, _ = merge_excess_samples(emit_s, dt[:, sl], cap)
            return emit_m.sum()

        cache[key_] = run
        return run

    def _wave_countall_fn(self, n_rays):
        """wave_sync="bulk": ONE dispatch + ONE host sync per chunk. Per
        segment, the bound Σ_rays min(live_r, cap) needs no transmittance
        state, so every segment's bucket is known up front and the bodies
        chain on-device with no further roundtrips. (The bound dominates
        the exact post-early-out total: per ray, the filtered+merged
        count is ≤ min(live_r, cap).)"""
        cache = self._wave_cache()
        nseg, seg_len, cap = self._wave_layout()
        key_ = ("countall", n_rays, nseg, cap)
        if key_ in cache:
            return cache[key_]

        @jax.jit
        def run(emit):
            c = emit.reshape(n_rays, nseg, seg_len).sum(
                axis=-1, dtype=jnp.int32)                     # (R, nseg)
            return jnp.minimum(c, cap).sum(axis=0)            # (nseg,)

        cache[key_] = run
        return run

    def _wave_body_fn(self, n_rays, S):
        """Fused filter→decimate→compact→network-eval→composite for one
        segment at a host-chosen static stream capacity S (power-of-2
        bucket ≥ the segment's live total, instead of running every
        stream op at the n_rays·wave_cap worst case). The
        transmittance early-out + per-ray merge live HERE so the bulk
        count can stay transmittance-free; results are bit-identical
        across wave_sync modes. Everything scales with S, and XLA fuses
        the stream math into the MLP."""
        cache = self._wave_cache()
        nseg, seg_len, cap = self._wave_layout()
        key_ = ("body", n_rays, S, nseg, cap)
        if key_ in cache:
            return cache[key_]
        opts = self.opts

        @jax.jit
        def run(params, o, d, t_seg, emit_seg, dt_seg, logT, rgb_acc,
                depth_acc, cost_acc):
            alive = jnp.exp(-logT) > opts.min_transmittance
            emit_m, dt_m = merge_excess_samples(
                emit_seg & alive[:, None], dt_seg, cap)
            s_t, s_dt, s_ray, counts, offsets, fits, total, s_k = \
                compact_samples(t_seg, dt_m, emit_m, n_rays, S)
            rid = jnp.clip(s_ray, 0, n_rays - 1)
            pos = o[rid] + s_t[:, None] * d[rid]
            pos_w = (pos - self.aabb_min) / self.aabb_size
            dir_w = d[rid] * 0.5 + 0.5
            rgb_raw, dens_raw = self.model.apply(params, pos_w, dir_w)
            rgb = jax.nn.sigmoid(rgb_raw.astype(jnp.float32))
            sigma = jnp.exp(jnp.clip(dens_raw.astype(jnp.float32),
                                     -15., 15.))
            s_dt_eff = s_dt
            if self.masks:
                from ngp_jax.render.multi_nerf import apply_masks
                alpha_mult = apply_masks(self.masks, pos)
                alpha = 1.0 - jnp.exp(-sigma * s_dt)
                s_dt_eff = -jnp.log1p(-jnp.clip(alpha_mult * alpha, 0.0,
                                                1.0 - 1e-7)) / \
                    jnp.maximum(sigma, 1e-10)
            rgb_seg, opac_seg, w = composite_samples(
                sigma, rgb, s_dt_eff, s_ray, offsets, counts, n_rays,
                s_k=s_k, n_k=seg_len)
            T_in = jnp.exp(-logT)
            rgb_acc = rgb_acc + T_in[:, None] * rgb_seg
            depth_acc = depth_acc + T_in * jnp.zeros(
                (n_rays,)).at[s_ray].add(w * s_t, mode="drop")
            cost_acc = cost_acc + counts.astype(jnp.float32)
            logT = logT - jnp.log(jnp.maximum(1.0 - opac_seg, 1e-10))
            return logT, rgb_acc, depth_acc, cost_acc

        cache[key_] = run
        return run

    def _wave_start(self, params, bitfield, xf_s, xf_e, rsh, bg,
                    key, pix0, jitter_on, fx, fy, n_rays, W, H, motion):
        """Phase 1 of a pipelined wave chunk: dispatch the march and the
        bulk count ASYNC and return the device handles — no host sync
        here. The caller fetches the counts one work item later
        (_wave_finish), so the host round-trip hides behind the
        previous item's segment bodies instead of idling the device."""
        opts = self.opts
        march, seg_cap = self._wave_march_fn(n_rays, W, H, motion,
                                             impl=opts.wave_march)
        margs = (bitfield, xf_s, xf_e, rsh, bg, key, pix0, jitter_on,
                 fx, fy)
        o, d, t, dt, emit, bg_ray, seg_total = march(*margs)
        counts = None
        if opts.wave_sync == "bulk":
            # per-segment bucket bounds + the hier-march overflow counter
            # ride ONE transfer
            counts = jnp.concatenate(
                [self._wave_countall_fn(n_rays)(emit),
                 seg_total[None].astype(jnp.int32)])
        return (o, d, t, dt, emit, bg_ray, seg_total, counts, seg_cap,
                margs)

    def _wave_finish(self, params, st, n_rays, W, H, motion):
        """Phase 2: fetch the counts (the only host sync on the hot
        path), size each segment's power-of-2 stream bucket, and run the
        fused compact+eval+composite body per segment. Matches the
        static path's math bit-for-bit at equal caps
        (test_wave_renderer). wave_sync picks the count strategy:
        "bulk" = one sync per chunk on a transmittance-free bound;
        "exact" = one sync per SEGMENT (tighter buckets, more syncs)."""
        opts = self.opts
        mode = opts.render_mode
        nseg, seg_len, cap = self._wave_layout()
        (o, d, t, dt, emit, bg_ray, seg_total, counts, seg_cap,
         margs) = st
        logT = jnp.zeros((n_rays,))
        rgb_acc = jnp.zeros((n_rays, 3))
        depth_acc = jnp.zeros((n_rays,))
        cost_acc = jnp.zeros((n_rays,))
        grand_total = 0
        S_max = n_rays * cap
        bulk = opts.wave_sync == "bulk"
        if bulk:
            fetched = np.asarray(counts)
            bounds, seg_total_h = fetched[:-1], int(fetched[-1])
        else:
            seg_total_h = int(np.asarray(seg_total)) \
                if opts.wave_march == "hier" else 0
        if opts.wave_march == "hier" and seg_total_h > seg_cap:
            # conservative-stream overflow (dense scene / huge chunk):
            # tail segments were dropped — redo this chunk with the flat
            # filter (correct, slower; raise wave_hier_frac headroom if
            # this fires often)
            march, _ = self._wave_march_fn(n_rays, W, H, motion,
                                           impl="flat")
            o, d, t, dt, emit, bg_ray, _ = march(*margs)
            if bulk:
                bounds = np.asarray(self._wave_countall_fn(n_rays)(emit))
        for si in range(nseg):
            if bulk:
                total = int(bounds[si])
            else:
                total = int(np.asarray(self._wave_count_fn(n_rays, si)(
                    t, dt, emit, logT)))
            grand_total += total
            if total == 0:
                continue
            S = min(1 << max(12, (total - 1).bit_length()), S_max)
            sl = slice(si * seg_len, (si + 1) * seg_len)
            logT, rgb_acc, depth_acc, cost_acc = \
                self._wave_body_fn(n_rays, S)(
                    params, o, d, t[:, sl], emit[:, sl], dt[:, sl],
                    logT, rgb_acc, depth_acc, cost_acc)
        opacity = 1.0 - jnp.exp(-logT)
        rgb_out = rgb_acc + jnp.exp(-logT)[:, None] * bg_ray
        if mode == RenderMode.DEPTH:
            rgb_out = jnp.repeat(
                (depth_acc / jnp.maximum(opacity, 1e-6))[:, None], 3, 1)
        elif mode == RenderMode.AO:
            rgb_out = jnp.repeat(opacity[:, None], 3, axis=1)
        elif mode == RenderMode.COST:
            rgb_out = jnp.repeat(cost_acc[:, None] / 128.0, 3, axis=1)
        # exact composited-sample count (bulk mode's grand_total is only
        # the bucket bound); fetched with the chunk's pixel fetch
        return rgb_out, opacity, cost_acc.sum()

    def _wave_supported(self):
        o = self.opts
        if o.wave_dispatch == "device":
            return o.wave and o.render_mode in (
                RenderMode.SHADE, RenderMode.DEPTH, RenderMode.AO,
                RenderMode.COST) and o.glow_mode == 0 and \
                o.march_steps % 8 == 0
        return o.wave and o.render_mode in (
            RenderMode.SHADE, RenderMode.DEPTH, RenderMode.AO,
            RenderMode.COST) and o.glow_mode == 0 and \
            (o.wave_fused
             or o.march_steps % max(o.march_segments, 1) == 0)

    # ------------------------------------------------------------------
    # wave2: fully device-dispatched wave rendering (round 5)
    # ------------------------------------------------------------------

    def _wave2_layout(self, n_rays, flat=False):
        """Static layout of the device-dispatch wave: (seg, n_seg, S1,
        cap, buckets, cand_caps). ``buckets`` are the lax.switch stream
        capacities; ``cand_caps`` the halving per-ray caps the top bucket
        may decimate to so the stream is GUARANTEED to fit. ``flat``:
        the degenerate one-segment-per-ray layout (the stream IS the
        (R, K) lattice — for scenes whose occupancy is too incoherent
        for the 16³ coarse mask to cull anything)."""
        opts = self.opts
        K = opts.march_steps
        if flat:
            seg, n_seg, S1 = K, 1, n_rays
            cap = min(opts.wave_cap * max(opts.march_segments, 1), K)
            smax = n_rays * cap
            top = min(max(opts.wave2_top_bucket, 4096),
                      1 << (smax - 1).bit_length())
            top_pow = (top - 1).bit_length() if top > 1 else 1
            lo_pow = min(12, top_pow)
            buckets = [1 << p for p in range(lo_pow, top_pow + 1)]
            cands = [cap]
            while n_rays * cands[-1] > buckets[-1] and cands[-1] > 1:
                cands.append(max(cands[-1] // 2, 1))
            return seg, n_seg, S1, cap, buckets, cands
        seg = 8
        n_seg = K // seg
        S1 = max(n_rays * n_seg // max(opts.wave2_frac, 1), 256)
        cap = min(opts.wave_cap * max(opts.march_segments, 1), K)
        smax = n_rays * cap
        top = min(max(opts.wave2_top_bucket, 4096), 1 << (smax - 1).bit_length())
        top_pow = (top - 1).bit_length() if top > 1 else 1
        lo_pow = min(12, top_pow)
        buckets = [1 << p for p in range(lo_pow, top_pow + 1)]
        cands = [cap]
        while n_rays * cands[-1] > buckets[-1] and cands[-1] > 1:
            cands.append(max(cands[-1] // 2, 1))
        return seg, n_seg, S1, cap, buckets, cands

    def _wave2_chunk_fn(self, n_rays, W, H, motion, flat=False):
        """One pixel chunk, fully traced (usable inside scan): march to
        the segment stream → per-ray decimation cap fitted on device →
        lax.switch over power-of-2 stream buckets → fused network eval +
        segmented composite on the stream. No (R, K) lattice, no host
        syncs. Composite math matches the static path's (exclusive per-
        ray optical-depth prefix via exact per-ray cumsums — here split
        into an in-segment prefix on the (S1, seg) stream plus an inter-
        segment per-ray prefix on an (R, n_seg) lattice, both
        numerically-safe per-ray sums like exclusive_depth)."""
        cache = self._wave_cache()
        key_ = ("wave2", n_rays, W, H, motion, flat)
        if key_ in cache:
            return cache[key_]
        opts = self.opts
        mode = opts.render_mode
        seg, n_seg, S1, cap, buckets, cands = self._wave2_layout(
            n_rays, flat=flat)
        has_crop = opts.render_aabb_min is not None
        crop_min = jnp.asarray(opts.render_aabb_min or (0, 0, 0),
                               jnp.float32)
        crop_max = jnp.asarray(opts.render_aabb_max or (1, 1, 1),
                               jnp.float32)
        from ngp_jax.rays.marching import march_rays, march_segment_stream

        def run(params, bitfield, coarse, xf_s, xf_e, rsh, bg, key,
                pix0, jitter_on, fx, fy):
            o, d, _, _ = self._gen_rays(key, pix0, n_rays, W, H, fx, fy,
                                        xf_s, xf_e, rsh, jitter_on,
                                        motion)
            if self.envmap_sampler is not None:
                env = self.envmap_sampler(d)
                bg_ray = env[:, :3] + bg[None, :3] * (1.0 - env[:, 3:4])
            else:
                bg_ray = jnp.broadcast_to(bg[None, :3], (n_rays, 3))

            if flat:
                # degenerate stream: one "segment" per ray = the (R, K)
                # lattice; never overflows (S1 = n_rays holds every ray)
                t_s, dt_s, emit_s = march_rays(
                    bitfield, o, d, None, n_rays, opts.march_steps,
                    self.cone_angle, self.max_cascade, self.aabb_min,
                    self.aabb_size, t_start_min=0.05)
                seg_ray = jnp.arange(n_rays, dtype=jnp.int32)
                seg_k = jnp.zeros((n_rays,), jnp.int32)
                seg_total = jnp.zeros((), jnp.int32)
            else:
                t0, tmax, seg_ray, seg_k, t_s, dt_s, emit_s, seg_total = \
                    march_segment_stream(
                        bitfield, coarse, o, d, n_rays, opts.march_steps,
                        self.cone_angle, self.max_cascade, self.aabb_min,
                        self.aabb_size, S1, seg=seg, t_start_min=0.05)
            valid_seg = seg_ray < n_rays
            rid0 = jnp.clip(seg_ray, 0, n_rays - 1)
            if has_crop:
                ct0, ct1 = ray_aabb_intersect(o, d, crop_min, crop_max)
                emit_s = emit_s & (t_s >= ct0[rid0][:, None]) & \
                    (t_s <= ct1[rid0][:, None])

            # per-ray live counts (exact int32) + stream-order ranks
            seg_live = emit_s.sum(axis=1, dtype=jnp.int32)       # (S1,)
            c_ray = jnp.zeros((n_rays,), jnp.int32).at[seg_ray].add(
                seg_live, mode="drop")
            base = jnp.cumsum(c_ray) - c_ray                     # (R,)
            flat_pos = jnp.cumsum(
                emit_s.reshape(-1).astype(jnp.int32)) - 1
            rank = flat_pos.reshape(S1, seg) - base[rid0][:, None]

            # decimation cap fitted so the kept total is ≤ the chosen
            # bucket: d(c, cap') = ceil(c / ceil(c / cap')) kept per ray
            cands_a = jnp.asarray(cands, jnp.int32)[None]        # (1, J)
            c2 = c_ray[:, None]
            m_j = -(-c2 // cands_a)                              # (R, J)
            d_j = jnp.where(c2 > 0, -(-c2 // jnp.maximum(m_j, 1)), 0)
            tot_j = d_j.sum(axis=0)                              # (J,)
            buckets_a = jnp.asarray(buckets, jnp.int32)
            b_raw = jnp.searchsorted(buckets_a, tot_j[0])
            overflowed = b_raw >= len(buckets)
            b = jnp.minimum(b_raw, len(buckets) - 1)
            j_fit = jnp.argmax(tot_j <= buckets[-1])
            capx = jnp.where(overflowed, cands_a[0, j_fit], cap)
            dcnt = jnp.where(overflowed, d_j[:, j_fit], d_j[:, 0])

            m = jnp.maximum(-(-c_ray // jnp.maximum(capx, 1)), 1)
            m_s = m[rid0][:, None]                               # (S1, 1)
            keep = emit_s & (rank % m_s == 0)
            grp = jnp.minimum(m_s, c_ray[rid0][:, None] - rank
                              ).astype(dt_s.dtype)
            dt_eff = jnp.where(keep, dt_s * grp, dt_s)
            total = dcnt.sum()

            def make_branch(S_b):
                def br(_):
                    s_t, s_dt, s_row, _, _, _, _, s_kk = compact_samples(
                        t_s, dt_eff, keep, S1, S_b)
                    v = s_row < S1
                    row = jnp.clip(s_row, 0, S1 - 1)
                    ray_of = jnp.where(v, rid0[row], n_rays)
                    rid = jnp.clip(ray_of, 0, n_rays - 1)
                    pos = o[rid] + s_t[:, None] * d[rid]
                    pos_w = (pos - self.aabb_min) / self.aabb_size
                    dir_w = d[rid] * 0.5 + 0.5
                    rgb_raw, dens_raw = self.model.apply(params, pos_w,
                                                         dir_w)
                    rgb = jax.nn.sigmoid(rgb_raw.astype(jnp.float32))
                    sigma = jnp.exp(jnp.clip(
                        dens_raw.astype(jnp.float32), -15., 15.))
                    s_dt_eff = s_dt
                    if self.masks:
                        from ngp_jax.render.multi_nerf import apply_masks
                        alpha_mult = apply_masks(self.masks, pos)
                        alpha = 1.0 - jnp.exp(-sigma * s_dt)
                        s_dt_eff = -jnp.log1p(
                            -jnp.clip(alpha_mult * alpha, 0.0,
                                      1.0 - 1e-7)) / \
                            jnp.maximum(sigma, 1e-10)
                    sdt = jnp.where(v, sigma * s_dt_eff, 0.0)
                    # exclusive per-ray optical depth, two exact levels:
                    # in-segment prefix on the (S1, seg) stream + inter-
                    # segment per-ray prefix on an (R, n_seg) lattice
                    lat = jnp.zeros((S1, seg)).at[row, s_kk].add(
                        jnp.where(v, sdt, 0.0), mode="drop")
                    in_seg_excl = jnp.cumsum(lat, axis=1) - lat
                    seg_sum = lat.sum(axis=1)                    # (S1,)
                    lat2 = jnp.zeros((n_rays, n_seg)).at[
                        seg_ray, jnp.clip(seg_k, 0, n_seg - 1)].add(
                        jnp.where(valid_seg, seg_sum, 0.0), mode="drop")
                    ray_excl2 = jnp.cumsum(lat2, axis=1) - lat2
                    seg_base = ray_excl2[rid0[row],
                                         jnp.clip(seg_k[row], 0,
                                                  n_seg - 1)]
                    excl = seg_base + in_seg_excl[row, s_kk]
                    T = jnp.exp(-excl)
                    alpha_s = 1.0 - jnp.exp(-sdt)
                    w = jnp.where(v, T * alpha_s, 0.0)
                    rgb_ray = jnp.zeros((n_rays, 3)).at[ray_of].add(
                        w[:, None] * rgb, mode="drop")
                    depth_ray = jnp.zeros((n_rays,)).at[ray_of].add(
                        w * s_t, mode="drop")
                    odepth = lat2.sum(axis=1)                    # (R,)
                    return rgb_ray, depth_ray, odepth
                return br

            rgb_ray, depth_ray, odepth = jax.lax.switch(
                b, [make_branch(S_b) for S_b in buckets],
                jnp.zeros((), jnp.int32))
            opacity = 1.0 - jnp.exp(-odepth)
            rgb_out = rgb_ray + jnp.exp(-odepth)[:, None] * bg_ray
            if mode == RenderMode.DEPTH:
                rgb_out = jnp.repeat(
                    (depth_ray / jnp.maximum(opacity, 1e-6))[:, None],
                    3, 1)
            elif mode == RenderMode.AO:
                rgb_out = jnp.repeat(opacity[:, None], 3, axis=1)
            elif mode == RenderMode.COST:
                rgb_out = jnp.repeat(dcnt.astype(jnp.float32)[:, None]
                                     / 128.0, 3, axis=1)
            overflow = seg_total > S1
            return rgb_out, opacity, total, overflow

        cache[key_] = run
        return run

    def _frame_fn_wave2(self, eff_chunk: int, group: int, W: int, H: int,
                        n_spp: int, motion: bool, flat: bool = False):
        """Jitted wave2 render of a GROUP of pixel chunks: one scan over
        (spp × group) work items, each a full march→switch-bucket→
        composite chunk — ZERO host syncs inside a group (vs one count
        roundtrip per chunk in the host-dispatch wave). Also returns the
        summed live-sample count and an overflow flag (any chunk whose
        surviving segments exceeded the stream bound S1 under-rendered;
        the caller re-renders the group on the static path)."""
        key_ = ("wave2frame", eff_chunk, group, W, H, n_spp, motion, flat)
        cache = self._wave_cache()
        if key_ in cache:
            return cache[key_]
        core = self._wave2_chunk_fn(eff_chunk, W, H, motion, flat=flat)
        snap = self.opts.snap_to_pixel_centers

        @jax.jit
        def run_group(params, bitfield, xf_s, xf_e, rsh, bg, key, fx, fy,
                      base):
            coarse = occupancy_mod._build_coarse_mask(
                bitfield.reshape(occupancy_mod.NERF_CASCADES,
                                 occupancy_mod.GH, occupancy_mod.GH,
                                 occupancy_mod.GH))

            def body(carry, idx):
                acc, tot, ovf = carry
                s = idx // group
                c = base + idx % group
                kc = jax.random.fold_in(key, s * 4096 + c)
                jitter_on = jnp.asarray(not snap) & (s > 0)
                rgb, opac, n, o_f = core(
                    params, bitfield, coarse, xf_s, xf_e, rsh, bg, kc,
                    c * eff_chunk, jitter_on, fx, fy)
                contrib = jnp.concatenate([rgb, opac[:, None]],
                                          -1) / n_spp
                lo = (idx % group) * eff_chunk
                prev = jax.lax.dynamic_slice(acc, (lo, 0),
                                             (eff_chunk, 4))
                acc = jax.lax.dynamic_update_slice(acc, prev + contrib,
                                                   (lo, 0))
                return (acc, tot + n, ovf | o_f), None

            acc0 = (jnp.zeros((group * eff_chunk, 4)),
                    jnp.zeros((), jnp.int32), jnp.zeros((), bool))
            (acc, tot, ovf), _ = jax.lax.scan(
                body, acc0, jnp.arange(n_spp * group, dtype=jnp.int32))
            return acc, tot, ovf

        cache[key_] = run_group
        return run_group

    def _render_wave2(self, params, bitfield, xf_s, xf_e, rsh, bg, key,
                      eff_chunk, n_chunks, W, H, n_spp, fx, fy, motion):
        """Full-frame device-dispatch wave render: chunk groups run as
        single scans; the only host syncs are the per-group pixel
        fetches. An overflowed group (segment stream bound exceeded —
        would silently under-render) is re-rendered with the FLAT
        device-dispatch program (stream = the (R, K) lattice, cannot
        overflow), and the frame sticks to flat from then on — scenes
        too incoherent for the coarse mask stay on the device path
        instead of regressing to static."""
        opts = self.opts
        self.last_wave_samples = 0
        group = max(min(opts.dispatch_chunks, n_chunks), 1)
        # sticky across frames: once this scene overflowed the segment
        # stream, later frames go straight to the flat program
        flat = opts.wave_march == "flat" or \
            getattr(self, "_wave2_flat_sticky", False)
        parts = []
        handles = []
        for base in range(0, n_chunks, group):
            g = min(group, n_chunks - base)
            fn = self._frame_fn_wave2(eff_chunk, g, W, H, n_spp, motion,
                                      flat=flat)
            handles.append((base, g, fn(
                params, bitfield, xf_s, xf_e, rsh, bg, key,
                jnp.float32(fx), jnp.float32(fy), base)))
        for base, g, (acc, tot, ovf) in handles:
            if bool(np.asarray(ovf)):
                self._wave2_flat_sticky = True
                fn = self._frame_fn_wave2(eff_chunk, g, W, H, n_spp,
                                          motion, flat=True)
                acc, tot, _ = fn(params, bitfield, xf_s, xf_e, rsh, bg,
                                 key, jnp.float32(fx), jnp.float32(fy),
                                 base)
            self.last_wave_samples += int(np.asarray(tot))
            parts.append(np.asarray(acc))
        return np.concatenate(parts, axis=0)

    def _render_wave(self, params, bitfield, xf_s, xf_e, rsh, bg, key,
                     eff_chunk, n_chunks, W, H, n_spp, fx, fy, motion):
        """Full-frame wave render, PIPELINED over (chunk, spp) work
        items: item k+1's march + bulk count are dispatched BEFORE item
        k's count is fetched, so the device always has queued work while
        the host waits on the round-trip. Per-chunk
        rgba accumulates on the DEVICE; the host fetches pixels once at
        the end."""
        opts = self.opts
        snap = opts.snap_to_pixel_centers
        self.last_wave_samples = 0
        fxj, fyj = jnp.float32(fx), jnp.float32(fy)

        def start(k):
            c, s = divmod(k, n_spp)
            kc = jax.random.fold_in(key, s * 4096 + c)
            jit_on = jnp.asarray(not snap) & (s > 0)
            return self._wave_start(params, bitfield, xf_s, xf_e, rsh,
                                    bg, kc, c * eff_chunk, jit_on, fxj,
                                    fyj, eff_chunk, W, H, motion)

        n_items = n_chunks * n_spp
        parts = [None] * n_chunks
        totals = []
        st = start(0) if n_items else None
        for k in range(n_items):
            nxt = start(k + 1) if k + 1 < n_items else None
            rgb, opac, tot = self._wave_finish(params, st, eff_chunk,
                                               W, H, motion)
            st = nxt
            c = k // n_spp
            rgba = jnp.concatenate([rgb, opac[:, None]], -1) / n_spp
            parts[c] = rgba if parts[c] is None else parts[c] + rgba
            totals.append(tot)
        if totals:
            self.last_wave_samples = int(np.asarray(
                jnp.sum(jnp.stack(totals))))
        return np.concatenate([np.asarray(p) for p in parts], axis=0)

    def _slice_mode(self, params, o, d, xf, bg, n_rays):
        """SLICE: evaluate rgbσ on the plane through the scene center
        offset by slice_plane_z along the camera forward axis; no
        marching (ref: testbed_nerf.cu:2412-2476)."""
        opts = self.opts
        fwd = xf[:, 2]
        center = jnp.asarray([0.5, 0.5, 0.5]) + opts.slice_plane_z * fwd
        denom = jnp.matmul(d, fwd, precision="highest")
        tp = jnp.matmul(center - o, fwd, precision="highest") / jnp.where(
            jnp.abs(denom) < 1e-6, 1e-6, denom)
        pos = o + tp[:, None] * d
        pos_w = (pos - self.aabb_min) / self.aabb_size
        inside = jnp.all((pos_w >= 0) & (pos_w <= 1), -1) & (tp > 0)
        rgb_raw, dens_raw = self.model.apply(params, pos_w, d * 0.5 + 0.5)
        rgb = jax.nn.sigmoid(rgb_raw.astype(jnp.float32))
        sigma = jnp.exp(jnp.clip(dens_raw.astype(jnp.float32), -15., 15.))
        alpha = jnp.where(inside, 1.0 - jnp.exp(-sigma * 0.01), 0.0)
        rgb_out = rgb * alpha[:, None] + bg[None, :3] * (1 - alpha[:, None])
        return rgb_out, alpha, tp, jnp.zeros((), jnp.int32)

    # ------------------------------------------------------------------

    def _frame_fn(self, eff_chunk: int, group: int, W: int, H: int,
                  n_spp: int, motion: bool):
        """Jitted render of a GROUP of pixel chunks: a lax.scan over
        (spp × group chunks) with the spp loop folded into the scan axis
        (the per-chunk dispatch restructure the trainer got in round 2;
        ref throughput anchor: 'tens of ms at 1920×1080',
        /root/reference/docs/index.html:317). Frames larger than
        ``dispatch_chunks`` chunks render in several group dispatches."""
        key_ = (eff_chunk, group, W, H, n_spp, motion)
        cache = getattr(self, "_frame_fns", None)
        if cache is None:
            cache = self._frame_fns = {}
        if key_ in cache:
            return cache[key_]
        core = self._chunk_core
        snap = self.opts.snap_to_pixel_centers

        @jax.jit
        def run_group(params, bitfield, xf_s, xf_e, rsh, bg, key, fx, fy,
                      base):
            # spp is folded into the SCAN axis (not unrolled in the body):
            # an unrolled body gives XLA n_spp concurrent chunk lattices
            def body(acc, idx):
                s = idx // group
                c = base + idx % group
                kc = jax.random.fold_in(key, s * 4096 + c)
                jitter_on = jnp.asarray(not snap) & (s > 0)
                rgb, opac, _, _ = core(
                    params, bitfield, xf_s, xf_e, rsh, bg, kc,
                    c * eff_chunk, jitter_on, fx, fy, eff_chunk,
                    W, H, motion)
                contrib = jnp.concatenate([rgb, opac[:, None]],
                                          -1) / n_spp
                lo = (idx % group) * eff_chunk
                prev = jax.lax.dynamic_slice(
                    acc, (lo, 0), (eff_chunk, 4))
                acc = jax.lax.dynamic_update_slice(
                    acc, prev + contrib, (lo, 0))
                return acc, None
            acc0 = jnp.zeros((group * eff_chunk, 4))
            acc, _ = jax.lax.scan(
                body, acc0,
                jnp.arange(n_spp * group, dtype=jnp.int32))
            return acc

        cache[key_] = run_group
        return run_group

    def render_multichip(self, mesh, params, bitfield, camera_matrix,
                         width: Optional[int] = None,
                         height: Optional[int] = None,
                         focal: Optional[tuple] = None,
                         spp: Optional[int] = None,
                         seed: int = 0) -> np.ndarray:
        """Frame-parallel rendering over a device mesh: pixel chunks are
        sharded across the ``data`` axis (rendering is embarrassingly
        parallel, so the multi-device path is frame slicing; SURVEY
        §2.10). Chunk keys match ``render``'s, so a 1-device mesh
        reproduces the single-chip image exactly."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        opts = self.opts
        W = int(width or opts.width)
        H = int(height or opts.height)
        eff_chunk = min(opts.chunk, max(((W * H + 255) // 256) * 256, 256))
        fx = float((focal or (opts.fov_axis_focal,
                              opts.focal_y or opts.fov_axis_focal))[0])
        fy = float((focal or (opts.fov_axis_focal,
                              opts.focal_y or opts.fov_axis_focal))[1])
        n_spp = int(spp or opts.spp)
        nd = mesh.shape["data"]
        n_chunks = -(-H * W // eff_chunk)
        per_dev = -(-n_chunks // nd)
        ids = np.arange(per_dev * nd, dtype=np.int32)  # padded chunk ids
        core = self._chunk_core
        snap = opts.snap_to_pixel_centers

        def shard_fn(params, bitfield, xf_s, xf_e, rsh, bg, key, ids):
            def body(_, c):
                acc = jnp.zeros((eff_chunk, 4))
                for s in range(n_spp):
                    kc = jax.random.fold_in(key, s * 4096 + c)
                    jit_on = jnp.asarray(not snap) & (s > 0)
                    rgb, opac, _, _ = core(
                        params, bitfield, xf_s, xf_e, rsh, bg, kc,
                        c * eff_chunk, jit_on, jnp.float32(fx),
                        jnp.float32(fy), eff_chunk, W, H, False)
                    acc = acc + jnp.concatenate([rgb, opac[:, None]], -1)
                return None, acc / n_spp
            _, ys = jax.lax.scan(body, None, ids)
            return ys                                    # (per_dev, C, 4)

        fn = jax.jit(shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(), P(), P(), P("data")),
            out_specs=P("data"), check_vma=False))
        xf = jnp.asarray(camera_matrix, jnp.float32)
        with mesh:
            ys = fn(params, bitfield, xf, xf,
                    jnp.asarray((0.0, 0.0, 0.0, 1.0), jnp.float32),
                    jnp.asarray(opts.background, jnp.float32),
                    jax.random.PRNGKey(seed), jnp.asarray(ids))
        acc = np.asarray(ys).reshape(-1, 4)[: H * W]
        img = acc.reshape(H, W, 4)
        rgb = img[..., :3]
        if opts.linear_out:
            rgb = np.asarray(srgb_to_linear(jnp.clip(
                jnp.asarray(rgb), 0.0, None)))
        return np.concatenate([rgb, img[..., 3:]], -1).astype(np.float32)

    def render(self, params, bitfield, camera_matrix: np.ndarray,
               width: Optional[int] = None, height: Optional[int] = None,
               focal: Optional[tuple] = None, spp: Optional[int] = None,
               seed: int = 0, camera_matrix_end=None,
               rolling_shutter=(0.0, 0.0, 0.0, 1.0)) -> np.ndarray:
        """Render one frame → (H, W, 4) float32.

        camera_matrix: (3,4) NGP-convention camera→world; when
        ``camera_matrix_end`` differs, per-ray transforms interpolate
        between them with the ``rolling_shutter`` (x0, y-row, x-col,
        motion-time) weights like the reference renderer.
        Output RGB is the network's sRGB converted to linear if
        opts.linear_out (matching render_to_cpu + run.py eval protocol).
        """
        opts = self.opts
        W = int(width or opts.width)
        H = int(height or opts.height)
        eff_chunk = min(opts.chunk, max(((W * H + 255) // 256) * 256, 256))
        fx = float((focal or (opts.fov_axis_focal,
                              opts.focal_y or opts.fov_axis_focal))[0])
        fy = float((focal or (opts.fov_axis_focal,
                              opts.focal_y or opts.fov_axis_focal))[1])
        n_spp = int(spp or opts.spp)

        xf_s = jnp.asarray(camera_matrix, jnp.float32)
        xf_e = jnp.asarray(camera_matrix if camera_matrix_end is None
                           else camera_matrix_end, jnp.float32)
        rsh = jnp.asarray(rolling_shutter, jnp.float32)
        bg = jnp.asarray(opts.background, jnp.float32)
        key = jax.random.PRNGKey(seed)

        n_chunks = -(-H * W // eff_chunk)
        motion = camera_matrix_end is not None
        if self._wave_supported():
            wave_impl = self._render_wave2 \
                if opts.wave_dispatch == "device" else self._render_wave
            acc = jnp.asarray(wave_impl(
                params, bitfield, xf_s, xf_e, rsh, bg, key, eff_chunk,
                n_chunks, W, H, n_spp, fx, fy, motion)[: H * W])
        else:
            group = max(min(opts.dispatch_chunks, n_chunks), 1)
            parts = []
            for base in range(0, n_chunks, group):
                g = min(group, n_chunks - base)
                fn = self._frame_fn(eff_chunk, g, W, H, n_spp, motion)
                parts.append(np.asarray(fn(
                    params, bitfield, xf_s, xf_e, rsh, bg, key,
                    jnp.float32(fx), jnp.float32(fy), base)))
            acc = jnp.asarray(np.concatenate(parts, 0)[: H * W])

        img = acc.reshape(H, W, 4)
        rgb = img[..., :3]
        if opts.exposure != 0.0:
            rgb = rgb * (2.0 ** opts.exposure)
        if opts.tonemap_curve != TonemapCurve.IDENTITY:
            rgb = tonemap(jnp.maximum(rgb, 0.0), opts.tonemap_curve)
        if opts.linear_out:
            rgb = srgb_to_linear(jnp.clip(rgb, 0.0, None))
        return np.asarray(jnp.concatenate([rgb, img[..., 3:]], -1),
                          np.float32)


def _apply_glow(rgb, pos, cam_pos, glow_mode: int, glow_y_cutoff: float):
    """Per-sample glow effect (ref: composite_kernel_nerf glow block,
    src/testbed_nerf.cu:843-940). Returns (rgb, alpha_mask)."""
    green_grid = bool(glow_mode & 1)
    green_cutline = bool(glow_mode & 2)
    radial = bool(glow_mode & 8)
    grid_mode = bool(glow_mode & 16)

    if radial:
        dist = jnp.linalg.norm(pos - cam_pos[None], axis=-1)
        dist = jnp.minimum(dist, (4.5 - pos[:, 1]) * 0.333)
    else:
        dist = pos[:, 1]

    if grid_mode:
        glow = 1.0 / jnp.maximum(1.0, dist)
        mask = jnp.ones_like(dist)
    else:
        y = glow_y_cutoff - dist
        y80 = y * 80.0
        mask = jnp.where(y > 0, jnp.minimum(1.0, y80), 0.0)
        glow = jnp.zeros_like(dist)
        if green_cutline:
            glow = glow + jnp.where(
                y > 0, jnp.maximum(0.0, 1.0 - jnp.abs(1.0 - y80)) * 4.0,
                0.0)
        y2 = jnp.where(y80 > 1.0, 1.0 - (y80 - 1.0) * 0.05, y80)
        if green_grid:
            glow = glow + jnp.where(
                y > 0, jnp.maximum(0.0, y2 / jnp.maximum(1.0, dist)), 0.0)

    line = jnp.zeros_like(dist)
    for scale in (2.0, 4.0, 8.0, 16.0):
        for ax in range(3):
            line = line + jnp.maximum(
                0.0, jnp.cos(pos[:, ax] * scale * jnp.pi * 16.0) - 0.975)
    if grid_mode:
        g = glow * line * 15.0
        rgb = jnp.stack([g * 0.25, g, g * 0.5], -1)
    else:
        g = glow * glow * 0.25 + glow * line * 15.0
        rgb = rgb + jnp.stack([g * 0.25, g, g * 0.5], -1)
    return rgb, mask
