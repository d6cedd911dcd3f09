"""Neural-volume renderer: emission-absorption ray march.

Equivalent of the reference's volume render path
(ref: render_volume + kernels, src/testbed_volume.cu:206-392): instead of
payload-compacted per-step marching, each pixel chunk takes fixed Δt steps
through the AABB under a ``lax.scan`` accumulating transmittance, with the
128³ bitgrid as an early-skip mask.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.rays.camera import ray_aabb_intersect
from ngp_jax.train.volume import sky_color


@dataclasses.dataclass
class VolumeRenderOptions:
    width: int = 512
    height: int = 512
    focal: float = 512.0
    n_steps: int = 192
    distance_scale: float = 100.0
    chunk: int = 1 << 15
    sun_dir: tuple = (0.577, 0.577, 0.577)


class VolumeRenderer:
    def __init__(self, trainer, opts: Optional[VolumeRenderOptions] = None):
        self.trainer = trainer
        self.opts = opts or VolumeRenderOptions()

    @functools.cached_property
    def _march_chunk(self):
        opts = self.opts
        g = self.trainer.grid
        model = self.trainer.model
        # 128³ majorant occupancy mask — steps in empty cells contribute
        # nothing and skip network influence (ref: bitgrid skip in
        # render_volume, src/testbed_volume.cu:206-392)
        occ_mask = jnp.asarray(
            g.occupancy_dense_128().reshape(-1), jnp.float32)

        @jax.jit
        def run(params, o, d):
            tmin, tmax = ray_aabb_intersect(
                o, d, jnp.asarray(g.aabb_min, jnp.float32),
                jnp.asarray(g.aabb_max, jnp.float32))
            tmin = jnp.maximum(tmin, 0.0)
            span = jnp.maximum(tmax - tmin, 0.0)
            dt = span / opts.n_steps

            def step(carry, i):
                rgb_acc, T = carry
                t = tmin + (i + 0.5) * dt
                p = o + t[:, None] * d
                cell = jnp.clip((p * 128).astype(jnp.int32), 0, 127)
                occ = jnp.take(occ_mask,
                               (cell[:, 0] * 128 + cell[:, 1]) * 128
                               + cell[:, 2], mode="clip")
                out = model.apply(params, p).astype(jnp.float32)
                emit = jnp.maximum(out[:, :3], 0.0)
                sigma = occ * jnp.maximum(out[:, 3], 0.0) * \
                    opts.distance_scale / \
                    jnp.maximum(g.global_majorant, 1e-9)
                alpha = 1.0 - jnp.exp(-sigma * dt)
                rgb_acc = rgb_acc + (T * alpha)[:, None] * emit
                T = T * (1.0 - alpha)
                return (rgb_acc, T), None

            n = o.shape[0]
            (rgb, T), _ = jax.lax.scan(
                step, (jnp.zeros((n, 3)), jnp.ones((n,))),
                jnp.arange(opts.n_steps, dtype=jnp.float32))
            bg = sky_color(d, jnp.asarray(opts.sun_dir))
            rgb = rgb + T[:, None] * bg
            return rgb, 1.0 - T

        return run

    def render(self, camera_matrix: np.ndarray,
               width: Optional[int] = None,
               height: Optional[int] = None) -> np.ndarray:
        from ngp_jax.opt.optimizers import inference_params
        opts = self.opts
        W, H = width or opts.width, height or opts.height
        params = inference_params(self.trainer.params, self.trainer.state,
                                  self.trainer.opt_cfg)
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        u = (xs.reshape(-1) + 0.5) / W - 0.5
        v = (ys.reshape(-1) + 0.5) / H - 0.5
        dirs = np.stack([u * W / opts.focal, v * H / opts.focal,
                         np.ones_like(u)], -1).astype(np.float32)
        d_world = dirs @ np.asarray(camera_matrix[:, :3], np.float32).T
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True) + 1e-9
        o = np.broadcast_to(np.asarray(camera_matrix[:, 3], np.float32),
                            d_world.shape)
        out = np.zeros((H * W, 4), np.float32)
        for i in range(0, H * W, opts.chunk):
            sl = slice(i, min(i + opts.chunk, H * W))
            n = sl.stop - sl.start
            pad = opts.chunk - n
            oc = np.pad(o[sl], ((0, pad), (0, 0)))
            dc = np.pad(d_world[sl], ((0, pad), (0, 0)), constant_values=1.0)
            rgb, opac = self._march_chunk(params, jnp.asarray(oc),
                                          jnp.asarray(dc))
            out[sl, :3] = np.asarray(rgb)[:n]
            out[sl, 3] = np.asarray(opac)[:n]
        return out.reshape(H, W, 4)
