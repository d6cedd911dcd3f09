"""SDF sphere-tracing renderer.

Equivalent of the reference's SphereTracer + shading path
(ref: src/testbed_sdf.cu:669-988): instead of double-buffered payload
compaction with atomics, each pixel chunk runs a fixed-iteration
``lax.while_loop`` sphere trace with an alive mask. Normals come from the
network input gradient (analytic) or central finite differences
(ref: FiniteDifferenceNormalsApproximator, testbed.h:237-254); shading is
the same sun+floor Lambert/Phong-ish model shape.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.rays.camera import ray_aabb_intersect


@dataclasses.dataclass
class SdfRenderOptions:
    width: int = 512
    height: int = 512
    focal: float = 512.0
    max_iters: int = 128
    distance_scale: float = 1.0      # zero_offset/scale knobs (ref GUI)
    hit_epsilon: float = 5e-4
    chunk: int = 1 << 15
    analytic_normals: bool = False
    fd_normals_epsilon: float = 1e-3
    sun_dir: tuple = (0.577, 0.577, 0.577)
    background: tuple = (1.0, 1.0, 1.0)
    surface_color: tuple = (0.75, 0.6, 0.5)
    # shading (ref: BRDFParams + shadow rays in render_sdf)
    shadows: bool = True
    shadow_sharpness: float = 2048.0
    specular: float = 0.5
    roughness: float = 0.5
    metallic: float = 0.0
    ambient: tuple = (0.15, 0.17, 0.2)


class SdfRenderer:
    def __init__(self, model, opts: Optional[SdfRenderOptions] = None):
        self.model = model
        self.opts = opts or SdfRenderOptions()

    @functools.cached_property
    def _trace_chunk(self):
        opts = self.opts

        @jax.jit
        def run(params, o, d):
            def dist(p):
                return self.model.apply(params, p)[:, 0].astype(jnp.float32) \
                    * opts.distance_scale

            tmin, tmax = ray_aabb_intersect(o, d, 0.0, 1.0)
            tmin = jnp.maximum(tmin, 0.0)
            valid = tmax > tmin

            def body(state):
                t, alive, it = state
                p = o + t[:, None] * d
                sd = dist(p)
                t_new = t + jnp.abs(sd)
                hit = jnp.abs(sd) < opts.hit_epsilon
                escaped = t_new > tmax
                alive_new = alive & ~hit & ~escaped
                t = jnp.where(alive, t_new, t)
                return t, alive_new, it + 1

            def cond(state):
                _, alive, it = state
                return (it < opts.max_iters) & jnp.any(alive)

            t0 = tmin
            t, alive, _ = jax.lax.while_loop(
                cond, body, (t0, valid, jnp.zeros((), jnp.int32)))
            p = o + t[:, None] * d
            sd = dist(p)
            hit = valid & (jnp.abs(sd) < opts.hit_epsilon * 10) & (t < tmax)

            # normals: central finite differences (default, like the ref)
            if opts.analytic_normals:
                g = jax.vmap(jax.grad(lambda q: self.model.apply(
                    params, q[None])[0, 0].astype(jnp.float32)))(p)
            else:
                eps = opts.fd_normals_epsilon
                g = []
                for a in range(3):
                    e = jnp.zeros((1, 3)).at[0, a].set(eps)
                    g.append(dist(p + e) - dist(p - e))
                g = jnp.stack(g, -1)
            n = g / (jnp.linalg.norm(g, axis=-1, keepdims=True) + 1e-9)

            sun = jnp.asarray(opts.sun_dir)
            sun = sun / jnp.linalg.norm(sun)

            # soft shadows: march a secondary ray toward the sun tracking
            # the minimum cone ratio (ref: shadow rays + shadow_sharpness)
            if opts.shadows:
                def shadow_body(state):
                    st, smin, it = state
                    sp = p + st[:, None] * sun[None]
                    sd = dist(sp)
                    smin = jnp.minimum(
                        smin, jnp.clip(opts.shadow_sharpness * sd /
                                       jnp.maximum(st, 1e-4), 0.0, 1.0))
                    return st + jnp.maximum(jnp.abs(sd), 1e-3), smin, it + 1

                def shadow_cond(state):
                    return state[2] < 32

                _, shadow, _ = jax.lax.while_loop(
                    shadow_cond, shadow_body,
                    (jnp.full_like(t, 2e-2), jnp.ones_like(t),
                     jnp.zeros((), jnp.int32)))
            else:
                shadow = jnp.ones_like(t)

            # Lambert + GGX-ish specular with the BRDF knobs
            ndl = jnp.clip(jnp.sum(n * sun[None], -1), 0.0, 1.0)
            h = sun[None] - d
            h = h / (jnp.linalg.norm(h, axis=-1, keepdims=True) + 1e-9)
            ndh = jnp.clip(jnp.sum(n * h, -1), 0.0, 1.0)
            shininess = 2.0 / jnp.maximum(opts.roughness ** 2, 1e-3)
            spec = opts.specular * ndh ** shininess
            base = jnp.asarray(opts.surface_color)[None]
            diffuse = base * (1.0 - opts.metallic)
            light = (ndl * shadow)[:, None]
            col = diffuse * (jnp.asarray(opts.ambient)[None] + light) + \
                (base * opts.metallic + (1 - opts.metallic)) * \
                (spec * shadow * ndl)[:, None]
            bg = jnp.asarray(opts.background)[None]
            rgb = jnp.where(hit[:, None], jnp.clip(col, 0.0, 1.0), bg)
            depth = jnp.where(hit, t, 1e10)
            return rgb, depth, hit

        return run

    def render(self, params, camera_matrix: np.ndarray,
               width: Optional[int] = None,
               height: Optional[int] = None) -> np.ndarray:
        opts = self.opts
        W, H = width or opts.width, height or opts.height
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
            rgb, depth, hit = self._trace_chunk(params, jnp.asarray(oc),
                                                jnp.asarray(dc))
            out[sl, :3] = np.asarray(rgb)[:n]
            out[sl, 3] = np.asarray(hit)[:n]
        return out.reshape(H, W, 4)
