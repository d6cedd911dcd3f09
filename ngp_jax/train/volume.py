"""Neural-volume engine: fit (RGB, density) to a reference density volume.

Re-design of the reference's volume testbed
(ref: src/testbed_volume.cu): training targets come from Woodcock (delta)
tracking random rays through the ground-truth grid toward a procedural sky
+ sun model; the network learns emission (RGB) and density at positions.

The Woodcock walk is vectorized over all rays at once with a fixed-step
``lax.scan`` and per-ray alive masks (instead of the per-thread event loop
with MAX_TRAIN_VERTICES output, ref :88-157). Each scan step is one
majorant-distance event for every ray.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.common import LOSS_SCALE
from ngp_jax.config import autofill_hashgrid_config
from ngp_jax.data.nanovdb import VolumeGrid, load_volume_grid, \
    make_procedural_plume
from ngp_jax.nn.models import EncodedNetwork
from ngp_jax.opt.losses import create_loss
from ngp_jax.opt.optimizers import (AdamConfig, apply_update,
                                    inference_params, init_state)
from ngp_jax.rays.camera import ray_aabb_intersect


def sky_color(dir, sun_dir, sky_col=(0.35, 0.45, 0.7)):
    """Procedural sky + sun (shape of the reference's proc_envmap)."""
    sun = jnp.asarray(sun_dir)
    sun = sun / jnp.linalg.norm(sun)
    d = jnp.sum(dir * sun[None], -1)
    sky = jnp.asarray(sky_col)[None] * (0.6 + 0.4 * jnp.clip(dir[:, 2:3], 0, 1))
    sunlight = jnp.clip(d, 0, 1)[:, None] ** 64 * 4.0
    return sky + sunlight * jnp.asarray([1.0, 0.9, 0.7])[None]


class VolumeTrainer:
    def __init__(self, source, config: dict, seed: int = 1337,
                 batch_size: int = 1 << 17, albedo: float = 0.95,
                 scattering: float = 0.0, distance_scale: float = 100.0):
        if isinstance(source, VolumeGrid):
            self.grid = source
        elif isinstance(source, (str,)) or hasattr(source, "__fspath__"):
            self.grid = load_volume_grid(source)
        else:
            self.grid = VolumeGrid(np.asarray(source))
        self.albedo = albedo
        self.scattering = scattering
        self.distance_scale = distance_scale

        enc_cfg = config["encoding"]
        if "grid" in enc_cfg.get("otype", "").lower():
            enc_cfg = autofill_hashgrid_config(
                enc_cfg, 3, desired_resolution=self.grid.world2index_scale)
        # 4 outputs: RGB + density; output_activation ReLU per config
        self.model = EncodedNetwork(3, 4, enc_cfg, config["network"])
        self.loss = create_loss(config.get("loss", {"otype": "L2"}))
        self.opt_cfg = AdamConfig.from_config(config.get("optimizer", {}),
                                              loss_scale=LOSS_SCALE)
        self.params = self.model.init_params(jax.random.PRNGKey(seed))
        self.state = init_state(self.params, self.opt_cfg)
        self.batch_size = batch_size
        self.training_step = 0
        self.sun_dir = np.array([0.577, 0.577, 0.577], np.float32)

        self.dense_dev = jnp.asarray(self.grid.dense)
        self._train_step = jax.jit(self._train_step_impl,
                                   donate_argnums=(0, 1))

    # ground-truth density lookup (jnp, nearest with jitter like the ref)
    def _gt_density(self, pos, key):
        g = self.grid
        idx = pos * g.world2index_scale + jnp.asarray(
            g.world2index_offset, jnp.float32)
        idx = idx + jax.random.uniform(key, idx.shape)
        i = jnp.clip((idx - jnp.asarray(g.index_bbox_min)).astype(jnp.int32),
                     0, jnp.asarray(self.dense_dev.shape) - 1)
        return self.dense_dev[i[:, 0], i[:, 1], i[:, 2]]

    N_EVENTS = 16   # walk length (ref caps at 128 iters / 6 stored verts)

    def _woodcock_targets(self, key, n):
        """Vectorized MULTI-EVENT Woodcock (delta-tracking) walk
        (ref: volume_generate_training_data_kernel,
        src/testbed_volume.cu:88-157): every majorant event records a
        (pos, gt-density) vertex; at real collisions the walk scatters
        (dir ← normalize(dir·scattering + random)) with probability
        albedo or absorbs (throughput 0); every vertex of a walk receives
        the SAME color target — the procedural-sky radiance along the
        walk's FINAL direction times its throughput — the reference's
        Monte-Carlo in-scattering estimator, restructured as a
        fixed-length lax.scan over events with alive masks."""
        g = self.grid
        E = self.N_EVENTS
        k1, k2, k3, key = jax.random.split(key, 4)
        p0 = jax.random.normal(k1, (n, 3))
        p0 = p0 / jnp.linalg.norm(p0, axis=-1, keepdims=True) * 2.0 + 0.5
        tgt = jax.random.uniform(k2, (n, 3)) * \
            (g.aabb_max - g.aabb_min) + g.aabb_min
        d0 = tgt - p0
        d0 = d0 / jnp.maximum(jnp.linalg.norm(d0, -1, keepdims=True), 1e-9)
        tmin, tmax = ray_aabb_intersect(
            p0, d0, jnp.asarray(g.aabb_min, jnp.float32),
            jnp.asarray(g.aabb_max, jnp.float32))
        pos0 = p0 + (jnp.maximum(tmin, 0.0) + 1e-6)[:, None] * d0
        scale = self.distance_scale / max(g.global_majorant, 1e-9)
        lo = jnp.asarray(g.aabb_min, jnp.float32)
        hi = jnp.asarray(g.aabb_max, jnp.float32)

        def event(carry, k):
            pos, dir, alive, through = carry
            ku, kd, kj, ks = jax.random.split(k, 4)
            step = -jnp.log(jnp.maximum(
                jax.random.uniform(ku, (n,)), 1e-9)) / scale
            pos = pos + step[:, None] * dir
            inside = jnp.all((pos >= lo) & (pos <= hi), -1)
            alive = alive & inside                     # escape ends walk
            dens = self._gt_density(pos, kj)
            record = alive                             # every event trains
            ext = dens / max(g.global_majorant, 1e-9)
            z = jax.random.uniform(kd, (n,))
            scatter = z < ext * self.albedo
            absorb = (~scatter) & (z < ext)
            rnd = jax.random.normal(ks, (n, 3))
            rnd = rnd / jnp.maximum(
                jnp.linalg.norm(rnd, -1, keepdims=True), 1e-9)
            new_dir = dir * self.scattering + rnd
            new_dir = new_dir / jnp.maximum(
                jnp.linalg.norm(new_dir, -1, keepdims=True), 1e-9)
            dir = jnp.where((scatter & alive)[:, None], new_dir, dir)
            through = jnp.where(absorb & alive, 0.0, through)
            alive = alive & ~absorb
            return (pos, dir, alive, through), (pos, dens, record)

        keys = jax.random.split(k3, E)
        (_, dir_f, _, through), (pos, dens, record) = jax.lax.scan(
            event, (pos0, d0, tmax > tmin, jnp.ones((n,))), keys)

        # walk color target: envmap along the final direction × throughput
        # (ref: proc_envmap(dir, ...) * throughput, :147)
        col = sky_color(dir_f, self.sun_dir) * through[:, None]  # (n, 3)
        target = jnp.concatenate(
            [jnp.broadcast_to(col[None], (E, n, 3)), dens[..., None]],
            -1)
        return (pos.reshape(E * n, 3), target.reshape(E * n, 4),
                record.reshape(E * n))

    def _train_step_impl(self, params, state, key):
        k1, key = jax.random.split(key)
        pos, target, valid = self._woodcock_targets(
            k1, self.batch_size // self.N_EVENTS)

        def loss_fn(p):
            pred = self.model.apply(p, pos).astype(jnp.float32)
            per = self.loss(target, pred) * valid[:, None]
            return jnp.sum(per) / jnp.maximum(valid.sum(), 1) * LOSS_SCALE

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state = apply_update(params, grads, state, self.opt_cfg,
                                     self.model.matrix_mask(params))
        return params, state, loss / LOSS_SCALE, key

    def train(self, n_steps: int) -> float:
        loss = 0.0
        if not hasattr(self, "_key"):
            self._key = jax.random.PRNGKey(7)
        for _ in range(n_steps):
            self.params, self.state, loss, self._key = self._train_step(
                self.params, self.state, self._key)
            self.training_step += 1
        return float(loss)

    @functools.cached_property
    def _infer(self):
        @jax.jit
        def run(params, pos):
            return self.model.apply(params, pos).astype(jnp.float32)
        return run

    def rgba_at(self, pos: np.ndarray) -> np.ndarray:
        p = inference_params(self.params, self.state, self.opt_cfg)
        return np.asarray(self._infer(p, jnp.asarray(pos, jnp.float32)))


def default_plume_trainer(config: dict, **kw) -> VolumeTrainer:
    return VolumeTrainer(VolumeGrid(make_procedural_plume()), config, **kw)
