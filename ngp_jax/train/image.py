"""Neural-image engine: fit RGB(uv) with hash encoding + MLP.

Re-design of the reference's image testbed
(ref: src/testbed_image.cu): the whole train step — sample generation,
bilinear/snapped target eval, forward, loss, backward, Adam+EMA — is one
jitted function; rendering is a tiled jitted inference.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.common import LOSS_SCALE, linear_to_srgb, srgb_to_linear, mse2psnr
from ngp_jax.config import autofill_hashgrid_config
from ngp_jax.nn.models import EncodedNetwork
from ngp_jax.opt.losses import create_loss
from ngp_jax.opt.optimizers import AdamConfig, AdamState, apply_update, \
    inference_params, init_state
from ngp_jax.rays.sampling import sample_positions


def _eval_image(image: jax.Array, pos: jax.Array, snap: bool,
                linear_colors: bool):
    """Bilinear (or snapped) image lookup matching eval_image_kernel_and_snap
    (ref: src/testbed_image.cu:173-219). image: (H, W, C) linear float32.
    Returns (targets (N,3), possibly-snapped positions)."""
    H, W = image.shape[:2]
    res = jnp.asarray([W, H], jnp.float32)

    def read(ix, iy):
        v = image[iy, ix, :3]
        return v if linear_colors else linear_to_srgb(v)

    if snap:
        pos_int = jnp.floor(pos * res).astype(jnp.int32)
        snapped = (pos_int.astype(jnp.float32) + 0.5) / res
        pos_int = jnp.clip(pos_int, 0, jnp.asarray([W - 1, H - 1]))
        val = read(pos_int[:, 0], pos_int[:, 1])
        return val, snapped
    p = jnp.clip(pos * res - 0.5, 0.0, res - (1.0 + 1e-4))
    p0 = p.astype(jnp.int32)
    w = p - p0.astype(jnp.float32)
    i0 = jnp.clip(p0, 0, jnp.asarray([W - 2, H - 2]))
    x0, y0 = i0[:, 0], i0[:, 1]
    wx, wy = w[:, 0:1], w[:, 1:2]
    val = ((1 - wx) * (1 - wy) * read(x0, y0) +
           wx * (1 - wy) * read(x0 + 1, y0) +
           (1 - wx) * wy * read(x0, y0 + 1) +
           wx * wy * read(x0 + 1, y0 + 1))
    return val, pos


class ImageTrainer:
    """Owns model + optimizer state for a neural image fit."""

    def __init__(self, image: np.ndarray, config: dict, seed: int = 1337,
                 batch_size: int = 1 << 18):
        self.image = jnp.asarray(image[..., :3], jnp.float32)
        self.resolution = (image.shape[1], image.shape[0])  # (W, H)
        enc_cfg = config["encoding"]
        if "grid" in enc_cfg.get("otype", "").lower():
            enc_cfg = autofill_hashgrid_config(
                enc_cfg, n_pos_dims=2,
                desired_resolution=max(self.resolution) / 2.0)
        self.model = EncodedNetwork(2, 3, enc_cfg, config["network"])
        self.loss = create_loss(config.get("loss", {"otype": "L2"}))
        self.opt_cfg = AdamConfig.from_config(config.get("optimizer", {}),
                                              loss_scale=LOSS_SCALE)
        key = jax.random.PRNGKey(seed)
        self.key, init_key = jax.random.split(key)
        self.params = self.model.init_params(init_key)
        self.state = init_state(self.params, self.opt_cfg)
        self.batch_size = batch_size
        self.random_mode = "stratified"
        self.linear_colors = False
        self.snap_to_pixel_centers = False
        self.training_step = 0
        self._train_step = jax.jit(self._train_step_impl,
                                   donate_argnums=(0, 1))

    # -- training ----------------------------------------------------------

    def _train_step_impl(self, params, state: AdamState, key, step):
        pos_key, key = jax.random.split(key)
        pos = sample_positions(self.random_mode, pos_key, self.batch_size, step)
        targets, pos = _eval_image(self.image, pos, self.snap_to_pixel_centers,
                                   self.linear_colors)

        def loss_fn(p):
            pred = self.model.apply(p, pos)
            per_elem = self.loss(targets, pred.astype(jnp.float32))
            return jnp.mean(per_elem) * LOSS_SCALE

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state = apply_update(params, grads, state, self.opt_cfg,
                                     self.model.matrix_mask(params))
        return params, state, loss / LOSS_SCALE, key

    def train(self, n_steps: int) -> float:
        loss = jnp.zeros(())
        for _ in range(n_steps):
            self.params, self.state, loss, self.key = self._train_step(
                self.params, self.state, self.key, self.training_step)
            self.training_step += 1
        return float(loss)

    # -- inference ---------------------------------------------------------

    @functools.cached_property
    def _infer(self):
        @jax.jit
        def run(params, pos):
            return self.model.apply(params, pos).astype(jnp.float32)
        return run

    def eval_positions(self, pos: np.ndarray) -> np.ndarray:
        p = inference_params(self.params, self.state, self.opt_cfg)
        return np.asarray(self._infer(p, jnp.asarray(pos)))

    def render(self, width: Optional[int] = None, height: Optional[int] = None,
               linear: bool = True) -> np.ndarray:
        """Render the fitted image at the given resolution (network output is
        sRGB when linear_colors=False; convert like shade_kernel_image)."""
        W = width or self.resolution[0]
        H = height or self.resolution[1]
        x = (np.arange(W, dtype=np.float32) + 0.5) / W
        y = (np.arange(H, dtype=np.float32) + 0.5) / H
        pos = np.stack(np.meshgrid(x, y), axis=-1).reshape(-1, 2)
        out = np.empty((H * W, 3), np.float32)
        chunk = 1 << 18
        for i in range(0, pos.shape[0], chunk):
            out[i:i + chunk] = self.eval_positions(pos[i:i + chunk])
        img = out.reshape(H, W, 3)
        if linear and not self.linear_colors:
            img = np.asarray(srgb_to_linear(jnp.asarray(img)))
        return img

    def compute_mse(self, quantize_to_byte: bool = False) -> float:
        """MSE over all pixels with snapped targets
        (ref: Testbed::compute_image_mse src/testbed_image.cu:461-524)."""
        W, H = self.resolution
        x = (np.arange(W, dtype=np.float32) + 0.5) / W
        y = (np.arange(H, dtype=np.float32) + 0.5) / H
        pos = np.stack(np.meshgrid(x, y), axis=-1).reshape(-1, 2)
        targets, _ = _eval_image(self.image, jnp.asarray(pos), True,
                                 self.linear_colors)
        targets = np.asarray(targets)
        preds = np.empty_like(targets)
        chunk = 1 << 18
        for i in range(0, pos.shape[0], chunk):
            preds[i:i + chunk] = self.eval_positions(pos[i:i + chunk])
        if quantize_to_byte:
            preds = np.floor(np.clip(preds, 0, 1) * 255.0 + 0.5) / 255.0
        return float(np.mean((preds - targets) ** 2))

    def psnr(self, quantize_to_byte: bool = False) -> float:
        return mse2psnr(self.compute_mse(quantize_to_byte))
