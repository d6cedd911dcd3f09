"""Tensor-parallel image training: the gigapixel regime (SURVEY §2.10 TP).

For images whose hash table dwarfs a single device's memory, the blocked
grid's (L, R, 128) table is ROW-SHARDED over the mesh's ``model`` axis;
every device computes the global lookup geometry, contributes partial
features from the rows it owns, and one psum over the mesh combines them
(``make_tp_blocked_encode``). Gradients flow back shard-locally, so table
memory AND backward bandwidth scale 1/M. The MLP is tiny and replicated;
the sample axis shards over ``data`` (DP×TP).

The reference is single-GPU and holds the gigapixel table whole
(ref: src/testbed_image.cu + scripts/scenes.py gigapixel entries); this is
the multi-device scale-out of that workload.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ngp_jax.common import LOSS_SCALE, mse2psnr
from ngp_jax.config import autofill_hashgrid_config
from ngp_jax.dist.mesh import make_tp_blocked_encode
from ngp_jax.kernels.blocked_grid import BlockedGridMeta
from ngp_jax.nn.mlp import MLP
from ngp_jax.opt.losses import create_loss
from ngp_jax.opt.optimizers import (AdamConfig, apply_update,
                                    inference_params, init_state)
from ngp_jax.rays.sampling import sample_positions
from ngp_jax.train.image import _eval_image


class TpImageTrainer:
    """Image fit with the encoding table TP-sharded over ``mesh.model``."""

    def __init__(self, image: np.ndarray, config: dict, mesh: Mesh,
                 seed: int = 1337, batch_size: int = 1 << 16):
        self.mesh = mesh
        self.image = jnp.asarray(image[..., :3], jnp.float32)
        self.resolution = (image.shape[1], image.shape[0])
        enc_cfg = autofill_hashgrid_config(
            dict(config["encoding"]), n_pos_dims=2,
            desired_resolution=max(self.resolution) / 2.0)
        self.meta = BlockedGridMeta.from_hashgrid_config(enc_cfg)
        M = mesh.shape["model"]
        if self.meta.rows % M:
            raise ValueError(f"rows {self.meta.rows} not divisible by "
                             f"model axis {M}")
        self.mlp = MLP.from_config(self.meta.n_output_dims, 3,
                                   config["network"])
        self.loss = create_loss(config.get("loss", {"otype": "L2"}))
        self.opt_cfg = AdamConfig.from_config(config.get("optimizer", {}),
                                              loss_scale=LOSS_SCALE)
        self.encode = make_tp_blocked_encode(self.meta, mesh,
                                             data_sharded=True)

    # the 2-tuple param pytree: {"table": sharded, "net": replicated}
        key = jax.random.PRNGKey(seed)
        self.key, k_t, k_n = jax.random.split(key, 3)
        tab_sh = NamedSharding(mesh, P(None, "model", None))
        rep = NamedSharding(mesh, P())
        self.params = {
            "table": jax.device_put(self.meta.init_params(k_t), tab_sh),
            "net": jax.device_put(self.mlp.init_params(k_n), rep),
        }
        self.state = init_state(self.params, self.opt_cfg)
        self.matrix_mask = {"table": False,
                            "net": jax.tree.map(lambda _: True,
                                                self.params["net"])}
        self.batch_size = batch_size
        self.training_step = 0
        self.linear_colors = False

        def step(params, state, key, step_i):
            pos_key, key = jax.random.split(key)
            pos = sample_positions("stratified", pos_key, self.batch_size,
                                   step_i)
            pos = jax.lax.with_sharding_constraint(
                pos, NamedSharding(mesh, P("data")))
            targets, pos = _eval_image(self.image, pos, False,
                                       self.linear_colors)

            def loss_fn(p):
                feat = self.encode(p["table"], pos)
                pred = self.mlp.apply(p["net"], feat).astype(jnp.float32)
                return jnp.mean(self.loss(targets, pred)) * LOSS_SCALE

            loss, grads = jax.value_and_grad(loss_fn)(params)
            params, state = apply_update(params, grads, state,
                                         self.opt_cfg, self.matrix_mask)
            return params, state, loss / LOSS_SCALE, key

        self._train_step = jax.jit(step, donate_argnums=(0, 1))

    def train(self, n_steps: int) -> float:
        loss = jnp.zeros(())
        with self.mesh:
            for _ in range(n_steps):
                self.params, self.state, loss, self.key = self._train_step(
                    self.params, self.state, self.key, self.training_step)
                self.training_step += 1
        return float(loss)

    def eval_positions(self, pos: np.ndarray) -> np.ndarray:
        p = inference_params(self.params, self.state, self.opt_cfg)
        with self.mesh:
            feat = self.encode(p["table"], jnp.asarray(pos))
            return np.asarray(self.mlp.apply(p["net"], feat).astype(
                jnp.float32))

    def psnr(self, n: int = 1 << 16, seed: int = 0) -> float:
        """PSNR over a random snapped sample of pixels (full-image eval is
        host-loop territory for gigapixel inputs)."""
        rng = np.random.default_rng(seed)
        pos = rng.random((n, 2), np.float32)
        targets, spos = _eval_image(self.image, jnp.asarray(pos), True,
                                    self.linear_colors)
        preds = self.eval_positions(np.asarray(spos))
        return mse2psnr(float(np.mean(
            (preds - np.asarray(targets)) ** 2)))

    def table_shard_bytes(self) -> int:
        """Per-device bytes of the table — the TP memory claim."""
        shard = self.params["table"].addressable_shards[0]
        return int(np.prod(shard.data.shape) * 4)
