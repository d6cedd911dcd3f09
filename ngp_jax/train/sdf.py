"""SDF engine: fit signed distance(pos) to a mesh.

Re-design of the reference's SDF testbed (ref:
src/testbed_sdf.cu). Ground-truth distances come from the native host BVH
(training-*data generation*, not the hot loop); the network train step runs
jitted on the device. Sample mixture matches the reference
(generate_training_samples_sdf, src/testbed_sdf.cu:1092-1180):
4/8 exact surface points (distance 0), 3/8 surface + logistic-ish
perturbation, 1/8 uniform in the AABB.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.common import LOSS_SCALE, mse2psnr
from ngp_jax.config import autofill_hashgrid_config
from ngp_jax.data.mesh import TriangleBvh, load_mesh
from ngp_jax.nn.models import EncodedNetwork
from ngp_jax.opt.losses import create_loss
from ngp_jax.opt.optimizers import (AdamConfig, apply_update,
                                    inference_params, init_state)


class SdfTrainer:
    """Owns mesh/BVH + model/optimizer state for an SDF fit."""

    def __init__(self, mesh_path, config: dict, seed: int = 1337,
                 batch_size: int = 1 << 18,
                 sign_mode: int = TriangleBvh.MODE_RAYSTAB,
                 use_octree_uniform: Optional[bool] = None,
                 octree_depth: int = 7):
        self.vertices, self.faces, self.mesh_scale, self.mesh_offset = \
            load_mesh(mesh_path)
        self.bvh = TriangleBvh(self.vertices, self.faces)
        self.sign_mode = sign_mode

        enc_cfg = config["encoding"]
        if enc_cfg.get("otype", "").lower() == "takikawa":
            # octree feature encoding (ref: takikawa_encoding.cuh; used when
            # encoding.otype=="Takikawa", src/testbed.cu:2401-2420)
            from ngp_jax.nn.mlp import MLP
            from ngp_jax.nn.takikawa import TakikawaEncoding, TakikawaMeta
            meta = TakikawaMeta(
                start_depth=int(enc_cfg.get("starting_level", 3)),
                max_depth=int(enc_cfg.get("n_levels", 8)),
                n_features_per_level=int(enc_cfg.get("n_features_per_level", 2)))
            surf = TriangleBvh(*load_mesh(mesh_path)[:2]).sample_surface(
                1 << 18, np.random.default_rng(seed))
            encoding = TakikawaEncoding(meta, surf)
            self.tak_encoding = encoding
            net = MLP.from_config(encoding.n_output_dims, 1, config["network"])

            class _TakModel:
                n_input_dims, n_output_dims = 3, 1

                def init_params(self, key):
                    import jax as _j
                    k1, k2 = _j.random.split(key)
                    return {"encoding": encoding.init_params(k1),
                            "net": net.init_params(k2)}

                def matrix_mask(self, params):
                    import jax as _j
                    return {"encoding": _j.tree.map(lambda _: False,
                                                    params["encoding"]),
                            "net": _j.tree.map(lambda _: True,
                                               params["net"])}

                def apply(self, params, x, **kw):
                    return net.apply(params["net"],
                                     encoding.apply(params["encoding"], x))

            self.model = _TakModel()
        else:
            if "grid" in enc_cfg.get("otype", "").lower():
                enc_cfg = autofill_hashgrid_config(enc_cfg, n_pos_dims=3,
                                                   desired_resolution=2048.0)
            self.model = EncodedNetwork(3, 1, enc_cfg, config["network"])
        self.loss = create_loss(config.get("loss", {"otype": "MAPE"}))
        self.opt_cfg = AdamConfig.from_config(config.get("optimizer", {}),
                                              loss_scale=LOSS_SCALE)
        self.params = self.model.init_params(jax.random.PRNGKey(seed))
        self.state = init_state(self.params, self.opt_cfg)
        self.rng = np.random.default_rng(seed)
        self.batch_size = batch_size
        self.training_step = 0
        # perturbation stddevs relative to unit cube (ref: :1120-1132)
        self.perturb_sigma = 1.0 / 1024.0 * 4.0

        # octree-uniform sampling (ref: uniform_octree_sample_kernel,
        # src/testbed_sdf.cu:1118-1143): when an octree/Takikawa encoding
        # is in play, the 1/8 "uniform" samples are drawn inside occupied
        # surface leaves instead of the whole AABB — concentrating the
        # free-space supervision near the surface. A stand-in
        # for the triangle octree: voxelize surface samples at
        # ``octree_depth`` and dilate ±1 voxel (conservative cover of
        # triangle-intersecting leaves).
        if use_octree_uniform is None:
            use_octree_uniform = \
                enc_cfg.get("otype", "").lower() == "takikawa"
        self.use_octree_uniform = bool(use_octree_uniform)
        self.octree_depth = int(octree_depth)
        if self.use_octree_uniform:
            res = 1 << self.octree_depth
            surf = self.bvh.sample_surface(1 << 19, self.rng)
            vox = np.clip((surf * res).astype(np.int64), 0, res - 1)
            occ_set = set()
            for dz in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        v = np.clip(vox + [dx, dy, dz], 0, res - 1)
                        occ_set.update(np.unique(
                            (v[:, 2] * res + v[:, 1]) * res + v[:, 0]))
            flat = np.fromiter(occ_set, np.int64)
            self._octree_leaves = np.stack(
                [flat % res, (flat // res) % res, flat // (res * res)],
                -1).astype(np.float32)
            # ref clamps the perturbation stddev to the leaf size (:1131)
            leaf = 2.0 ** (1 - self.octree_depth)
            self.perturb_sigma = min(self.perturb_sigma, leaf)

        self._train_step = jax.jit(self._train_step_impl,
                                   donate_argnums=(0, 1))

    # -- data generation (host, native BVH) -----------------------------

    def generate_training_batch(self):
        """(positions (B,3), distances (B,)) with the reference's 8-way
        mixture. Surface points get exact distance 0 — no BVH query."""
        B = self.batch_size
        n_surf = B // 2
        n_pert = B * 3 // 8
        n_unif = B - n_surf - n_pert
        surf = self.bvh.sample_surface(n_surf, self.rng)
        d_surf = np.zeros(n_surf, np.float32)
        base = self.bvh.sample_surface(n_pert, self.rng)
        pert = base + self.rng.logistic(
            0.0, self.perturb_sigma, (n_pert, 3)).astype(np.float32)
        pert = np.clip(pert, 0.0, 1.0)
        if self.use_octree_uniform:
            res = 1 << self.octree_depth
            idx = self.rng.integers(0, len(self._octree_leaves), n_unif)
            unif = ((self._octree_leaves[idx] +
                     self.rng.random((n_unif, 3), np.float32)) /
                    res).astype(np.float32)
        else:
            unif = self.rng.random((n_unif, 3), np.float32)
        queries = np.concatenate([pert, unif], 0)
        d_q = self.bvh.signed_distance(queries, mode=self.sign_mode)
        pos = np.concatenate([surf, queries], 0)
        dist = np.concatenate([d_surf, d_q], 0)
        perm = self.rng.permutation(B)  # shuffle (ref: train_sdf shuffle)
        return pos[perm], dist[perm]

    # -- training --------------------------------------------------------

    def _train_step_impl(self, params, state, pos, target):
        def loss_fn(p):
            pred = self.model.apply(p, pos)[:, 0].astype(jnp.float32)
            return jnp.mean(self.loss(target, pred)) * LOSS_SCALE

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state = apply_update(params, grads, state, self.opt_cfg,
                                     self.model.matrix_mask(params))
        return params, state, loss / LOSS_SCALE

    def train(self, n_steps: int) -> float:
        """Pipelined: the NEXT batch's BVH queries run on host threads
        while the device executes the current step (the reference gets
        the same overlap from CUDA streams; here the C++ BVH releases
        the GIL)."""
        from concurrent.futures import ThreadPoolExecutor
        loss = jnp.zeros(())
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self.generate_training_batch)
            for _ in range(n_steps):
                pos, dist = fut.result()
                fut = pool.submit(self.generate_training_batch)
                self.params, self.state, loss = self._train_step(
                    self.params, self.state, jnp.asarray(pos),
                    jnp.asarray(dist))
                self.training_step += 1
        return float(loss)

    # -- inference / eval -------------------------------------------------

    @functools.cached_property
    def _infer(self):
        @jax.jit
        def run(params, pos):
            return self.model.apply(params, pos)[:, 0].astype(jnp.float32)
        return run

    def distance_at(self, pos: np.ndarray, chunk: int = 1 << 18) -> np.ndarray:
        p = inference_params(self.params, self.state, self.opt_cfg)
        pos = np.asarray(pos, np.float32)
        out = np.empty(len(pos), np.float32)
        for i in range(0, len(pos), chunk):
            out[i:i + chunk] = np.asarray(
                self._infer(p, jnp.asarray(pos[i:i + chunk])))
        return out

    def calculate_iou(self, n_samples: int = 1 << 21,
                      seed: int = 0, block: int = 1 << 22) -> float:
        """IoU of sign agreement vs BVH ground truth over random samples
        (ref: Testbed::calculate_iou src/testbed_sdf.cu:1269 — the
        reference evaluates up to 128M samples; chunked here so the full
        count fits in host memory)."""
        rng = np.random.default_rng(seed)
        inter = union = 0
        remaining = int(n_samples)
        while remaining > 0:
            n = min(block, remaining)
            pts = rng.random((n, 3), np.float32)
            gt = self.bvh.signed_distance(pts, mode=self.sign_mode) <= 0
            pred = self.distance_at(pts) <= 0
            if getattr(self, "tak_encoding", None) is not None:
                # octree-encoding parity: the reference counts samples
                # OUTSIDE the octree as correct by assumption — features
                # (and thus meaningful distances) exist only in the
                # surface band (compare_signs_kernel,
                # src/testbed_sdf.cu:464-466)
                inside_oct = np.asarray(self.tak_encoding.contains(
                    jnp.asarray(pts)))
                pred = np.where(inside_oct, pred, gt)
            inter += int(np.logical_and(gt, pred).sum())
            union += int(np.logical_or(gt, pred).sum())
            remaining -= n
        return float(inter) / max(float(union), 1.0)
