"""Data-parallel NeRF training step over a device mesh.

The reference is single-GPU (ref: README.md:239-241); this is the
first-class scaling design from SURVEY §2.10: rays are embarrassingly
parallel, so the batch axis is sharded over the mesh's ``data`` axis with
``shard_map``. Each device marches/compacts/evaluates ITS OWN rays into a
local sample buffer (no cross-device compaction traffic), then gradients,
counters and error-map deposits are ``psum``'d over the mesh and the
(replicated) Adam update runs identically everywhere.

Round-3 rework: the per-device body IS ``NerfTrainer._train_step_impl``
with ``axis_name="data"`` — one loss implementation for single-device and
DP (the reference has one step driver, ref: src/testbed_nerf.cu:3138-3385).
Hierarchical march, importance sampling, camera/exposure/focal
optimization, depth supervision and the error-map deposit are all
inherited instead of hand-cloned (the round-2 version drifted).

Round-4 fix (advisor): ``err_state`` and ``sharp_grid`` are STEP
ARGUMENTS, not closure captures — the importance-sampling CDFs refresh
between steps and the sharpness grid is live, exactly like the
single-device train loop.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ngp_jax.common import LOSS_SCALE  # noqa: F401  (re-export legacy)


def make_dp_train_step(trainer, mesh: Mesh, n_rays_per_device: int = 1024,
                       samples_per_device: int = 1 << 14):
    """Build a jitted DP train step for the given NerfTrainer and mesh.

    Returns
        step(params, opt_state, cam, cam_m, cam_v, error_map, sharp_grid,
             err_state, bitfield, coarse, grid_mean, key, data)
          → (params, opt_state, cam, cam_m, cam_v, error_map, sharp_grid,
             loss)
    All inputs replicated on the mesh; rays/samples are sharded
    implicitly by giving each device its own RNG stream. Pass the
    trainer's live ``sharpness_grid`` and ``trainer._error_state()`` (or
    ``null_error_state()`` when importance sampling is off) each call so
    the sampling distribution tracks training.
    """
    def per_device(params, opt_state, cam, cam_m, cam_v, error_map,
                   sharp_grid, err_state, bitfield, coarse, grid_mean,
                   key, data):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        params, opt_state, cam, cam_m, cam_v, error_map, sharp_grid, \
            stats, _ = trainer._train_step_impl(
                params, opt_state, cam, cam_m, cam_v, error_map,
                sharp_grid, err_state, bitfield, coarse, grid_mean, key,
                data, n_rays=n_rays_per_device, axis_name="data",
                capacity=samples_per_device)
        return (params, opt_state, cam, cam_m, cam_v, error_map,
                sharp_grid, stats.loss)

    n_in = 13
    sharded = shard_map(
        per_device, mesh=mesh,
        in_specs=tuple(P() for _ in range(n_in)),
        out_specs=tuple(P() for _ in range(8)),
        check_vma=False)

    return jax.jit(sharded)


def null_error_state():
    """err_state placeholder when importance sampling is disabled."""
    return {"cdf_x": None, "cdf_y": None, "cdf_img": None}


class DpNerfTrainer:
    """Full production NeRF training under data parallelism.

    Unlike ``make_dp_train_step`` (a bare per-step function), this wraps
    the COMPLETE single-device train loop — warmup full sweeps, in-chunk
    occupancy-grid maintenance, error-map CDF rebuild cadence, sharpness
    decay, rays/batch adaptation, snapshots — by overriding only the
    chunk compiler: the same scan body built by
    ``NerfTrainer._build_chunk`` runs under ``shard_map`` with every
    input replicated, per-device RNG folds for ray sampling, and psum'd
    gradients/counters (ref: the reference has ONE step driver,
    src/testbed_nerf.cu:3138-3385; multi-GPU is out of scope there,
    README.md:239-241 — DP scale-out is this framework's answer
    from SURVEY §2.10).

    Semantics: ``tcfg.n_rays`` and ``tcfg.target_batch_size`` are
    PER-DEVICE budgets; the global batch is N× larger at identical step
    time, which is the entire scale-out claim for the <60 s fox bar.
    Grid updates run on the pre-fold RNG key (identical inputs → every
    device computes the SAME grid; replicated by construction), so DP(1)
    is step-for-step identical to the single-device trainer and DP(N)
    differs only by the N-fold larger sampled batch.
    """

    def __init__(self, dataset, config: dict, mesh: Mesh, **kw):
        from ngp_jax.train.nerf import NerfTrainer

        outer = self

        class _Impl(NerfTrainer):
            def _chunk_fn(self, n_rays, T, with_grid_update=False,
                          full_sweep=False, capacity=0):
                key_ = (n_rays, T, with_grid_update, full_sweep, capacity,
                        "dp")
                fn = self._chunk_fns.get(key_)
                if fn is not None:
                    return fn
                chunk = self._build_chunk(n_rays, T, with_grid_update,
                                          full_sweep, capacity,
                                          axis_name="data")
                n_args = 12 if self.tcfg.dynamic_rays else 11
                sharded = shard_map(
                    chunk, mesh=outer.mesh,
                    in_specs=tuple(P() for _ in range(n_args)),
                    out_specs=P(), check_vma=False)
                fn = jax.jit(sharded,
                             donate_argnums=(0, 1, 2, 3, 4, 5, 6, 8))
                self._chunk_fns[key_] = fn
                return fn

            def _fetch_stats(self, loss_dev, measured_dev, segs_dev,
                             n_rays):
                # counters are psum'd GLOBAL totals; the adaptation law
                # and the seg-capacity warning reason about PER-DEVICE
                # budgets (n_rays / target_batch_size are per-device)
                nd = outer.n_devices
                return super()._fetch_stats(
                    loss_dev, int(measured_dev) // nd,
                    int(segs_dev) // nd, n_rays)

        self.mesh = mesh
        self.n_devices = int(np.prod(mesh.devices.shape))
        self._impl = _Impl(dataset, config, **kw)

    def __getattr__(self, name):
        return getattr(self._impl, name)

    def train(self, n_steps: int) -> float:
        with self.mesh:
            return self._impl.train(n_steps)

