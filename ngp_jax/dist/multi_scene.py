"""Multi-scene batch orchestration across a device mesh.

BASELINE config #5: a Blender-exported multi-scene batch across several
devices — one NeRF per device group, embarrassingly parallel
(SURVEY §2.10). The reference has no equivalent (single GPU); this is the
scheduling layer that maps scenes → mesh slices and drives their trainers
round-robin so compiles/dispatches overlap.

Groups of more than one device run the data-parallel NeRF step
(``make_dp_train_step``: per-device ray shard + gradient psum over the mesh)
within the group; single-device groups run the plain trainer. On a single
chip this degrades gracefully to sequential training with shared
compilation caches (same-shape scenes reuse the same executable).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import jax
import numpy as np


@dataclasses.dataclass
class SceneJob:
    name: str
    scene_path: str
    config: dict
    n_steps: int = 2000
    snapshot_out: Optional[str] = None
    devices: Optional[list] = None      # device group assigned
    dataset: Optional[object] = None    # preloaded NerfDataset (optional)
    trainer_config: Optional[object] = None  # NerfTrainerConfig override


class _DpGroupRunner:
    """Drives one trainer's state with the in-group DP step (grid updates
    interleaved like NerfTrainer.train, stats fetched once per slice)."""

    def __init__(self, trainer, devices):
        from ngp_jax.dist.mesh import make_mesh
        from ngp_jax.dist.nerf_dp import make_dp_train_step

        self.tr = trainer
        self.mesh = make_mesh(n_data=len(devices), devices=devices)
        tc = trainer.tcfg
        n_per_dev = max(tc.n_rays // len(devices), 128)
        s_per_dev = max(tc.target_batch_size // len(devices), 1024)
        self.dp_step = make_dp_train_step(trainer, self.mesh,
                                          n_rays_per_device=n_per_dev,
                                          samples_per_device=s_per_dev)

    @property
    def training_step(self):
        return self.tr.training_step

    def train(self, k: int) -> float:
        from ngp_jax.dist.nerf_dp import null_error_state
        tr = self.tr
        use_err = (tr.tcfg.sample_image_proportional_to_error or
                   tr.tcfg.sample_focal_plane_proportional_to_error)
        loss = None
        with self.mesh:
            for _ in range(k):
                if tr.training_step % \
                        tr.tcfg.n_steps_between_grid_updates == 0:
                    tr.key, kk = jax.random.split(tr.key)
                    tr.grid = tr._grid_update(
                        tr.params, tr.grid, kk,
                        full_sweep=tr.training_step < 256)
                tr.key, kk = jax.random.split(tr.key)
                err_state = tr._error_state() if use_err \
                    else null_error_state()
                (tr.params, tr.opt_state, tr.cam_params, tr.cam_m,
                 tr.cam_v, tr.error_map, tr.sharpness_grid,
                 loss) = self.dp_step(
                    tr.params, tr.opt_state, tr.cam_params, tr.cam_m,
                    tr.cam_v, tr.error_map, tr.sharpness_grid, err_state,
                    tr.grid.bitfield, tr.grid.coarse, tr.grid.mean, kk,
                    tr.data)
                tr.training_step += 1
        out = float(loss) if loss is not None else 0.0
        tr.last_loss = out
        return out

    def save_snapshot(self, path, config):
        self.tr.save_snapshot(path, config)


class MultiSceneOrchestrator:
    """Round-robin trainer driver over scene→device-group assignments."""

    def __init__(self, jobs: List[SceneJob], devices=None,
                 steps_per_slice: int = 32):
        self.jobs = list(jobs)
        self.devices = devices if devices is not None else jax.devices()
        self.steps_per_slice = steps_per_slice
        self.trainers: Dict[str, object] = {}
        # block-partition devices over jobs (one group per scene)
        n = max(len(self.jobs), 1)
        per = max(len(self.devices) // n, 1)
        for i, job in enumerate(self.jobs):
            job.devices = self.devices[i * per: (i + 1) * per] or \
                [self.devices[i % len(self.devices)]]

    def _trainer(self, job: SceneJob):
        if job.name not in self.trainers:
            from ngp_jax.train.nerf import NerfTrainer
            ds = job.dataset
            if ds is None:
                from ngp_jax.data.nerf_loader import load_nerf
                ds = load_nerf(job.scene_path)
            with jax.default_device(job.devices[0]):
                tr = NerfTrainer(ds, job.config, tcfg=job.trainer_config)
            if len(job.devices) > 1:
                tr = _DpGroupRunner(tr, job.devices)
            self.trainers[job.name] = tr
        return self.trainers[job.name]

    def run(self, progress: Optional[Callable] = None):
        """Drive all jobs to completion, slice-interleaved so host-side
        work for one scene overlaps device work for the others."""
        active = {j.name: j for j in self.jobs}
        while active:
            done = []
            for name, job in active.items():
                tr = self._trainer(job)
                k = min(self.steps_per_slice, job.n_steps - tr.training_step)
                if isinstance(tr, _DpGroupRunner):
                    loss = tr.train(k)
                else:
                    with jax.default_device(job.devices[0]):
                        loss = tr.train(k)
                if progress:
                    progress(name, tr.training_step, loss)
                if tr.training_step >= job.n_steps:
                    if job.snapshot_out:
                        tr.save_snapshot(job.snapshot_out, job.config)
                    done.append(name)
            for name in done:
                del active[name]
        return self.trainers
