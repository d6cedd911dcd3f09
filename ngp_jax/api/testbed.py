"""Testbed façade — the reference's top-level orchestrator API.

Mirrors the surface of the reference's Testbed class as exposed through
pyngp (ref: src/python_api.cu:306-888 and src/testbed.cu): mode dispatch
by file extension, training loop, offline rendering (render_to_cpu
semantics), snapshot I/O, camera handling, per-mode sub-objects
(``testbed.nerf``, ``testbed.sdf``, ``testbed.image``) with their
training knobs. The GUI/DLSS surface is intentionally absent (headless
framework); everything scripts/run.py and the Blender workflow touch is
here.
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np

from ngp_jax.common import (BoundingBox, EmaMeter, TestbedMode, TonemapCurve,
                            ColorSpace, RenderMode, linear_to_srgb_np,
                            mse2psnr)
from ngp_jax.config import default_config_path, load_network_config


def _resample(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-index resample of (H, W, C) to (height, width, C)."""
    if img.shape[0] == height and img.shape[1] == width:
        return img.copy()
    yi = (np.arange(height) * img.shape[0] // height)
    xi = (np.arange(width) * img.shape[1] // width)
    return img[yi][:, xi].copy()


def mode_from_scene(path) -> Optional[TestbedMode]:
    """Infer the testbed mode from a path (ref: main.cu:142-150 +
    Testbed::handle_file, src/testbed.cu:163-194)."""
    p = Path(path)
    if p.is_dir() or p.suffix == ".json":
        return TestbedMode.NERF
    if p.suffix.lower() in (".obj", ".stl"):
        return TestbedMode.SDF
    if p.suffix.lower() == ".nvdb":
        return TestbedMode.VOLUME
    if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".exr", ".bin", ".bmp",
                            ".tga"):
        return TestbedMode.IMAGE
    if p.suffix == ".msgpack":
        return None  # snapshot; mode comes from the payload
    return None


class _AliasNS(SimpleNamespace):
    """Namespace with reference-parity attribute aliases: the pybind
    surface binds several legacy names onto one member (e.g.
    render_with_camera_distortion → render_with_lens_distortion,
    python_api.cu:749-757)."""

    _aliases: dict = {}

    def __getattr__(self, name):
        real = type(self)._aliases.get(name)
        if real is not None:
            return getattr(self, real)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        object.__setattr__(self, type(self)._aliases.get(name, name), value)


class _NerfNS(_AliasNS):
    _aliases = {
        "render_with_camera_distortion": "render_with_lens_distortion",
        "render_distortion": "render_lens",
        "rendering_min_transmittance": "render_min_transmittance",
    }


class _NerfTrainingNS(SimpleNamespace):
    """testbed.nerf.training: knobs + the dataset-mutation methods the
    reference binds here (python_api.cu:804-853). Methods delegate to the
    owning Testbed (which also re-exports them at top level for older
    pyngp scripts)."""

    def __init__(self, owner, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "_owner", owner)

    @property
    def transforms(self):
        ds = self.dataset
        return ds.xforms if ds is not None else None

    def set_camera_intrinsics(self, frame_idx: int, fx: float = 0.0,
                              fy: float = 0.0, cx: float = -0.5,
                              cy: float = -0.5, k1: float = 0.0,
                              k2: float = 0.0, p1: float = 0.0,
                              p2: float = 0.0):
        self._owner.set_camera_intrinsics(fx, fy, cx, cy, k1, k2, p1, p2,
                                          image_idx=frame_idx)

    def set_camera_extrinsics(self, frame_idx: int, camera_to_world,
                              convert_to_ngp: bool = True):
        self._owner.set_camera_extrinsics(frame_idx, camera_to_world,
                                          convert_to_ngp)

    def get_camera_extrinsics(self, frame_idx: int):
        return self._owner.get_camera_extrinsics(frame_idx)

    def set_image(self, frame_idx: int, img, depth_img=None,
                  depth_scale: float = 1.0):
        self._owner.set_image(frame_idx, img, depth_img, depth_scale)


class Testbed:
    """Drop-in orchestrator: Testbed(mode) → load_training_data → frame()."""

    def __init__(self, mode: TestbedMode | str = TestbedMode.NERF):
        if isinstance(mode, str):
            mode = TestbedMode(mode.lower())
        self.mode = mode
        self.network_config: dict = {}
        self.network_config_path: Optional[Path] = None
        self.trainer = None
        self.data_path: Optional[Path] = None

        # public knobs mirroring pyngp def_readwrite properties
        self.shall_train = True
        self.background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        self.exposure = 0.0
        self.fov_axis = 1
        self.zoom = 1.0
        self.screen_center = np.array([0.5, 0.5], np.float32)
        self.color_space = ColorSpace.LINEAR
        self.tonemap_curve = TonemapCurve.IDENTITY
        self.render_mode = RenderMode.SHADE
        # ref: m_aperture_size / m_slice_plane_z / m_visualized_layer /
        # m_render_aabb / m_render_masks / m_scale (testbed.h)
        self.aperture_size = 0.0
        self.slice_plane_z = 0.0
        self.visualized_layer = 0
        self.render_aabb = None        # BoundingBox or None = training AABB
        self.render_masks = []         # list of multi_nerf.Mask3D
        self.scale = 1.0
        self.dynamic_res = True
        self.dynamic_res_target_fps = 15.0
        self.fixed_res_factor = 1.0
        self.render_groundtruth = False
        self.groundtruth_render_mode = 0
        self.ground_truth_alpha = 1.0   # ref: m_ground_truth_alpha
        self.snap_to_pixel_centers = False
        self.render_near_distance = 0.0
        self.camera_matrix = np.eye(4, dtype=np.float32)[:3]
        self.camera_path = None
        self.training_batch_size = 1 << 18
        self.camera_smoothing = False
        self.autofocus = False
        self.sun_dir = np.array([0.577, 0.577, 0.577], np.float32)
        self.up_dir = np.array([0.0, 1.0, 0.0], np.float32)

        # remaining pyngp readwrite surface (ref: python_api.cu:650-732).
        # GUI-bound knobs are stored but headless-inert; DLSS has no
        # equivalent here and is pinned off.
        self.autofocus_target = np.zeros(3, np.float32)
        self.floor_enable = False
        self.visualize_unit_cube = False
        self.parallax_shift = np.zeros(3, np.float32)   # ref: testbed.h:892
        self.max_level_rand_training = False
        self.visualized_dimension = -1
        self.shall_train_encoding = True
        self.shall_train_network = True
        self.render_camera_model = 0                    # Perspective
        self.camera_spherical_quadrilateral = None
        self.camera_quadrilateral_hexahedron = None
        self.loop_animation = False
        self.display_gui = False
        self.dlss = False
        self.dlss_sharpening = 0.0
        self.keyboard_event_callback = None
        self.render_aabb_to_local = np.eye(3, dtype=np.float32)
        self.aabb = BoundingBox()              # refreshed from the trainer
        self.raw_aabb = BoundingBox()
        self.bounding_radius = 1.0
        # ref: m_relative_focal_length (resolution-relative; fov/fov_xy
        # properties convert, testbed.cu:2153-2167)
        self.relative_focal_length = np.ones(2, np.float32)
        self._training_view = 0

        # per-mode namespaces (populated on load); attribute/alias sets
        # mirror the reference pybind surface (python_api.cu:744-888)
        self.nerf = _NerfNS(
            training=_NerfTrainingNS(
                self,
                random_bg_color=True, linear_colors=False,
                loss_type=2, depth_loss_type=0,  # LossType.Huber
                snap_to_pixel_centers=False, optimize_extrinsics=False,
                optimize_exposure=False, optimize_extra_dims=False,
                optimize_distortion=False, optimize_focal_length=False,
                n_steps_between_cam_updates=16, near_distance=0.2,
                density_grid_decay=0.95, depth_supervision_lambda=0.0,
                sample_image_proportional_to_error=False,
                sample_focal_plane_proportional_to_error=False,
                include_sharpness_in_error=False,
                extrinsic_l2_reg=1e-4, extrinsic_learning_rate=1e-3,
                intrinsic_l2_reg=1e-4, exposure_l2_reg=0.0,
                render_error_overlay=False,
                error_overlay_brightness=0.125,
                n_images_for_training=0, dataset=None,
                world_scale=None, world_offset=None),
            rgb_activation=3, density_activation=2,  # Sigmoid / Exponent
            sharpen=0.0, visualize_cameras=False,
            render_with_lens_distortion=False,
            render_lens=None,
            render_min_transmittance=1e-4,
            glow_mode=0, glow_y_cutoff=0.0,
            cone_angle_constant=1.0 / 256.0)
        self.sdf = SimpleNamespace(
            training=SimpleNamespace(generate_sdf_data_online=True,
                                     surface_offset_scale=1.0),
            mesh_sdf_mode=1, mesh_scale=1.0, analytic_normals=False,
            shadow_sharpness=2048.0, fd_normals_epsilon=1e-3,
            use_triangle_octree=False, brick_level=10, brick_res=0,
            zero_offset=0.0, distance_scale=1.0,
            calculate_iou_online=False, groundtruth_mode=0,
            brdf=SimpleNamespace(metallic=0.0, subsurface=0.0, specular=1.0,
                                 roughness=0.5, sheen=0.0, clearcoat=0.0,
                                 clearcoat_gloss=0.0,
                                 basecolor=np.array([0.8, 0.8, 0.8]),
                                 ambientcolor=np.zeros(3)))
        self.image = SimpleNamespace(
            training=SimpleNamespace(snap_to_pixel_centers=True,
                                     linear_colors=False),
            random_mode="stratified", pos=np.array([0.5, 0.5]))

        self._frame_ms = EmaMeter(0.5)
        self._loss_graph = []          # ref: 256-point loss graph
        self._loss_ema = EmaMeter(1.0)
        self._renderer_cache = {}

    # -- data + network --------------------------------------------------

    @property
    def training_step(self) -> int:
        return self.trainer.training_step if self.trainer else 0

    def load_training_data(self, path):
        """Dispatch by extension (ref: Testbed::load_training_data
        src/testbed.cu:97 + handle_file :163-194)."""
        self.data_path = Path(path)
        inferred = mode_from_scene(path)
        if inferred is not None:
            self.mode = inferred
        if not self.network_config:
            self.reload_network_from_file(default_config_path(self.mode.value))
        else:
            self._build_trainer()

    def reload_network_from_file(self, path):
        self.network_config_path = Path(path)
        self.reload_network_from_json(load_network_config(path))

    def reload_network_from_json(self, config: dict):
        self.network_config = config
        if self.data_path is not None:
            self._build_trainer()

    def _build_trainer(self):
        mode, path, cfg = self.mode, self.data_path, self.network_config
        if mode == TestbedMode.IMAGE:
            from ngp_jax.data.image_io import read_image
            from ngp_jax.train.image import ImageTrainer
            self.trainer = ImageTrainer(read_image(path), cfg,
                                        batch_size=self.training_batch_size)
        elif mode == TestbedMode.NERF:
            from ngp_jax.data.nerf_loader import load_nerf
            from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig
            t0 = self.nerf.training
            if path is None and t0.dataset is not None:
                # in-memory dataset (create_empty_nerf_dataset + set_image
                # — the Blender plugin flow, ref: python_api.cu:545)
                ds = t0.dataset
            else:
                ds = load_nerf(path, scale=t0.world_scale,
                               offset=t0.world_offset)
            t = self.nerf.training
            tcfg = NerfTrainerConfig(
                target_batch_size=self.training_batch_size,
                random_bg_color=t.random_bg_color,
                train_in_linear_colors=t.linear_colors,
                near_distance=t.near_distance,
                density_grid_decay=t.density_grid_decay,
                n_steps_between_grid_updates=16,
                snap_to_pixel_centers=t.snap_to_pixel_centers,
                depth_supervision_lambda=t.depth_supervision_lambda,
                optimize_extrinsics=t.optimize_extrinsics,
                optimize_exposure=t.optimize_exposure,
                optimize_focal_length=t.optimize_focal_length,
                optimize_extra_dims=t.optimize_extra_dims,
                optimize_distortion=t.optimize_distortion,
                sample_image_proportional_to_error=
                    t.sample_image_proportional_to_error,
                sample_focal_plane_proportional_to_error=
                    t.sample_focal_plane_proportional_to_error)
            fixed = int(os.environ.get("NGP_FIXED_RAYS", "0"))
            if fixed:
                # pin the ray count: every distinct n_rays costs a fresh
                # XLA compile
                tcfg.n_rays = fixed
                tcfg.adapt_rays = False
            # CPU-scale escape hatches (small hosts can't run the
            # full-size defaults; used by the synthetic holdout test)
            if os.environ.get("NGP_BATCH"):
                tcfg.target_batch_size = int(os.environ["NGP_BATCH"])
            if os.environ.get("NGP_MARCH_STEPS"):
                tcfg.march_steps = int(os.environ["NGP_MARCH_STEPS"])
            self.trainer = NerfTrainer(ds, cfg, tcfg=tcfg)
            t.dataset = ds
            t.n_images_for_training = ds.n_images
            if ds.render_aabb is not None:
                # dataset-provided crop box (ref: nerf_loader.cu:455-458
                # → m_render_aabb)
                self.render_aabb = SimpleNamespace(
                    min=ds.render_aabb[0], max=ds.render_aabb[1])
            self.set_camera_to_training_view(0)
        elif mode == TestbedMode.SDF:
            from ngp_jax.train.sdf import SdfTrainer
            self.trainer = SdfTrainer(path, cfg,
                                      batch_size=self.training_batch_size,
                                      sign_mode=int(self.sdf.mesh_sdf_mode))
            self.sdf.mesh_scale = self.trainer.mesh_scale
        elif mode == TestbedMode.VOLUME:
            from ngp_jax.train.volume import VolumeTrainer
            self.trainer = VolumeTrainer(path, cfg,
                                         batch_size=self.training_batch_size)
        else:
            raise ValueError(f"unsupported mode {mode}")
        self._renderer_cache = {}
        tr = self.trainer
        if hasattr(tr, "aabb_min"):
            mn = np.asarray(tr.aabb_min, np.float32) * np.ones(3, np.float32)
            mx = mn + np.asarray(tr.aabb_size, np.float32)
            self.aabb = BoundingBox(mn, mx)
            self.raw_aabb = BoundingBox(mn, mx)
            self.bounding_radius = float(np.linalg.norm(self.aabb.diag())
                                         / 2.0)

    # -- training loop ----------------------------------------------------

    def frame(self) -> bool:
        """One iteration of the train loop (ref: Testbed::frame,
        src/testbed.cu:2044; headless → no render unless asked)."""
        t0 = time.time()
        can_lazy_build = (self.network_config
                          and self.nerf.training.dataset is not None)
        if self.shall_train and (self.trainer is not None or can_lazy_build):
            self.train(1)
        self._frame_ms.update((time.time() - t0) * 1e3)
        return True

    def train(self, n_steps: int = 1) -> float:
        if self.trainer is None and self.network_config and \
                self.nerf.training.dataset is not None:
            self._build_trainer()
        loss = self.trainer.train(n_steps)
        self._loss_ema.update(loss)
        self._loss_graph.append(loss)
        if len(self._loss_graph) > 256:
            self._loss_graph = self._loss_graph[-256:]
        return loss

    @property
    def loss_graph(self):
        return list(self._loss_graph)

    @property
    def loss(self) -> float:
        return getattr(self.trainer, "last_loss", 0.0)

    # -- cameras ------------------------------------------------------------

    def set_nerf_camera_matrix(self, m: np.ndarray):
        """Accepts a NeRF-convention 3x4 (ref: pyngp set_nerf_camera_matrix)."""
        from ngp_jax.data.nerf_loader import nerf_matrix_to_ngp
        ds = self.nerf.training.dataset
        self.camera_matrix = nerf_matrix_to_ngp(
            np.asarray(m, np.float32), ds.scale if ds else 1.0,
            ds.offset if ds is not None else np.zeros(3, np.float32))

    def set_camera_matrix(self, m: np.ndarray):
        self.camera_matrix = np.asarray(m, np.float32)[:3, :4]

    def set_camera_to_training_view(self, i: int):
        ds = self.nerf.training.dataset
        if ds is not None:
            i = int(i) % ds.n_images
            self._training_view = i
            self.camera_matrix = ds.xforms[i]
            self._view_focal = ds.focal[i]
            self._view_res = ds.resolution[i]
            self.relative_focal_length = (
                np.asarray(ds.focal[i], np.float32) /
                float(ds.resolution[i][self.fov_axis]))

    def first_training_view(self):
        self.set_camera_to_training_view(0)

    def last_training_view(self):
        ds = self.nerf.training.dataset
        if ds is not None:
            self.set_camera_to_training_view(ds.n_images - 1)

    def previous_training_view(self):
        self.set_camera_to_training_view(self._training_view - 1)

    def next_training_view(self):
        self.set_camera_to_training_view(self._training_view + 1)

    # -- camera helpers (ref: testbed.cu:215-247, 2153-2167) --------------

    @property
    def dof(self):
        return self.aperture_size

    @dof.setter
    def dof(self, v):
        self.aperture_size = float(v)

    @property
    def fov(self) -> float:
        return float(np.degrees(2.0 * np.arctan(
            0.5 / self.relative_focal_length[self.fov_axis])))

    @fov.setter
    def fov(self, val: float):
        self.relative_focal_length = np.full(
            2, 0.5 / np.tan(np.radians(val) / 2.0), np.float32)

    @property
    def fov_xy(self):
        return np.degrees(2.0 * np.arctan(0.5 / self.relative_focal_length))

    @fov_xy.setter
    def fov_xy(self, val):
        v = np.radians(np.asarray(val, np.float32))
        self.relative_focal_length = (0.5 / np.tan(v / 2.0)).astype(
            np.float32)

    def view_pos(self):
        return np.asarray(self.camera_matrix, np.float32)[:3, 3].copy()

    @property
    def view_dir(self):
        return np.asarray(self.camera_matrix, np.float32)[:3, 2].copy()

    @view_dir.setter
    def view_dir(self, d):
        old = self.look_at
        d = np.asarray(d, np.float32)
        d = d / max(float(np.linalg.norm(d)), 1e-12)
        right = np.cross(d, self.up_dir)
        right = right / max(float(np.linalg.norm(right)), 1e-12)
        down = np.cross(d, right)
        down = down / max(float(np.linalg.norm(down)), 1e-12)
        m = np.array(self.camera_matrix, np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2] = right, down, d
        self.camera_matrix = m
        self.look_at = old

    @property
    def look_at(self):
        return self.view_pos() + self.view_dir * self.scale

    @look_at.setter
    def look_at(self, pos):
        m = np.array(self.camera_matrix, np.float32)
        m[:3, 3] += np.asarray(pos, np.float32) - self.look_at
        self.camera_matrix = m

    # -- crop box (ref: testbed.cu:395-449) --------------------------------

    def _crop_aabb(self) -> BoundingBox:
        if self.render_aabb is None:
            return BoundingBox(self.aabb.min, self.aabb.max)
        return BoundingBox(self.render_aabb.min, self.render_aabb.max)

    def crop_box(self, nerf_space: bool = True) -> np.ndarray:
        box = self._crop_aabb()
        to_local = np.asarray(self.render_aabb_to_local, np.float32)
        cen = to_local.T @ box.center()
        radius = box.diag() * 0.5
        rv = np.empty((3, 4), np.float32)
        rv[:, 0] = to_local[0] * radius[0]
        rv[:, 1] = to_local[1] * radius[1]
        rv[:, 2] = to_local[2] * radius[2]
        rv[:, 3] = cen
        if nerf_space:
            from ngp_jax.data.nerf_loader import ngp_matrix_to_nerf
            ds = self.nerf.training.dataset
            scale = ds.scale if ds is not None else 1.0
            offset = (np.asarray(ds.offset) if ds is not None
                      else np.zeros(3))
            rv = ngp_matrix_to_nerf(rv, scale, offset, scale_columns=True)
        return rv

    def set_crop_box(self, matrix, nerf_space: bool = True):
        m = np.asarray(matrix, np.float32)[:3, :4]
        if nerf_space:
            from ngp_jax.data.nerf_loader import nerf_matrix_to_ngp
            ds = self.nerf.training.dataset
            scale = ds.scale if ds is not None else 1.0
            offset = (np.asarray(ds.offset) if ds is not None
                      else np.zeros(3))
            m = nerf_matrix_to_ngp(m, scale, offset, scale_columns=True)
        radius = np.linalg.norm(m[:, :3], axis=0)
        to_local = (m[:, :3] / np.maximum(radius, 1e-12)).T
        cen = to_local @ m[:, 3]
        self.render_aabb_to_local = to_local
        self.render_aabb = SimpleNamespace(min=cen - radius,
                                           max=cen + radius)

    def crop_box_corners(self, nerf_space: bool = True):
        m = self.crop_box(nerf_space)
        return [m[:, :3] @ np.array([(i >> k & 1) * 2 - 1.0
                                     for k in range(3)], np.float32)
                + m[:, 3] for i in range(8)]

    # -- frozen-model playback ------------------------------------------

    def bake_playback(self, D: int = 256, D_inner: int = 512,
                      path: str = ""):
        """Distill the trained NeRF into the dense playback cache
        (render/playback.py) for interactive camera-path frames — this
        framework's answer to the reference's "tens of ms at 1080p"
        playback of trained scenes (ref: docs/index.html:317)."""
        from ngp_jax.render.playback import (bake_playback_cache,
                                             save_playback_cache)
        self._playback_cache = bake_playback_cache(self.trainer, D=D,
                                                   D_inner=D_inner)
        self._playback_renderers = {}
        if path:
            save_playback_cache(path, self._playback_cache)

    def load_playback(self, path: str):
        from ngp_jax.render.playback import load_playback_cache
        self._playback_cache = load_playback_cache(path)
        self._playback_renderers = {}

    def render_playback(self, width: int, height: int,
                        start_time: float = -1.0) -> np.ndarray:
        """Camera-path frame from the playback cache (pinhole + OpenCV
        lens; DoF/rolling-shutter frames fall back to render())."""
        from ngp_jax.render.playback import (PlaybackOptions,
                                             PlaybackRenderer)
        if getattr(self, "_playback_cache", None) is None:
            self.bake_playback()
        if start_time >= 0.0 and self.camera_path is not None:
            kf = self.camera_path.eval(start_time)
            self.camera_matrix = kf.to_matrix()
        ds = self.nerf.training.dataset
        lens = (0.0, 0.0, 0.0, 0.0)
        lmode = "perspective"
        principal = (0.5, 0.5)
        if ds is not None:
            if self.nerf.render_with_lens_distortion and ds.lens_is_opencv:
                lens = tuple(float(x) for x in ds.lens_params[0][:4])
                lmode = "opencv"
            if getattr(ds, "principal", None) is not None:
                principal = tuple(float(x) for x in ds.principal[0])
        key = (width, height, lens, lmode, principal,
               tuple(self.background_color))
        r = self._playback_renderers.get(key)
        if r is None:
            r = PlaybackRenderer(self._playback_cache, PlaybackOptions(
                width=width, height=height, principal=principal,
                lens_params=lens, lens_mode=lmode,
                background=tuple(self.background_color), linear_out=True))
            self._playback_renderers[key] = r
        focal = getattr(self, "_view_focal", np.array([height, height]))
        return r.render(self.camera_matrix, width, height,
                        focal=(float(focal[0]), float(focal[1])))

    # -- rendering ----------------------------------------------------------

    def render(self, width: int, height: int, spp: int = 1,
               linear: bool = True, start_time: float = -1.0,
               end_time: float = -1.0, fps: float = 30.0,
               shutter_fraction: float = 1.0) -> np.ndarray:
        """Offline frame render → (H, W, 4) float32 numpy, matching
        render_to_cpu (ref: src/python_api.cu:132-189) incl. camera-path
        animation via start/end time + log-space motion-blur endpoints."""
        if start_time >= 0.0 and self.camera_path is not None:
            kf = self.camera_path.eval(start_time)
            self.camera_matrix = kf.to_matrix()
        if self.render_groundtruth and self.mode == TestbedMode.NERF:
            # GT overlay (ref: overlay_image/overlay_depth,
            # src/testbed.cu:2856-2885): alpha-blend the training image of
            # the nearest view (with exposure) over the render
            ds = self.nerf.training.dataset
            d = np.linalg.norm(ds.xforms[:, :, 3] -
                               self.camera_matrix[:, 3][None], axis=1)
            view = int(np.argmin(d))
            if int(self.groundtruth_render_mode) == 1 and \
                    ds.depth_images is not None:       # Depth GT
                dep = ds.depth_images[view].astype(np.float32)
                dep = _resample(dep[..., None], height, width)
                img = np.concatenate([np.repeat(dep, 3, -1),
                                      np.ones_like(dep)], -1)
            else:
                img = _resample(ds.images[view].astype(np.float32),
                                height, width)
                img[..., :3] *= 2.0 ** self.exposure
            a = float(getattr(self, "ground_truth_alpha", 1.0))
            if a < 1.0:
                under = self.render_groundtruth_off_frame(
                    width, height, spp, linear)
                img = a * img + (1.0 - a) * under
            if getattr(self.nerf.training, "render_error_overlay", False):
                img[..., :3] = self._error_overlay(view, height, width)
            return img
        if self.mode == TestbedMode.IMAGE:
            img = self.trainer.render(width, height, linear=linear)
            a = np.ones_like(img[..., :1])
            return np.concatenate([img, a], -1)
        if self.mode == TestbedMode.SDF:
            from ngp_jax.render.sdf_render import SdfRenderer, SdfRenderOptions
            opts = SdfRenderOptions(
                width=width, height=height,
                focal=height * 1.0,
                analytic_normals=self.sdf.analytic_normals,
                distance_scale=self.sdf.distance_scale)
            r = SdfRenderer(self.trainer.model, opts)
            from ngp_jax.opt.optimizers import inference_params
            p = inference_params(self.trainer.params, self.trainer.state,
                                 self.trainer.opt_cfg)
            return r.render(p, self.camera_matrix, width, height)
        if self.mode == TestbedMode.NERF:
            from ngp_jax.opt.optimizers import inference_params
            p = inference_params(self.trainer.params, self.trainer.opt_state,
                                 self.trainer.opt_cfg)
            focal = getattr(self, "_view_focal", np.array([height, height]))
            renderer = self._nerf_renderer(width, height)
            start_cam = np.asarray(self.camera_matrix, np.float32)
            # camera-path motion blur: per-spp log-space interpolation of
            # the frame's start/end cameras (ref: render_to_cpu,
            # src/python_api.cu:162-178)
            animated = (start_time >= 0.0 and self.camera_path is not None
                        and end_time >= 0.0 and (end_time != start_time
                                                 or shutter_fraction > 0.0))
            if animated and shutter_fraction > 0.0:
                from ngp_jax.io.camera_path import log_space_lerp
                end_cam = self.camera_path.eval(end_time).to_matrix()
                acc = None
                for i in range(max(spp, 1)):
                    a0 = i / max(spp, 1) * shutter_fraction
                    a1 = (i + 1) / max(spp, 1) * shutter_fraction
                    cam_s = log_space_lerp(start_cam, end_cam, a0)
                    cam_e = log_space_lerp(start_cam, end_cam, a1)
                    f = renderer.render(
                        p, self.trainer.grid.bitfield, cam_s, width, height,
                        focal=(float(focal[0]), float(focal[1])), spp=1,
                        seed=i, camera_matrix_end=cam_e,
                        rolling_shutter=(0.0, 0.0, 0.0, 1.0))
                    acc = f if acc is None else acc + f
                img = acc / max(spp, 1)
                self.camera_matrix = end_cam
            else:
                img = renderer.render(p, self.trainer.grid.bitfield,
                                      start_cam, width, height,
                                      focal=(float(focal[0]),
                                             float(focal[1])),
                                      spp=spp)
            if not linear:
                rgb = linear_to_srgb_np(np.clip(img[..., :3], 0, 1))
                img = np.concatenate([rgb, img[..., 3:]], -1)
            return img
        raise ValueError(f"render unsupported for mode {self.mode}")

    def render_groundtruth_off_frame(self, width, height, spp, linear):
        """The plain render, used as the blend base for ground_truth_alpha
        < 1 (ref: overlay alpha blending)."""
        prev = self.render_groundtruth
        self.render_groundtruth = False
        try:
            return self.render(width, height, spp=spp, linear=linear)
        finally:
            self.render_groundtruth = prev

    def _error_overlay(self, view: int, height: int, width: int):
        """False-color overlay of the accumulated error map
        (ref: overlay_false_color, src/testbed.cu:2888-2907)."""
        err = np.asarray(self.trainer.error_map[view], np.float32)
        avg = max(float(np.maximum(err, 0).mean()), 1e-12)
        bright = float(getattr(self.nerf.training,
                               "error_overlay_brightness", 0.125))
        v = np.clip(err / avg * bright, 0.0, 1.0)
        v = _resample(v[..., None], height, width)[..., 0]
        # blue → green → red heat ramp
        rgb = np.stack([np.clip(2 * v - 1, 0, 1),
                        1.0 - np.abs(2 * v - 1),
                        np.clip(1 - 2 * v, 0, 1)], -1)
        return rgb

    def _nerf_renderer(self, width: int, height: int):
        """Renderer cache keyed by the option set (each distinct option
        tuple owns its compiled chunk kernel)."""
        from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
        ds = self.nerf.training.dataset
        lmode = getattr(ds, "lens_mode", "perspective") \
            if ds is not None else "perspective"
        if lmode in ("ftheta", "latlong"):
            # non-perspective models always render with their lens
            # (ref: render path for FTheta/LatLong)
            lens = tuple(float(x) for x in ds.lens_params[0])
        elif ds is not None and self.nerf.render_with_lens_distortion \
                and ds.lens_is_opencv:
            lens = tuple(float(x) for x in ds.lens_params[0][:4])
            lmode = "opencv"
        else:
            lens = (0.0, 0.0, 0.0, 0.0)
            lmode = "perspective"
        ra_min = ra_max = None
        if getattr(self, "render_aabb", None) is not None:
            ra_min = tuple(float(x) for x in self.render_aabb.min)
            ra_max = tuple(float(x) for x in self.render_aabb.max)
        # dataset principal point (ref: m_screen_center from
        # dataset.principal_point, src/testbed_nerf.cu:2698) — rendering
        # with a centered principal warps the frame vs training rays
        principal = (0.5, 0.5)
        if ds is not None and getattr(ds, "principal", None) is not None:
            principal = tuple(float(x) for x in ds.principal[0])
        opts = RenderOptions(
            width=width, height=height,
            # march what training marched: a renderer marching FURTHER
            # than the trainer integrates sigma in never-supervised
            # range (fog; bit the CPU-scale synthetic holdout runs)
            march_steps=int(self.trainer.tcfg.march_steps),
            fov_axis_focal=getattr(self, "_view_focal", [height, height])[0],
            principal=principal,
            background=tuple(self.background_color), linear_out=True,
            lens_params=lens,
            min_transmittance=self.nerf.render_min_transmittance,
            render_mode=self.render_mode,
            snap_to_pixel_centers=bool(self.snap_to_pixel_centers),
            exposure=float(self.exposure),
            tonemap_curve=self.tonemap_curve,
            aperture_size=float(getattr(self, "aperture_size", 0.0)),
            # ref: render_nerf passes m_slice_plane_z + m_scale as focus_z
            focus_z=float(getattr(self, "slice_plane_z", 0.0))
            + float(getattr(self, "scale", 1.0)),
            render_aabb_min=ra_min, render_aabb_max=ra_max,
            slice_plane_z=float(getattr(self, "slice_plane_z", 0.0)),
            visualized_level=int(getattr(self, "visualized_layer", 0)),
            glow_mode=int(getattr(self.nerf, "glow_mode", 0)),
            glow_y_cutoff=float(getattr(self.nerf, "glow_y_cutoff", 0.0)),
            lens_mode=lmode)
        key = (opts.render_mode, opts.snap_to_pixel_centers, opts.exposure,
               opts.tonemap_curve, opts.background, opts.lens_params,
               opts.min_transmittance, ra_min, ra_max, opts.aperture_size,
               opts.slice_plane_z, opts.visualized_level, opts.glow_mode,
               opts.glow_y_cutoff, opts.lens_mode, opts.principal)
        cache = getattr(self, "_renderer_cache", None)
        if cache is None:
            cache = self._renderer_cache = {}
        if key not in cache:
            masks = list(getattr(self, "render_masks", []) or [])
            env = None
            if ds is not None and ds.envmap is not None:
                # dataset envmap as the render background
                # (ref: envmap read in composite, envmap.cuh:30-105)
                import jax.numpy as jnp
                from ngp_jax.nn.trainable_buffer import Envmap
                env_arr = jnp.asarray(ds.envmap)
                sampler = Envmap(ds.envmap.shape[0], ds.envmap.shape[1])
                env = lambda d: sampler.sample(env_arr, d)
            dist = None
            if "distortion" in self.trainer.cam_params:
                dparams = self.trainer.cam_params["distortion"]
                dgrid = self.trainer.distortion
                dist = lambda uv: dgrid.sample(dparams, uv)
            cache[key] = NerfRenderer.for_trainer(self.trainer, opts,
                                                  masks=masks,
                                                  envmap_sampler=env,
                                                  distortion_sampler=dist)
        return cache[key]

    def render_dynamic(self, width: int, height: int) -> np.ndarray:
        """Dynamic-resolution render: scale resolution to hit
        dynamic_res_target_fps (ref: dynamic-res logic src/testbed.cu:
        1706-1732), then upsample to the requested size."""
        import time as _time
        factor = self.fixed_res_factor if not self.dynamic_res else \
            getattr(self, "_dyn_factor", 1.0)
        w = max(int(width * factor) // 16 * 16, 32)
        h = max(int(height * factor) // 16 * 16, 32)
        t0 = _time.time()
        img = self.render(w, h, spp=1)
        dt = _time.time() - t0
        if self.dynamic_res and dt > 0:
            fps = 1.0 / dt
            adj = np.sqrt(fps / self.dynamic_res_target_fps)
            self._dyn_factor = float(np.clip(factor * adj, 1 / 16, 1.0))
        yi = (np.arange(height) * h // height)
        xi = (np.arange(width) * w // width)
        return img[yi][:, xi]

    def screenshot(self, path, width: int = 1920, height: int = 1080,
                   spp: int = 1):
        from ngp_jax.data.image_io import save_stbi
        img = self.render(width, height, spp=spp, linear=True)
        save_stbi(path, img, from_linear=True)

    # -- eval ----------------------------------------------------------------

    def compute_image_mse(self, quantize_to_byte: bool = False) -> float:
        return self.trainer.compute_mse(quantize_to_byte)

    def calculate_iou(self, n_samples: int = 128 * 1024 * 1024,
                      scale_existing_results_factor: float = 0.0,
                      blocks: int = 1, mode=None) -> float:
        """Sign-agreement IoU at the reference's full sample count
        (ref: src/testbed_sdf.cu:1269 — up to 128M samples; the trainer
        evaluates in chunks so this scales to the full count)."""
        return self.trainer.calculate_iou(n_samples=int(n_samples))

    def gather_histograms(self):
        """Per-hash-level parameter statistics (mean/|mean|/std/min/max)
        — the headless counterpart of the GUI's encoding histograms
        (ref: Testbed::gather_histograms, src/testbed.cu:2962-3006).
        Returns a list of dicts, one per grid level."""
        tr = self.trainer
        params = getattr(tr, "params", None)
        if params is None:
            return []
        import jax
        enc = params.get("pos_encoding", params.get("encoding"))
        if enc is None:
            return []
        table = jax.tree.leaves(enc)[0]
        arr = np.asarray(table)
        model = getattr(tr, "model", None)
        pe = getattr(model, "pos_encoding", getattr(model, "encoding",
                                                    None))
        meta = getattr(pe, "meta", None)
        out = []

        def stats(x):
            x = x.astype(np.float64).ravel()
            return {"mean": float(x.mean()),
                    "abs_mean": float(np.abs(x).mean()),
                    "std": float(x.std()), "min": float(x.min()),
                    "max": float(x.max()), "n": int(x.size)}

        if arr.ndim == 3:                       # blocked (L, R, 128)
            for lv in range(arr.shape[0]):
                out.append({"level": lv, **stats(arr[lv])})
        elif meta is not None and hasattr(meta, "level_offsets"):
            F = meta.n_features_per_level
            for lv, (off, n) in enumerate(zip(meta.level_offsets,
                                              meta.level_params)):
                out.append({"level": lv,
                            **stats(arr[off * F: (off + n) * F])})
        else:
            out.append({"level": 0, **stats(arr)})
        return out

    # -- snapshot / camera path ----------------------------------------------

    def save_snapshot(self, path, include_optimizer_state: bool = False):
        if hasattr(self.trainer, "save_snapshot"):
            import inspect
            kw = {}
            if "include_optimizer_state" in inspect.signature(
                    self.trainer.save_snapshot).parameters:
                kw["include_optimizer_state"] = include_optimizer_state
            self.trainer.save_snapshot(path, self.network_config, **kw)
            return
        # generic trainers (image/sdf/volume): params + EMA only
        import jax
        from ngp_jax.io.snapshot import save_snapshot
        tr = self.trainer
        state = getattr(tr, "state", None) or getattr(tr, "opt_state")
        save_snapshot(
            path, self.network_config,
            params=jax.tree.map(np.asarray, tr.params),
            ema_params=jax.tree.map(np.asarray, state.ema_params),
            training_step=tr.training_step)

    def load_snapshot(self, path):
        import jax
        import jax.numpy as jnp
        from ngp_jax.io.snapshot import (EMA_PARAMS_KEY, PARAMS_KEY,
                                         load_snapshot)
        doc = load_snapshot(path)
        self.network_config = {k: v for k, v in doc.items() if k != "snapshot"}
        if self.trainer is None and self.data_path is not None:
            self._build_trainer()
        if self.trainer is None:
            return
        if hasattr(self.trainer, "load_snapshot_state"):
            self.trainer.load_snapshot_state(path)
            return
        snap = doc["snapshot"]
        tr = self.trainer
        tr.params = jax.tree.map(jnp.asarray, snap[PARAMS_KEY])
        state = getattr(tr, "state", None) or getattr(tr, "opt_state")
        new_state = state._replace(ema_params=jax.tree.map(
            jnp.asarray, snap[EMA_PARAMS_KEY]))
        if hasattr(tr, "state"):
            tr.state = new_state
        else:
            tr.opt_state = new_state
        tr.training_step = int(snap.get("training_step", 0))

    def load_camera_path(self, path):
        from ngp_jax.io.camera_path import CameraPath
        self.camera_path = CameraPath.load(path)

    # -- misc parity helpers ---------------------------------------------------

    # -- per-image camera + dataset mutation (pyngp parity) -----------------

    def set_camera_intrinsics(self, fx: float, fy: float = 0.0,
                              cx: float = -1.0, cy: float = -1.0,
                              k1: float = 0.0, k2: float = 0.0,
                              p1: float = 0.0, p2: float = 0.0,
                              image_idx: int = -1):
        """ref: pyngp Nerf.Training.set_camera_intrinsics."""
        ds = self.nerf.training.dataset
        sel = slice(None) if image_idx < 0 else slice(image_idx, image_idx + 1)
        ds.focal[sel] = [fx, fy or fx]
        if cx >= 0:
            res = ds.resolution[sel].astype(np.float32)
            ds.principal[sel] = np.stack([cx / res[:, 0], cy / res[:, 1]], -1)
        ds.lens_params[sel] = [k1, k2, p1, p2]
        if self.trainer is not None:
            import jax.numpy as jnp
            self.trainer.data["focal"] = jnp.asarray(ds.focal)
            self.trainer.data["principal"] = jnp.asarray(ds.principal)
            self.trainer.data["lens_params"] = jnp.asarray(ds.lens_params)

    def set_camera_extrinsics(self, image_idx: int, matrix: np.ndarray,
                              convert_to_ngp: bool = True):
        """ref: pyngp Nerf.Training.set_camera_extrinsics."""
        from ngp_jax.data.nerf_loader import nerf_matrix_to_ngp
        ds = self.nerf.training.dataset
        m = np.asarray(matrix, np.float32)[:3, :4]
        if convert_to_ngp:
            m = nerf_matrix_to_ngp(m, ds.scale, ds.offset)
        ds.xforms[image_idx] = m
        if self.trainer is not None:
            import jax.numpy as jnp
            self.trainer.data["xforms"] = jnp.asarray(ds.xforms)

    def get_camera_extrinsics(self, image_idx: int,
                              convert_from_ngp: bool = True) -> np.ndarray:
        from ngp_jax.data.nerf_loader import ngp_matrix_to_nerf
        if hasattr(self.trainer, "get_camera_extrinsics"):
            m = self.trainer.get_camera_extrinsics(image_idx)
        else:
            m = self.nerf.training.dataset.xforms[image_idx]
        ds = self.nerf.training.dataset
        return ngp_matrix_to_nerf(m, ds.scale, ds.offset) \
            if convert_from_ngp else m

    def set_image(self, image_idx: int, image: np.ndarray,
                  depth: np.ndarray = None, depth_scale: float = 1.0):
        """Replace a training image in place (ref: pyngp set_image)."""
        ds = self.nerf.training.dataset
        if not isinstance(ds.images, np.ndarray):
            ds.images = np.asarray(ds.images)   # materialize a lazy view
        ds.images[image_idx, : image.shape[0], : image.shape[1]] = image
        # a float edit no longer round-trips to the uint8 copy
        ds.images_u8 = None
        if self.trainer is not None:
            self.trainer.refresh_images()

    def create_empty_nerf_dataset(self, n_images: int, aabb_scale: int = 1,
                                  is_hdr: bool = False, width: int = 64,
                                  height: int = 64):
        """ref: pyngp create_empty_nerf_dataset — a dataset to be filled
        with set_image/set_camera_* before training."""
        from ngp_jax.data.nerf_loader import NerfDataset
        eye = np.tile(np.eye(4, dtype=np.float32)[:3][None], (n_images, 1, 1))
        ds = NerfDataset(
            images=np.zeros((n_images, height, width, 4), np.float32),
            xforms=eye.copy(), xforms_end=eye.copy(),
            focal=np.full((n_images, 2), float(height), np.float32),
            principal=np.full((n_images, 2), 0.5, np.float32),
            resolution=np.tile(np.asarray([[width, height]], np.int32),
                               (n_images, 1)),
            lens_params=np.zeros((n_images, 4), np.float32),
            lens_is_opencv=False, depth_images=None,
            aabb_scale=aabb_scale, scale=1.0,
            offset=np.zeros(3, np.float32), n_extra_learnable_dims=0,
            sharpness=np.ones(n_images, np.float32), paths=[],
            up=np.asarray([0, 0, 1.0], np.float32))
        self.mode = TestbedMode.NERF
        self.nerf.training.dataset = ds
        return ds

    # -- mesh / slice exports ------------------------------------------------

    def compute_marching_cubes_mesh(self, resolution=(256, 256, 256),
                                    thresh: float = 2.5):
        """ref: pyngp compute_marching_cubes_mesh → (verts, colors, normals,
        faces)-style dict."""
        from ngp_jax.render.mesh_export import (extract_mesh_from_density,
                                                vertex_normals)
        tr = self.trainer
        res = resolution[0] if hasattr(resolution, "__len__") else resolution
        if self.mode == TestbedMode.SDF:
            from ngp_jax.render.mesh_export import marching_tetrahedra
            lin = (np.arange(res, dtype=np.float32) + 0.5) / res
            pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"),
                           -1).reshape(-1, 3)
            field = tr.distance_at(pts).reshape(res, res, res)
            v, f = marching_tetrahedra(field, 0.0)
        else:
            v, f = extract_mesh_from_density(
                tr.density_at, res=res, threshold=thresh,
                aabb_min=float(tr.aabb_min), aabb_size=float(tr.aabb_size))
        n = vertex_normals(v, f) if len(v) else np.zeros((0, 3), np.float32)
        if self.mode == TestbedMode.NERF and len(v):
            # true radiance-field vertex colors (ref:
            # compute_mesh_vertex_colors / get_rgba_on_grid)
            from ngp_jax.opt.optimizers import inference_params
            from ngp_jax.render.mesh_export import vertex_colors
            p = inference_params(tr.params, tr.opt_state, tr.opt_cfg)
            c = vertex_colors(tr.model, p, v, float(tr.aabb_min),
                              float(tr.aabb_size))
        else:
            c = np.abs(n)
        return {"V": v, "N": n, "C": c, "F": f}

    def get_rgba_on_grid(self, resolution: int = 128,
                         ray_dir=(0.0, 0.0, 1.0), depth: float = 0.01,
                         density_as_alpha: bool = False) -> np.ndarray:
        """NeRF RGBA on a voxel grid (ref: Testbed::get_rgba_on_grid,
        src/testbed_nerf.cu:3532)."""
        from ngp_jax.opt.optimizers import inference_params
        from ngp_jax.render.mesh_export import rgba_on_grid
        tr = self.trainer
        p = inference_params(tr.params, tr.opt_state, tr.opt_cfg)
        return rgba_on_grid(tr.model, p, resolution, float(tr.aabb_min),
                            float(tr.aabb_size), ray_dir, depth,
                            density_as_alpha)

    def compute_and_save_marching_cubes_mesh(self, filename,
                                             resolution=(256, 256, 256),
                                             thresh: float = 2.5,
                                             unwrap_it: bool = False):
        """ref: compute_and_save_marching_cubes_mesh + save_mesh
        (src/marching_cubes.cu:823-944); ``unwrap_it`` emits the
        quad-atlas UV unwrap + debug .tga texture."""
        from ngp_jax.render.mesh_export import (save_obj,
                                                save_obj_unwrapped,
                                                save_ply)
        m = self.compute_marching_cubes_mesh(resolution, thresh)
        if str(filename).endswith(".ply"):
            save_ply(filename, m["V"], m["F"], m["C"])
        elif unwrap_it:
            save_obj_unwrapped(filename, m["V"], m["F"], m.get("C"),
                               m["N"])
        else:
            save_obj(filename, m["V"], m["F"], m["N"])

    def compute_and_save_png_slices(self, filename_prefix, resolution=256,
                                    thresh: float = 2.5):
        """ref: pyngp compute_and_save_png_slices."""
        from ngp_jax.render.mesh_export import (density_field_on_grid,
                                                save_density_slices)
        tr = self.trainer
        field = density_field_on_grid(tr.density_at, resolution,
                                      float(tr.aabb_min), float(tr.aabb_size))
        save_density_slices(filename_prefix, field)

    def override_sdf_training_data(self, points: np.ndarray,
                                   distances: np.ndarray):
        """ref: pyngp override_sdf_training_data — pin the sample stream."""
        pts = np.asarray(points, np.float32)
        dst = np.asarray(distances, np.float32)
        tr = self.trainer

        def gen():
            idx = tr.rng.integers(0, len(pts), tr.batch_size)
            return pts[idx], dst[idx]
        tr.generate_training_batch = gen

    def n_params(self) -> int:
        import jax
        return sum(int(np.prod(x.shape))
                   for x in jax.tree.leaves(self.trainer.params))

    def n_encoding_params(self) -> int:
        """ref: Testbed::n_encoding_params — grid/encoding table size."""
        import jax
        p = self.trainer.params
        enc = [v for k, v in p.items() if "table" in k or "encoding" in k] \
            if isinstance(p, dict) else []
        if not enc:
            # fall back to the model's encoding meta when params are flat
            meta = getattr(getattr(self.trainer, "model", None),
                           "encoding", None)
            n = getattr(getattr(meta, "meta", None), "n_params", None)
            return int(n) if n else 0
        return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(enc))

    @property
    def params(self) -> np.ndarray:
        """Flat float32 view of all trainable parameters (ref pyngp
        "params" property). Order is this framework's pytree order —
        self-consistent for get→set round trips."""
        import jax
        if self.trainer is None:
            return np.zeros(0, np.float32)
        return np.concatenate([np.asarray(x, np.float32).ravel()
                               for x in jax.tree.leaves(self.trainer.params)])

    @params.setter
    def params(self, flat):
        import jax
        import jax.numpy as jnp
        flat = np.asarray(flat, np.float32)
        leaves, treedef = jax.tree.flatten(self.trainer.params)
        off = 0
        new = []
        for x in leaves:
            n = int(np.prod(x.shape))
            new.append(jnp.asarray(flat[off:off + n].reshape(x.shape),
                                   x.dtype))
            off += n
        if off != flat.size:
            raise ValueError(f"param vector has {flat.size} floats, "
                             f"model needs {off}")
        self.trainer.params = jax.tree.unflatten(treedef, new)

    def reset(self, reset_density_grid: bool = True):
        """ref: pyngp reset → Testbed::reset_network."""
        self.reload_network_from_json(self.network_config)

    def clear_training_data(self):
        self.nerf.training.dataset = None
        self.trainer = None
        self._renderer_cache = {}

    def reset_accumulation(self):
        pass  # progressive accumulation is per-render here

    def want_repl(self) -> bool:
        return False

    # -- GUI surface (headless stubs; ref: python_api.cu:550-562) ---------

    def init_window(self, width: int, height: int, hidden: bool = False,
                    second_window: bool = False):
        raise RuntimeError("ngp_jax is headless: no GLFW/ImGui window. "
                           "Use render()/screenshot() instead.")

    def destroy_window(self):
        pass

    def is_key_pressed(self, key) -> bool:
        return False

    def is_key_down(self, key) -> bool:
        return False

    def is_alt_down(self) -> bool:
        return False

    def is_ctrl_down(self) -> bool:
        return False

    def is_shift_down(self) -> bool:
        return False

    def is_super_down(self) -> bool:
        return False
