"""pyngp compatibility shim.

Exposes the reference's python module surface (ref: src/python_api.cu:306-888)
as a pure-Python module so scripts written against pyngp run against this
framework:

    import ngp_jax.api.pyngp_shim as ngp
    tb = ngp.Testbed(ngp.TestbedMode.Nerf)

Enums carry the reference's member spellings. The Blender entry points
(``request_nerf_render_sync`` / ``..._async``) live on Testbed via the
multi-NeRF render engine.
"""
from __future__ import annotations

import enum
import threading

import numpy as np

from ngp_jax.api.testbed import Testbed as _Testbed
from ngp_jax.common import BoundingBox  # noqa: F401  (pyngp surface)
from ngp_jax.common import TestbedMode as _Mode


class TestbedMode(enum.Enum):
    Nerf = "nerf"
    Sdf = "sdf"
    Image = "image"
    Volume = "volume"


class RenderMode(enum.IntEnum):
    AO = 0
    Shade = 1
    Normals = 2
    Positions = 3
    Depth = 4
    Distortion = 5
    Cost = 6
    Slice = 7


class RandomMode(enum.IntEnum):
    Random = 0
    Halton = 1
    Sobol = 2
    Stratified = 3


class LossType(enum.IntEnum):
    L2 = 0
    L1 = 1
    Mape = 2
    Smape = 3
    Huber = 4
    LogL1 = 5
    RelativeL2 = 6


class ColorSpace(enum.IntEnum):
    Linear = 0
    SRGB = 1


class TonemapCurve(enum.IntEnum):
    Identity = 0
    ACES = 1
    Hable = 2
    Reinhard = 3


class LensMode(enum.IntEnum):
    Perspective = 0
    OpenCV = 1
    FTheta = 2
    LatLong = 3


class CameraModel(enum.IntEnum):
    # ref order: camera_models.cuh:27-31
    Perspective = 0
    QuadrilateralHexahedron = 1
    SphericalQuadrilateral = 2


class MaskMode(enum.IntEnum):
    Add = 0
    Subtract = 1


class MaskShape(enum.IntEnum):
    Box = 0
    Cylinder = 1
    Sphere = 2
    All = 3


class GroundTruthRenderMode(enum.IntEnum):
    Shade = 0
    Depth = 1


class SDFGroundTruthMode(enum.IntEnum):
    RaytracedMesh = 0
    SpheretracedMesh = 1
    SDFBricks = 2


class NerfActivation(enum.IntEnum):
    # ref order: common.h:114-118
    NoneActivation = 0
    ReLU = 1
    Logistic = 2
    Exponential = 3


class MeshSdfMode(enum.IntEnum):
    Watertight = 0
    Raystab = 1
    PathEscape = 2


# re-export the render-request data model
from ngp_jax.render.multi_nerf import (DownsampleInfo, Mask3D,  # noqa: E402
                                       NerfDescriptor,
                                       RenderCameraProperties,
                                       RenderOutputProperties, RenderRequest)


class Testbed(_Testbed):
    """pyngp.Testbed-shaped wrapper (mode enum spelling, render threads)."""

    def __init__(self, mode=TestbedMode.Nerf, *_args):
        if isinstance(mode, TestbedMode):
            mode = _Mode(mode.value)
        super().__init__(mode)
        self._render_thread = None
        self.m_currently_rendering = False

    # Blender API (ref: python_api.cu:191-261)
    def request_nerf_render_sync(self, request: RenderRequest):
        from ngp_jax.render.multi_nerf import MultiNerfRenderer
        self.m_currently_rendering = True
        try:
            renderer = getattr(self, "_multi_nerf", None)
            if renderer is None:
                renderer = self._multi_nerf = MultiNerfRenderer()
            return renderer.render(request)
        finally:
            self.m_currently_rendering = False

    def request_nerf_render_async(self, request: RenderRequest, callback):
        def work():
            img = self.request_nerf_render_sync(request)
            callback(img)
        self._render_thread = threading.Thread(target=work, daemon=True)
        self._render_thread.start()

    def render_with_rolling_shutter(self, camera_transform_start,
                                    camera_transform_end, rolling_shutter,
                                    width, height, spp=1, linear=True):
        """Per-ray time = A + B·u + C·v + D·t for rolling_shutter
        [A,B,C,D]; transforms are in NeRF (dataset) convention
        (ref: render_with_rolling_shutter_to_cpu, python_api.cu:263 —
        signature order matches the reference binding :584)."""
        from ngp_jax.data.nerf_loader import nerf_matrix_to_ngp
        from ngp_jax.opt.optimizers import inference_params
        ds = self.nerf.training.dataset
        scale = ds.scale if ds is not None else 1.0
        offset = ds.offset if ds is not None else np.zeros(3, np.float32)
        xf_s = nerf_matrix_to_ngp(np.asarray(camera_transform_start,
                                             np.float32), scale, offset)
        xf_e = nerf_matrix_to_ngp(np.asarray(camera_transform_end,
                                             np.float32), scale, offset)
        renderer = self._nerf_renderer(width, height)
        p = inference_params(self.trainer.params, self.trainer.opt_state,
                             self.trainer.opt_cfg)
        focal = getattr(self, "_view_focal", np.array([height, height]))
        img = renderer.render(
            p, self.trainer.grid.bitfield, xf_s, width, height,
            focal=(float(focal[0]), float(focal[1])), spp=spp,
            camera_matrix_end=xf_e,
            rolling_shutter=tuple(float(x) for x in rolling_shutter))
        if not linear:
            from ngp_jax.common import linear_to_srgb_np
            rgb = linear_to_srgb_np(np.clip(img[..., :3], 0, 1))
            img = np.concatenate([rgb, img[..., 3:]], -1)
        return img


def free_temporary_memory():
    import jax
    jax.clear_caches()
