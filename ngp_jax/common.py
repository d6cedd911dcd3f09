"""Shared constants, enums and small math helpers.

Re-design of instant-ngp / blender-ngp. Constants mirror the
reference's semantics (see /root/reference/src/testbed_nerf.cu:53-73 and
include/neural-graphics-primitives/common.h) but everything here is pure
Python/JAX — no CUDA idioms.
"""
from __future__ import annotations

import enum
import math

import jax.numpy as jnp
import numpy as np

# --- NeRF marching constants (ref: src/testbed_nerf.cu:53-73) ---------------
NERF_GRIDSIZE = 128            # occupancy grid resolution per cascade
NERF_CASCADES = 8              # number of cascaded occupancy mips
NERF_STEPS = 1024              # finest number of steps per unit length
SQRT3 = math.sqrt(3.0)
STEPSIZE = SQRT3 / NERF_STEPS
MIN_CONE_STEPSIZE = STEPSIZE
# Maximum step size is the width of the coarsest gridsize cell.
MAX_CONE_STEPSIZE = STEPSIZE * (1 << (NERF_CASCADES - 1)) * NERF_STEPS / NERF_GRIDSIZE
NERF_MIN_OPTICAL_THICKNESS = 0.01
NERF_RENDERING_NEAR_DISTANCE = 0.05
# Loss scale keeps small half-precision gradients alive (ref: testbed.h:272).
LOSS_SCALE = 128.0

GRID_VOLUME = NERF_GRIDSIZE ** 3


class TestbedMode(enum.Enum):
    NERF = "nerf"
    SDF = "sdf"
    IMAGE = "image"
    VOLUME = "volume"


class RenderMode(enum.IntEnum):
    """ref: include/neural-graphics-primitives/common.h:80-92."""
    AO = 0
    SHADE = 1
    NORMALS = 2
    POSITIONS = 3
    DEPTH = 4
    DISTORTION = 5
    COST = 6
    SLICE = 7
    ENCODING_VIS = 8


class LossType(enum.Enum):
    L2 = "L2"
    L1 = "L1"
    MAPE = "Mape"
    SMAPE = "Smape"
    HUBER = "Huber"
    LOG_L1 = "LogL1"
    RELATIVE_L2 = "RelativeL2"


def loss_type_from_str(s: str) -> LossType:
    t = s.lower()
    table = {
        "l2": LossType.L2,
        "l1": LossType.L1,
        "mape": LossType.MAPE,
        "smape": LossType.SMAPE,
        "huber": LossType.HUBER,
        "smoothl1": LossType.HUBER,
        "logl1": LossType.LOG_L1,
        "relativel2": LossType.RELATIVE_L2,
    }
    if t not in table:
        raise ValueError(f"unknown loss type {s!r}")
    return table[t]


class ColorSpace(enum.Enum):
    LINEAR = "linear"
    SRGB = "srgb"


class TonemapCurve(enum.Enum):
    IDENTITY = "identity"
    ACES = "aces"
    HABLE = "hable"
    REINHARD = "reinhard"


class NerfActivation(enum.Enum):
    """ref: network_to_rgb/network_to_density, src/testbed_nerf.cu:216-258."""
    NONE = "none"
    RELU = "relu"
    LOGISTIC = "logistic"
    EXPONENTIAL = "exponential"


# --- small math ---------------------------------------------------------------

def srgb_to_linear(c):
    """IEC 61966-2-1, matching ref common_device.cuh srgb_to_linear."""
    c = jnp.asarray(c)
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = jnp.asarray(c)
    return jnp.where(c <= 0.0031308, c * 12.92, 1.055 * jnp.maximum(c, 1e-12) ** (1.0 / 2.4) - 0.055)


def srgb_to_linear_np(c):
    c = np.asarray(c)
    return np.where(c <= 0.04045, c / 12.92, ((np.maximum(c, 0) + 0.055) / 1.055) ** 2.4)


def linear_to_srgb_np(c):
    c = np.asarray(c)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.maximum(c, 1e-12) ** (1.0 / 2.4) - 0.055)


def mse2psnr(mse: float) -> float:
    return -10.0 * math.log10(max(float(mse), 1e-12))


def network_activation(x, activation: NerfActivation):
    """Apply a NeRF output activation (ref: src/testbed_nerf.cu:216-247)."""
    if activation == NerfActivation.NONE:
        return x
    if activation == NerfActivation.RELU:
        return jnp.maximum(x, 0.0)
    if activation == NerfActivation.LOGISTIC:
        return jax_sigmoid(x)
    if activation == NerfActivation.EXPONENTIAL:
        # rgb path clamps to [-10, 10]; density exp is unclamped in the
        # reference but we clamp generously for numerical safety.
        return jnp.exp(jnp.clip(x, -15.0, 15.0))
    raise ValueError(activation)


def jax_sigmoid(x):
    return 1.0 / (1.0 + jnp.exp(-x))


class EmaMeter:
    """EMA-smoothed wall-clock / scalar meter (ref: common.h:253-298)."""

    def __init__(self, half_life: float = 1.0):
        self.alpha = 0.5 ** (1.0 / max(half_life, 1e-6))
        self.value = 0.0
        self.initialized = False

    def update(self, v: float) -> float:
        if not self.initialized:
            self.value = float(v)
            self.initialized = True
        else:
            self.value = self.alpha * self.value + (1.0 - self.alpha) * float(v)
        return self.value


def next_multiple(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


def fresh_zeros(shape, dtype=np.float32):
    """Zeros in a guaranteed-DISTINCT device buffer. Eager ``jnp.zeros``
    of equal shape/dtype can return one shared constant buffer, and a
    jitted step that donates two such leaves fails with "attempt to
    donate the same buffer twice" — device_put of a distinct host array
    per call sidesteps the constant cache."""
    import jax
    return jax.device_put(np.zeros(shape, dtype))


def fresh_zeros_like(x):
    import numpy as _np
    return fresh_zeros(_np.shape(x), x.dtype)


class BoundingBox:
    """Axis-aligned box mirroring the reference's pybind BoundingBox
    surface (ref: src/python_api.cu:409-427)."""

    def __init__(self, min=(0, 0, 0), max=(1, 1, 1)):
        self.min = np.asarray(min, np.float32).copy()
        self.max = np.asarray(max, np.float32).copy()

    def __repr__(self):
        return f"BoundingBox(min={self.min.tolist()}, max={self.max.tolist()})"

    def center(self):
        return (self.min + self.max) / 2

    def diag(self):
        return self.max - self.min

    def contains(self, p):
        p = np.asarray(p)
        return bool(np.all(p >= self.min) and np.all(p <= self.max))

    def enlarge(self, other):
        if isinstance(other, BoundingBox):
            self.min = np.minimum(self.min, other.min)
            self.max = np.maximum(self.max, other.max)
        else:
            self.min = np.minimum(self.min, other)
            self.max = np.maximum(self.max, other)

    def inflate(self, amount):
        self.min -= amount
        self.max += amount

    def intersection(self, other):
        return BoundingBox(np.maximum(self.min, other.min),
                           np.minimum(self.max, other.max))

    def intersects(self, other):
        return bool(np.all(self.max >= other.min) and
                    np.all(self.min <= other.max))

    def relative_pos(self, p):
        return (np.asarray(p) - self.min) / np.maximum(self.diag(), 1e-12)

    def distance(self, p):
        return float(math.sqrt(self.distance_sq(p)))

    def distance_sq(self, p):
        d = np.maximum(np.maximum(self.min - p, 0), p - self.max)
        return float(np.dot(d, d))

    def signed_distance(self, p):
        d = self.distance(p)
        return d if d > 0 else -float(
            np.min(np.minimum(p - self.min, self.max - p)))

    def ray_intersect(self, o, d):
        from ngp_jax.rays.camera import ray_aabb_intersect
        tmin, tmax = ray_aabb_intersect(
            jnp.asarray(o, jnp.float32)[None], jnp.asarray(d, jnp.float32)[None],
            jnp.asarray(self.min), jnp.asarray(self.max))
        return float(tmin[0]), float(tmax[0])

    def get_vertices(self):
        return np.asarray([[self.max[k] if (c >> k) & 1 else self.min[k]
                            for k in range(3)] for c in range(8)], np.float32)
