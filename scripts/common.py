"""Shared script helpers: image I/O, error metrics (ref: scripts/common.py
of the reference — PSNR/SSIM/L1/L2 family used by run.py's eval)."""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT_DIR)

from ngp_jax.common import linear_to_srgb_np, srgb_to_linear_np  # noqa: E402
from ngp_jax.data.image_io import (load_binary_image, load_exr,  # noqa
                                   load_stbi, read_image, save_binary_image,
                                   save_exr, save_stbi)


def write_image(path, img):
    path = str(path)
    if path.endswith(".bin"):
        save_binary_image(path, img)
    elif path.endswith(".exr"):
        save_exr(path, img)
    else:
        save_stbi(path, img, from_linear=True)


def mse2psnr(mse: float) -> float:
    return -10.0 * np.log10(max(float(mse), 1e-12))


def compute_error_img(metric: str, img: np.ndarray, ref: np.ndarray):
    metric = metric.upper()
    d = img - ref
    if metric == "MAE":
        return np.abs(d)
    if metric == "MAPE":
        return np.abs(d) / (np.abs(ref) + 1e-2)
    if metric == "SMAPE":
        return 2 * np.abs(d) / (np.abs(ref) + np.abs(img) + 2e-2)
    if metric == "MSE":
        return d * d
    if metric == "MRSE":
        return d * d / (ref * ref + 1e-2)
    raise ValueError(metric)


def compute_error(metric: str, img, ref) -> float:
    return float(np.mean(compute_error_img(metric, np.asarray(img),
                                           np.asarray(ref))))


def luminance(a: np.ndarray) -> np.ndarray:
    return 0.212671 * a[..., 0] + 0.715160 * a[..., 1] + 0.072169 * a[..., 2]


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Grayscale SSIM with 11×11 Gaussian window (standard constants)."""
    from scipy.ndimage import gaussian_filter
    x = luminance(np.asarray(a, np.float64))
    y = luminance(np.asarray(b, np.float64))
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mu_x = gaussian_filter(x, 1.5)
    mu_y = gaussian_filter(y, 1.5)
    sxx = gaussian_filter(x * x, 1.5) - mu_x ** 2
    syy = gaussian_filter(y * y, 1.5) - mu_y ** 2
    sxy = gaussian_filter(x * y, 1.5) - mu_x * mu_y
    s = ((2 * mu_x * mu_y + C1) * (2 * sxy + C2)) / \
        ((mu_x ** 2 + mu_y ** 2 + C1) * (sxx + syy + C2))
    return float(np.mean(s))


def flip(img: np.ndarray, ref: np.ndarray,
         pixels_per_degree: float = 67.02064327658226) -> float:
    """Mean LDR-FLIP perceptual error (full published metric; validated
    numerically against the NVIDIA implementation the reference vendors
    in scripts/flip/ — tests/test_flip.py). Inputs are sRGB in [0, 1];
    the default pixels_per_degree matches the reference's viewing
    conditions (0.7 m distance, 0.7 m wide 3840-px monitor)."""
    from ngp_jax.utils.flip import compute_flip_map
    return float(np.mean(compute_flip_map(
        np.asarray(ref, np.float64)[..., :3],
        np.asarray(img, np.float64)[..., :3], pixels_per_degree)))
