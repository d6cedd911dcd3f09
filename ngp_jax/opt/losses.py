"""Per-element losses matching the reference's NeRF loss menu
(ref: loss_and_gradient + *_loss helpers, src/testbed_nerf.cu:96-195,1263-1278)
and tcnn's Loss otypes used by the sdf/image/volume trainers.

All functions return the per-element loss value; gradients come from JAX
autodiff (the reference hand-derives them — same math).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ngp_jax.common import LossType


def l2(target, pred):
    d = pred - target
    return d * d


def relative_l2(target, pred):
    # The normalizer is treated as a CONSTANT in the reference's gradient
    # (ref: loss kernels return copysign(factor, diff) — no d/d(denominator)
    # term). Autodiff through the denominator would reward inflating |pred|.
    d = pred - target
    factor = jax.lax.stop_gradient(1.0 / (pred * pred + 1e-2))
    return d * d * factor


def l1(target, pred):
    return jnp.abs(pred - target)


def huber(target, pred, alpha: float = 1.0):
    d = jnp.abs(pred - target)
    return jnp.where(d < alpha, 0.5 * d * d / alpha, d - 0.5 * alpha)


def log_l1(target, pred):
    return jnp.log(1.0 + jnp.abs(pred - target))


def mape(target, pred):
    d = jnp.abs(pred - target)
    return d * jax.lax.stop_gradient(1.0 / (jnp.abs(pred) + 1e-2))


def smape(target, pred):
    d = jnp.abs(pred - target)
    return d * jax.lax.stop_gradient(
        1.0 / (0.5 * (jnp.abs(pred) + jnp.abs(target)) + 1e-2))


def loss_fn(loss_type: LossType):
    """NeRF per-ray RGB losses. Note the reference divides Huber by 5
    (ref: src/testbed_nerf.cu loss_and_gradient: case Huber → huber/5)."""
    if loss_type == LossType.L2:
        return l2
    if loss_type == LossType.RELATIVE_L2:
        return relative_l2
    if loss_type == LossType.L1:
        return l1
    if loss_type == LossType.MAPE:
        return mape
    if loss_type == LossType.SMAPE:
        return smape
    if loss_type == LossType.HUBER:
        return lambda t, p: huber(t, p, 0.1) / 5.0
    if loss_type == LossType.LOG_L1:
        return log_l1
    raise ValueError(loss_type)


_TCNN_LOSSES = {
    "l2": l2,
    "relativel2": relative_l2,
    "l1": l1,
    "mape": mape,
    "smape": smape,
    "huber": huber,
    "logl1": log_l1,
}


def create_loss(cfg: dict):
    """tcnn::create_loss equivalent for the sdf/image/volume trainers."""
    otype = cfg.get("otype", "L2").lower().replace("-", "")
    if otype not in _TCNN_LOSSES:
        raise ValueError(f"unknown loss otype {cfg.get('otype')!r}")
    return _TCNN_LOSSES[otype]
