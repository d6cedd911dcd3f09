"""Optimizer stack matching the reference's tcnn configuration:
Ema( ExponentialDecay( Adam ) )  (ref: configs/*/base.json; consumed at
src/testbed.cu:2337-2422 via tcnn::create_optimizer).

Design: a single jitted pytree update. Components:
- Adam with tcnn semantics: eps=1e-15, relative L2 regularization applied to
  "matrix" params (MLP weight matrices) only, loss-scale division at update.
- ExponentialDecay: staircase lr decay starting at decay_start, one factor of
  decay_base every decay_interval steps, stopping at decay_end.
- Ema: exponential moving average of params kept alongside; inference uses
  the EMA copy (tcnn EmaOptimizer behavior).

State/params are pytrees; param-class masking (matrix vs non-matrix, for the
hash table) is expressed with a boolean pytree, the functional analog of
tcnn's optimize_matrix_params / optimize_non_matrix_params split
(ref: src/testbed.cu:2556-2563).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class AdamState(NamedTuple):
    step: jax.Array
    mu: Any
    nu: Any
    ema_params: Any  # EMA copy of params (None-like zeros if disabled)


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    learning_rate: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.99
    epsilon: float = 1e-15
    l2_reg: float = 1e-6
    # ExponentialDecay wrapper (0 interval → disabled)
    decay_start: int = 0
    decay_interval: int = 0
    decay_base: float = 1.0
    decay_end: int = 2 ** 31 - 1
    # Ema wrapper (0 → disabled)
    ema_decay: float = 0.0
    loss_scale: float = 1.0
    # tcnn Adam semantics: parameters whose gradient is EXACTLY zero this
    # step are skipped entirely — no moment decay, no parameter motion.
    # Crucial for the hash table, where each step touches only the rows
    # its samples hit; vanilla Adam would keep moving untouched entries on
    # stale momentum while their vhat denominators decay.
    skip_zero_grad: bool = True

    @classmethod
    def from_config(cls, cfg: dict, loss_scale: float = 1.0) -> "AdamConfig":
        """Parse the nested tcnn optimizer JSON (Ema→ExponentialDecay→Adam)."""
        ema_decay = 0.0
        decay = {}
        node = cfg
        while True:
            otype = node.get("otype", "Adam").lower()
            if otype == "ema":
                ema_decay = float(node.get("decay", 0.99))
                node = node["nested"]
            elif otype == "exponentialdecay":
                decay = node
                node = node["nested"]
            else:
                break
        return cls(
            learning_rate=float(node.get("learning_rate", 1e-3)),
            beta1=float(node.get("beta1", 0.9)),
            beta2=float(node.get("beta2", 0.999)),
            epsilon=float(node.get("epsilon", 1e-8)),
            l2_reg=float(node.get("l2_reg", 0.0)),
            decay_start=int(decay.get("decay_start", 0)),
            decay_interval=int(decay.get("decay_interval", 0)),
            decay_base=float(decay.get("decay_base", 1.0)),
            decay_end=int(decay.get("decay_end", 2 ** 31 - 1)),
            ema_decay=ema_decay,
            loss_scale=loss_scale,
        )


def init_state(params: Any, cfg: AdamConfig) -> AdamState:
    # fresh_zeros_like: mu and nu of one param leaf have equal
    # shape/dtype, and the whole state is donated by the train chunk —
    # shared constant buffers would be donated twice (common.fresh_zeros)
    from ngp_jax.common import fresh_zeros, fresh_zeros_like
    # always a COPY: with ema_decay == 0 aliasing ema_params to params
    # donates the same buffer twice in the donating train chunk
    ema = jax.tree.map(jnp.array, params)
    return AdamState(step=fresh_zeros((), jnp.int32),
                     mu=jax.tree.map(fresh_zeros_like, params),
                     nu=jax.tree.map(fresh_zeros_like, params),
                     ema_params=ema)


def lr_at_step(cfg: AdamConfig, step: jax.Array) -> jax.Array:
    lr = jnp.asarray(cfg.learning_rate, jnp.float32)
    if cfg.decay_interval > 0 and cfg.decay_base != 1.0:
        eff = jnp.minimum(step, cfg.decay_end)
        n_decays = jnp.maximum(0, (eff - cfg.decay_start) // cfg.decay_interval + 1)
        n_decays = jnp.where(eff < cfg.decay_start, 0, n_decays)
        lr = lr * jnp.power(jnp.float32(cfg.decay_base), n_decays.astype(jnp.float32))
    return lr


def apply_update(
    params: Any,
    grads: Any,
    state: AdamState,
    cfg: AdamConfig,
    matrix_mask: Optional[Any] = None,
    lr_scale: float | jax.Array = 1.0,
) -> tuple[Any, AdamState]:
    """One Adam(+decay+EMA) step. ``matrix_mask``: pytree of bools marking
    params that receive L2 regularization (MLP weights)."""
    step = state.step + 1
    lr = lr_at_step(cfg, step) * lr_scale
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - jnp.power(jnp.float32(b1), step.astype(jnp.float32))
    bc2 = 1.0 - jnp.power(jnp.float32(b2), step.astype(jnp.float32))
    inv_ls = 1.0 / cfg.loss_scale

    if matrix_mask is None:
        matrix_mask = jax.tree.map(lambda _: True, params)

    def upd(p, g, m, v, is_matrix):
        g_raw = g
        g = g.astype(jnp.float32) * inv_ls
        if cfg.l2_reg > 0.0 and is_matrix:
            g = g + cfg.l2_reg * p
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        p_new = p - lr * mhat / (jnp.sqrt(vhat) + cfg.epsilon)
        if cfg.skip_zero_grad and not is_matrix:
            # tcnn: untouched entries (g == 0 exactly) freeze in place —
            # applied to non-matrix params (hash table, envmap grids);
            # MLP weight grads are never exactly zero
            touched = g_raw != 0
            p_new = jnp.where(touched, p_new, p)
            m_new = jnp.where(touched, m_new, m)
            v_new = jnp.where(touched, v_new, v)
        return p_new, m_new, v_new

    flat_p, treedef = jax.tree.flatten(params)
    flat_g = treedef.flatten_up_to(grads)
    flat_m = treedef.flatten_up_to(state.mu)
    flat_v = treedef.flatten_up_to(state.nu)
    flat_mask = treedef.flatten_up_to(matrix_mask)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, msk in zip(flat_p, flat_g, flat_m, flat_v, flat_mask):
        np_, nm, nv = upd(p, g, m, v, msk)
        new_p.append(np_)
        new_m.append(nm)
        new_v.append(nv)
    params_out = jax.tree.unflatten(treedef, new_p)

    if cfg.ema_decay > 0.0:
        d = cfg.ema_decay
        ema = jax.tree.map(lambda e, p: d * e + (1.0 - d) * p,
                           state.ema_params, params_out)
    else:
        ema = params_out

    return params_out, AdamState(
        step=step,
        mu=jax.tree.unflatten(treedef, new_m),
        nu=jax.tree.unflatten(treedef, new_v),
        ema_params=ema,
    )


def inference_params(params: Any, state: AdamState, cfg: AdamConfig) -> Any:
    """Params used for inference — the EMA copy when Ema is configured
    (tcnn EmaOptimizer serves EMA'd params to inference)."""
    return state.ema_params if cfg.ema_decay > 0.0 else params
