"""Optimizer stack: config parsing, staircase decay, EMA inference params,
matrix-only L2 regularization, loss-scale neutrality."""
import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.opt.optimizers import (AdamConfig, apply_update,
                                    inference_params, init_state, lr_at_step)


def test_nested_config_parsing():
    cfg = AdamConfig.from_config({
        "otype": "Ema", "decay": 0.95,
        "nested": {"otype": "ExponentialDecay", "decay_start": 20000,
                   "decay_interval": 10000, "decay_base": 0.33,
                   "nested": {"otype": "Adam", "learning_rate": 1e-2,
                              "beta1": 0.9, "beta2": 0.99,
                              "epsilon": 1e-15, "l2_reg": 1e-6}}})
    assert cfg.ema_decay == 0.95
    assert cfg.learning_rate == 1e-2
    assert cfg.epsilon == 1e-15
    assert cfg.decay_start == 20000 and cfg.decay_base == 0.33


def test_staircase_decay():
    cfg = AdamConfig(learning_rate=1.0, decay_start=100, decay_interval=50,
                     decay_base=0.5)
    assert float(lr_at_step(cfg, jnp.asarray(50))) == 1.0
    assert float(lr_at_step(cfg, jnp.asarray(99))) == 1.0
    np.testing.assert_allclose(float(lr_at_step(cfg, jnp.asarray(100))), 0.5)
    np.testing.assert_allclose(float(lr_at_step(cfg, jnp.asarray(149))), 0.5)
    np.testing.assert_allclose(float(lr_at_step(cfg, jnp.asarray(150))), 0.25)


def test_ema_inference_params_differ_from_train():
    cfg = AdamConfig(learning_rate=0.1, ema_decay=0.9)
    params = {"w": jnp.ones(4)}
    state = init_state(params, cfg)
    grads = {"w": jnp.ones(4)}
    p2, s2 = apply_update(params, grads, state, cfg)
    infer = inference_params(p2, s2, cfg)
    # EMA lags behind the trained params
    assert float(jnp.abs(infer["w"] - p2["w"]).max()) > 1e-4
    assert float(jnp.abs(infer["w"] - 1.0).max()) < \
        float(jnp.abs(p2["w"] - 1.0).max())


def test_matrix_mask_l2():
    cfg = AdamConfig(learning_rate=0.0, l2_reg=1.0)  # lr 0: isolate reg
    params = {"mat": jnp.ones(3), "table": jnp.ones(3)}
    state = init_state(params, cfg)
    grads = {"mat": jnp.zeros(3), "table": jnp.zeros(3)}
    mask = {"mat": True, "table": False}
    p2, s2 = apply_update(params, grads, state, cfg, matrix_mask=mask)
    # lr=0 → params unchanged, but moments reflect reg only for "mat"
    assert float(jnp.abs(s2.mu["mat"]).max()) > 0
    assert float(jnp.abs(s2.mu["table"]).max()) == 0


def test_loss_scale_neutral():
    """Scaling the loss and dividing grads must reproduce the unscaled
    trajectory (fp32 here, so exactly)."""
    def run(ls):
        cfg = AdamConfig(learning_rate=0.01, loss_scale=ls, l2_reg=0.0)
        params = {"w": jnp.ones(3)}
        state = init_state(params, cfg)
        for i in range(5):
            g = {"w": jnp.full(3, 0.5) * ls}
            params, state = apply_update(params, g, state, cfg)
        return np.asarray(params["w"])
    np.testing.assert_allclose(run(1.0), run(128.0), rtol=1e-6)
