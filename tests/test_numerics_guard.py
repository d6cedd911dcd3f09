"""NGP_CHECK_NUMERICS=1 turns a training divergence into a one-line
FloatingPointError at the next stats fetch (SURVEY §5 numerics guards —
the functional substitute for the sanitizers the reference lacks; the
round-3 f32-cumsum overflow scenario motivated this)."""
import numpy as np
import pytest

from synthetic import make_orbit_dataset


def _small_cfg():
    from ngp_jax.config import load_network_config
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    return cfg


def _trainer():
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig
    ds = make_orbit_dataset(res=16, aabb_scale=1)
    return NerfTrainer(ds, _small_cfg(), seed=3, tcfg=NerfTrainerConfig(
        n_rays=64, adapt_rays=False, target_batch_size=2048,
        march_steps=128))


@pytest.mark.smoke
def test_nan_params_raise_with_flag(monkeypatch):
    import jax.numpy as jnp
    monkeypatch.setenv("NGP_CHECK_NUMERICS", "1")
    tr = _trainer()
    tr.train(2)
    # poison the position encoding the way a divergence would (NaN
    # spreads through density to the loss)
    import jax
    tr.params = dict(tr.params, pos_encoding=jax.tree.map(
        lambda v: v * jnp.nan, tr.params["pos_encoding"]))
    with pytest.raises(FloatingPointError) as e:
        tr.train(2)
    assert "non-finite loss" in str(e.value)
    assert "pos_encoding" in str(e.value)


def test_no_flag_no_raise(monkeypatch):
    monkeypatch.delenv("NGP_CHECK_NUMERICS", raising=False)
    tr = _trainer()
    loss = tr.train(2)
    assert np.isfinite(loss)
