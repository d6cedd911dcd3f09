"""Snapshot round-trip: params, EMA, density grid, config."""
import numpy as np
import pytest

from ngp_jax.io.snapshot import PARAMS_KEY, load_snapshot, save_snapshot


@pytest.mark.smoke
def test_roundtrip(tmp_path):
    params = {"net": (np.random.rand(4, 8).astype(np.float32),
                      np.random.rand(8, 3).astype(np.float32)),
              "encoding": np.random.rand(64).astype(np.float32)}
    cfg = {"encoding": {"otype": "HashGrid"}, "loss": {"otype": "Huber"}}
    p = tmp_path / "snap.msgpack"
    grid = np.random.rand(2 * 128 ** 3).astype(np.float32)
    save_snapshot(p, cfg, params, params, density_grid=grid, max_cascade=1,
                  training_step=42, aabb_scale=2, rays_per_batch=4096,
                  aabb_min=[-0.5] * 3, aabb_max=[1.5] * 3)
    doc = load_snapshot(p)
    snap = doc["snapshot"]
    assert doc["loss"]["otype"] == "Huber"
    assert snap["training_step"] == 42
    assert snap["nerf"]["aabb_scale"] == 2
    got = snap[PARAMS_KEY]
    np.testing.assert_array_equal(got["net"][0], params["net"][0])
    np.testing.assert_array_equal(got["encoding"], params["encoding"])
    # fp16 grid compression round-trip
    np.testing.assert_allclose(snap["density_grid"], grid, atol=1e-3)
    assert isinstance(got["net"], tuple)


def test_msgpack_config_loading(tmp_path):
    from ngp_jax.config import load_network_config
    params = {"x": np.zeros(3, np.float32)}
    cfg = {"encoding": {"otype": "HashGrid", "n_levels": 8}}
    p = tmp_path / "snap.msgpack"
    save_snapshot(p, cfg, params, params)
    loaded = load_network_config(p)
    assert loaded["encoding"]["n_levels"] == 8
    assert "snapshot" not in loaded


def test_optimizer_state_roundtrip(tmp_path):
    """Adam moments + step survive save/load when include_optimizer_state
    is set (ref: include_optimizer_state, src/testbed.cu:3008) — resume
    must reproduce training dynamics instead of resetting the moments."""
    import jax
    from synthetic import make_orbit_dataset
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    ds = make_orbit_dataset(res=16)
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=2048, march_steps=64))
    tr.train(2)
    p = tmp_path / "snap.msgpack"
    tr.save_snapshot(p, cfg, include_optimizer_state=True)

    tr2 = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=2048, march_steps=64))
    tr2.load_snapshot_state(p)
    assert int(tr2.opt_state.step) == int(tr.opt_state.step)
    for a, b in zip(jax.tree.leaves(tr.opt_state.mu),
                    jax.tree.leaves(tr2.opt_state.mu)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(tr.opt_state.nu),
                    jax.tree.leaves(tr2.opt_state.nu)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
