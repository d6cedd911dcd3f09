"""Reference-snapshot import: structural round trip through the tcnn-layout
model, and the multi-NeRF field loader fallback."""
import os

import msgpack
import numpy as np
import pytest


def _fake_reference_snapshot(tmp_path, aabb_scale=1):
    from ngp_jax.config import autofill_hashgrid_config, load_network_config
    from ngp_jax.kernels.hashgrid import HashGridMeta
    cfg = load_network_config("configs/nerf/base.json")
    enc = autofill_hashgrid_config(cfg["encoding"], 3, 2048.0,
                                   aabb_scale=aabb_scale)
    meta = HashGridMeta.from_config(enc)
    n_mlp = 32 * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 16
    n = n_mlp + meta.n_params * 2
    rng = np.random.default_rng(0)
    params = (rng.standard_normal(n) * 0.01).astype(np.float16)
    grid = np.zeros(128 ** 3 * (1 if aabb_scale == 1 else 3), np.float16)
    doc = dict(cfg)
    doc["snapshot"] = {
        "version": 1,
        "params_binary": params.tobytes(),
        "density_grid_binary": grid.tobytes(),
        "density_grid_size": 128,
        "nerf": {"aabb_scale": aabb_scale,
                 "rgb": {"rays_per_batch": 4096}},
    }
    p = tmp_path / "ref.msgpack"
    p.write_bytes(msgpack.packb(doc, use_bin_type=True))
    return p, meta, params


def test_import_reference_snapshot(tmp_path):
    from ngp_jax.io.snapshot import import_reference_snapshot
    p, meta, params = _fake_reference_snapshot(tmp_path)
    cfg, pp, snap = import_reference_snapshot(p)
    assert pp["pos_encoding"].shape == (meta.n_params * 2,)
    # table values land at the right offset
    n_mlp = 32 * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 16
    np.testing.assert_allclose(pp["pos_encoding"][:4],
                               params[n_mlp:n_mlp + 4].astype(np.float32))
    # density first-layer transpose check
    w0 = params[:32 * 64].astype(np.float32).reshape(64, 32).T
    np.testing.assert_allclose(pp["density_net"][0], w0)


def test_field_loader_accepts_reference_snapshot(tmp_path):
    import jax
    from ngp_jax.render.multi_nerf import NeuralRadianceField
    p, _, _ = _fake_reference_snapshot(tmp_path)
    field = NeuralRadianceField(str(p))
    import jax.numpy as jnp
    rgb, dens = field.model.apply(field.params, jnp.full((2, 3), 0.5),
                                  jnp.full((2, 3), 0.5))
    assert np.isfinite(np.asarray(rgb)).all()
    assert field.bitfield.shape[0] == 8 * 128 ** 3 // 8


def test_export_import_round_trip(tmp_path):
    """export_reference_snapshot → import_reference_snapshot must return
    the same tcnn-layout params and an equivalent forward pass
    (ref schema: src/testbed.cu:3008-3106 + tcnn Trainer::serialize)."""
    import jax
    import jax.numpy as jnp
    from ngp_jax.config import autofill_hashgrid_config, load_network_config
    from ngp_jax.io.snapshot import (export_reference_snapshot,
                                     import_reference_snapshot)
    from ngp_jax.nn.models import NerfNetwork

    cfg = load_network_config("configs/nerf/base.json")
    os.environ["NGP_GRID_IMPL"] = "tcnn"
    try:
        enc = autofill_hashgrid_config(dict(cfg["encoding"]), 3, 2048.0,
                                       aabb_scale=1)
        built = dict(cfg)
        built["encoding"] = enc
        model = NerfNetwork(built)
        params = model.init_params(jax.random.PRNGKey(3))
        p = tmp_path / "export.msgpack"
        export_reference_snapshot(p, cfg, params, aabb_scale=1,
                                  density_grid=np.zeros(128 ** 3, np.float32),
                                  training_step=77)
        cfg2, params2, snap = import_reference_snapshot(p)
        assert snap["training_step"] == 77
        assert snap["params_type"] == "__half"

        for k in ("density_net", "rgb_net"):
            for a, b in zip(params[k], params2[k]):
                np.testing.assert_allclose(np.asarray(a), b, atol=2e-3,
                                           rtol=1e-2)  # fp16 round trip
        np.testing.assert_allclose(np.asarray(params["pos_encoding"]),
                                   params2["pos_encoding"], atol=2e-3,
                                   rtol=1e-2)

        # forward equivalence through the fp16 round trip
        pos = jax.random.uniform(jax.random.PRNGKey(4), (64, 3))
        dirs = jax.random.uniform(jax.random.PRNGKey(5), (64, 3))
        r1, d1 = model.apply(params, pos, dirs)
        p2 = jax.tree.map(jnp.asarray, params2)
        r2, d2 = model.apply(p2, pos, dirs)
        np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), atol=5e-2)
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=5e-2)
    finally:
        os.environ.pop("NGP_GRID_IMPL", None)
