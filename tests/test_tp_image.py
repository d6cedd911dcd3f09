"""TP image training end-to-end on the virtual mesh (gigapixel regime)."""
import jax
import numpy as np
import pytest


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_tp_image_trains_and_shards_table():
    from ngp_jax.dist.mesh import make_mesh
    from ngp_jax.dist.tp_image import TpImageTrainer

    rng = np.random.default_rng(0)
    img = rng.random((64, 64, 3), np.float32)
    cfg = {
        "loss": {"otype": "L2"},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-2,
                      "epsilon": 1e-15},
        "encoding": {"otype": "HashGrid", "n_levels": 6,
                     "n_features_per_level": 2, "log2_hashmap_size": 15,
                     "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 32,
                    "n_hidden_layers": 1},
    }
    mesh = make_mesh(n_data=2, n_model=4)
    tr = TpImageTrainer(img, cfg, mesh, batch_size=4096)

    # table is genuinely row-sharded: each device holds rows/4
    local = tr.params["table"].addressable_shards[0].data.shape
    assert local[1] == tr.meta.rows // 4, local

    l0 = tr.train(2)
    l1 = tr.train(8)
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, (l0, l1)

    # encode agrees with the single-device reference implementation
    from ngp_jax.kernels.blocked_grid import encode_reference
    pos = rng.random((256, 2), np.float32)
    with mesh:
        tp_feat = np.asarray(tr.encode(tr.params["table"],
                                       jax.numpy.asarray(pos)))
    full_table = np.asarray(tr.params["table"])
    ref_feat = np.asarray(encode_reference(
        jax.numpy.asarray(full_table), jax.numpy.asarray(pos), tr.meta))
    np.testing.assert_allclose(tp_feat, ref_feat, atol=1e-5)
