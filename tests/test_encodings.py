"""Encodings: SH orthogonality/values, oneblob partition of unity,
frequency ranges, composite wiring, config factory."""
import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.nn.encodings import (Composite, Frequency, Identity, OneBlob,
                                  SphericalHarmonics, create_encoding)


def test_sh_degree4_constant_band():
    sh = SphericalHarmonics(3, 4)
    d = np.array([[0.0, 0.0, 1.0]])
    out = np.asarray(sh.apply((), jnp.asarray((d + 1) / 2)))
    assert out.shape == (1, 16)
    np.testing.assert_allclose(out[0, 0], 0.28209479, rtol=1e-6)
    # z-aligned direction: band-1 x/y terms vanish
    np.testing.assert_allclose(out[0, 1], 0.0, atol=1e-6)
    np.testing.assert_allclose(out[0, 3], 0.0, atol=1e-6)


def test_sh_orthonormality():
    """Monte-Carlo check that the basis is orthonormal over the sphere."""
    sh = SphericalHarmonics(3, 3)
    key = jax.random.PRNGKey(0)
    v = jax.random.normal(key, (200000, 3))
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    y = sh.apply((), (v + 1) / 2)
    gram = np.asarray(y.T @ y) * (4 * np.pi / v.shape[0])
    np.testing.assert_allclose(gram, np.eye(9), atol=0.05)


def test_oneblob_partition_of_unity():
    ob = OneBlob(1, 16)
    x = jnp.linspace(0.1, 0.9, 32)[:, None]
    out = np.asarray(ob.apply((), x))
    assert out.shape == (32, 16)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=2e-2)
    # peak bin is the bin containing x
    assert np.all(np.argmax(out, -1) == np.clip((np.asarray(x)[:, 0] * 16), 0, 15).astype(int))


def test_frequency_shape_and_range():
    fr = Frequency(2, 6)
    x = jax.random.uniform(jax.random.PRNGKey(0), (10, 2))
    out = np.asarray(fr.apply((), x))
    assert out.shape == (10, 24)
    assert np.all(np.abs(out) <= 1.0 + 1e-6)


def test_composite_from_config():
    cfg = {
        "otype": "Composite",
        "nested": [
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
            {"otype": "Identity", "n_bins": 4, "degree": 4},
        ],
    }
    enc = create_encoding(7, cfg)
    assert enc.n_output_dims == 16 + 4
    params = enc.init_params(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (5, 7))
    out = np.asarray(enc.apply(params, x))
    assert out.shape == (5, 20)
    # identity part passes through
    np.testing.assert_allclose(out[:, 16:], np.asarray(x[:, 3:]), rtol=1e-6)


def test_grid_factory_matches_nerf_base_config():
    from ngp_jax.config import autofill_hashgrid_config
    enc_cfg = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
               "log2_hashmap_size": 19, "base_resolution": 16}
    filled = autofill_hashgrid_config(enc_cfg, 3, 2048.0, aabb_scale=1)
    enc = create_encoding(3, filled)
    assert enc.n_output_dims == 32
    # finest level should reach ~2048 resolution
    assert abs(enc.meta.level_resolutions[-1] - 2049) <= 2
