"""The blocked-grid gather encode against the row-gather reference, and the
one encode path every platform takes."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ngp_jax.kernels.blocked_grid import (BlockedGridMeta, encode,
                                          encode_reference)

METAS = {
    "2d": BlockedGridMeta(n_dims=2, n_levels=5, base_resolution=8,
                          per_level_scale=1.8, log2_rows=8),
    "3d": BlockedGridMeta(n_dims=3, n_levels=4, base_resolution=16,
                          per_level_scale=1.5, log2_rows=7),
    # coarse dense levels address far fewer rows than the hashed fine
    # levels of the same (L, R, 128) table
    "3d_mixed_dense_hashed": BlockedGridMeta(
        n_dims=3, n_levels=6, base_resolution=16, per_level_scale=1.6,
        log2_rows=11),
}


@pytest.mark.parametrize("name", sorted(METAS))
def test_gather_encode_matches_reference(name):
    meta = METAS[name]
    if name == "3d_mixed_dense_hashed":
        assert any(meta.level_is_dense) and not all(meta.level_is_dense)
    k_t, k_p, k_g = jax.random.split(jax.random.PRNGKey(0), 3)
    table = jax.random.normal(k_t, (meta.n_levels, meta.rows, 128)) * 0.3
    pos = jax.random.uniform(k_p, (512, meta.n_dims))
    g_out = jax.random.normal(k_g, (512, meta.n_output_dims))

    def grads(f):
        out, vjp = jax.vjp(lambda t, p: f(t, p, meta), table, pos)
        return (out,) + vjp(g_out)

    out, gt, gp = grads(encode)
    out_r, gt_r, gp_r = grads(encode_reference)
    assert out.shape == (512, meta.n_output_dims)
    np.testing.assert_allclose(out, out_r, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gt, gt_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gp, gp_r, rtol=1e-5, atol=1e-4)
    # the table gradient lands only on corner lanes that were read
    assert float(jnp.abs(gt).sum()) > 0
    assert int((gt != 0).sum()) <= 512 * meta.n_levels * \
        (1 << meta.n_dims) * meta.n_features_per_level


def _encodings():
    from ngp_jax.nn.encodings import create_encoding
    from ngp_jax.nn.takikawa import TakikawaEncoding, TakikawaMeta
    blocked = create_encoding(3, {"otype": "HashGrid", "n_levels": 4,
                                  "log2_hashmap_size": 12,
                                  "base_resolution": 16,
                                  "per_level_scale": 1.5})
    pts = np.random.default_rng(0).random((256, 3)).astype(np.float32)
    taki = TakikawaEncoding(TakikawaMeta(start_depth=2, max_depth=4,
                                         log2_hashmap_size=12), pts)
    return {"blocked": (blocked, blocked.meta),
            "takikawa": (taki, taki.grid_meta)}


@pytest.mark.parametrize("which", ["blocked", "takikawa"])
def test_encoding_apply_takes_one_path_on_every_platform(monkeypatch, which):
    """apply() never asks which device it runs on: it calls the gather
    encode, so every platform computes the same thing."""
    import ngp_jax.kernels.blocked_grid as bg
    enc, meta = _encodings()[which]
    params = enc.init_params(jax.random.PRNGKey(1))
    params = params + jax.random.normal(jax.random.PRNGKey(2),
                                        params.shape) * 0.1
    pos = jax.random.uniform(jax.random.PRNGKey(3), (128, 3))
    expected = np.asarray(encode(params, pos, meta))

    calls = []

    def counting_encode(t, p, m):
        calls.append(m)
        return encode(t, p, m)

    def no_device_query(*a, **k):
        raise AssertionError("encoding asked which device it runs on")

    monkeypatch.setattr(jax, "devices", no_device_query)
    monkeypatch.setattr(bg, "encode", counting_encode)
    got = np.asarray(enc.apply(params, pos))
    assert calls == [meta]
    if which == "blocked":
        np.testing.assert_array_equal(got, expected)
    else:
        # Takikawa zeroes the features of unoccupied octree cells
        kept = got != 0
        assert kept.any()
        np.testing.assert_array_equal(got[kept], expected[kept])


@pytest.mark.gpu
def test_gather_encode_matches_reference_on_card(gpu):
    """At the NeRF width (16 levels, 2^13 rows) on the GPU."""
    meta = BlockedGridMeta(n_dims=3, n_levels=16, base_resolution=16,
                           per_level_scale=1.447, log2_rows=13)
    k_t, k_p = jax.random.split(jax.random.PRNGKey(0))
    table = jax.random.uniform(k_t, (16, meta.rows, 128), minval=-1.0,
                               maxval=1.0)
    pos = jax.random.uniform(k_p, (1 << 16, 3))
    got = jax.jit(lambda t, p: encode(t, p, meta))(table, pos)
    want = jax.jit(lambda t, p: encode_reference(t, p, meta))(table, pos)
    assert got.devices() == {gpu}
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
