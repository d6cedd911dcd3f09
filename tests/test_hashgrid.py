"""Hash-grid encoding: forward vs. a straightforward numpy reference,
gradient checks for table and position derivatives."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ngp_jax.kernels.hashgrid import (HashGridMeta, _corner_offsets,
                                      hashgrid_encode)

_PRIMES = (1, 2654435761, 805459861)


def numpy_hashgrid(table, pos, meta: HashGridMeta):
    """Direct per-sample reference implementation. ``table`` is the flat
    (P*F,) parameter vector; view it as (P, F) rows here."""
    table = np.asarray(table).reshape(-1, meta.n_features_per_level)
    N, D = pos.shape
    out = np.zeros((N, meta.n_levels * meta.n_features_per_level), np.float32)
    corners = _corner_offsets(D)
    for l in range(meta.n_levels):
        scale = meta.level_scales[l]
        res = meta.level_resolutions[l]
        x = pos * scale + 0.5
        x0 = np.floor(x).astype(np.int64)
        frac = (x - x0).astype(np.float32)
        acc = np.zeros((N, meta.n_features_per_level), np.float32)
        for c in corners:
            coord = np.clip(x0 + c, 0, res - 1)
            if meta.level_is_dense[l]:
                stride, idx = 1, np.zeros(N, np.int64)
                for d in range(D):
                    idx += coord[:, d] * stride
                    stride *= res
            else:
                h = np.zeros(N, np.uint64)
                for d in range(D):
                    h ^= coord[:, d].astype(np.uint64) * np.uint64(_PRIMES[d])
                idx = ((h & np.uint64(0xFFFFFFFF)) %
                       np.uint64(meta.level_params[l])).astype(np.int64)
            w = np.prod(np.where(c > 0, frac, 1.0 - frac), axis=-1,
                        keepdims=True)
            acc += w * table[meta.level_offsets[l] + idx]
        out[:, l * meta.n_features_per_level:(l + 1) * meta.n_features_per_level] = acc
    return out


@pytest.mark.parametrize("d", [2, 3])
def test_forward_matches_numpy(d):
    meta = HashGridMeta(n_dims=d, n_levels=6, n_features_per_level=2,
                        log2_hashmap_size=10, base_resolution=4,
                        per_level_scale=1.8)
    key = jax.random.PRNGKey(0)
    table = np.asarray(meta.init_params(key))
    pos = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (64, d)))
    got = np.asarray(hashgrid_encode(jnp.asarray(table), jnp.asarray(pos), meta))
    want = numpy_hashgrid(table, pos, meta)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_dense_and_hash_levels_present():
    meta = HashGridMeta(n_dims=3, n_levels=8, n_features_per_level=2,
                        log2_hashmap_size=12, base_resolution=4,
                        per_level_scale=2.0)
    assert meta.level_is_dense[0]
    assert not meta.level_is_dense[-1]
    assert meta.n_params == meta.level_offsets[-1] + meta.level_params[-1]


def test_table_gradient_matches_finite_difference():
    meta = HashGridMeta(n_dims=2, n_levels=3, n_features_per_level=2,
                        log2_hashmap_size=8, base_resolution=4,
                        per_level_scale=2.0)
    table = meta.init_params(jax.random.PRNGKey(0)) * 1e3  # larger values
    pos = jax.random.uniform(jax.random.PRNGKey(1), (16, 2))
    w = jax.random.normal(jax.random.PRNGKey(2), (16, meta.n_output_dims))

    def f(t):
        return jnp.sum(hashgrid_encode(t, pos, meta) * w)

    g = jax.grad(f)(table)
    # finite differences on a few touched entries (flat table)
    gn = np.asarray(g)
    touched = np.argwhere(np.abs(gn) > 1e-6)[:5, 0]
    eps = 1e-3
    for i in touched:
        tp = table.at[i].add(eps)
        tm = table.at[i].add(-eps)
        fd = (f(tp) - f(tm)) / (2 * eps)
        np.testing.assert_allclose(gn[i], float(fd), rtol=1e-3, atol=1e-4)


def test_position_gradient_matches_finite_difference():
    meta = HashGridMeta(n_dims=3, n_levels=4, n_features_per_level=2,
                        log2_hashmap_size=10, base_resolution=4,
                        per_level_scale=1.7)
    table = meta.init_params(jax.random.PRNGKey(0)) * 1e3
    pos = jax.random.uniform(jax.random.PRNGKey(1), (8, 3),
                             minval=0.2, maxval=0.8)
    w = jax.random.normal(jax.random.PRNGKey(2), (8, meta.n_output_dims))

    def f(p):
        return jnp.sum(hashgrid_encode(table, p, meta) * w)

    g = np.asarray(jax.grad(f)(pos))
    eps = 1e-4
    for i in range(3):
        pp = pos.at[2, i].add(eps)
        pm = pos.at[2, i].add(-eps)
        fd = (f(pp) - f(pm)) / (2 * eps)
        np.testing.assert_allclose(g[2, i], float(fd), rtol=2e-2, atol=1e-3)


def test_max_level_masks_fine_levels():
    from ngp_jax.kernels.hashgrid import hashgrid_encode_with_max_level
    meta = HashGridMeta(n_dims=2, n_levels=4, n_features_per_level=2,
                        log2_hashmap_size=8, base_resolution=4,
                        per_level_scale=2.0)
    table = meta.init_params(jax.random.PRNGKey(0))
    pos = jax.random.uniform(jax.random.PRNGKey(1), (4, 2))
    out = hashgrid_encode_with_max_level(table, pos, meta, max_level=0.5)
    out = np.asarray(out)
    assert np.all(out[:, 4:] == 0.0)
    assert np.any(out[:, :4] != 0.0)
