"""Multiresolution hash-grid encoding (instant-ngp) as a JAX op.

This re-implements, from the paper (arXiv 2201.05989) and observed usage in
the reference (/root/reference/src/testbed.cu:2290-2335), the tiny-cuda-nn
GridEncoding: L levels of D-linear interpolated feature grids; fine levels
are spatially hashed into a table of 2^log2_hashmap_size entries.

Design notes:
- **Layout**: every large intermediate keeps the sample axis N as the
  minor-most dimension — (L, C, N), (L, C, F, N). The feature table is
  gathered as a flat 1-D array.
- Forward is a batched gather + lerp; backward is a scatter-add into the
  table via ``custom_vjp``. Only ``pos`` is saved as the residual;
  indices/weights are recomputed in the backward pass (cheap ALU work vs.
  hundreds of MB of saved activations).
- All levels are computed in one vectorized block — no Python loop beyond
  the static 2^D corner unroll.

"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Spatial-hash primes (instant-ngp paper eq. 4; first prime is 1 so that the
# hash is the identity along x for dense-ish levels).
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)


@dataclasses.dataclass(frozen=True)
class HashGridMeta:
    """Static hash-grid configuration. Hashable → usable as a nondiff arg."""

    n_dims: int                      # D: 2 (image) or 3 (nerf/sdf/volume)
    n_levels: int                    # L
    n_features_per_level: int        # F
    log2_hashmap_size: int           # T = 2^this
    base_resolution: int             # N_min
    per_level_scale: float           # b
    interpolation: str = "linear"    # "linear" | "smoothstep"

    @functools.cached_property
    def level_scales(self) -> Tuple[float, ...]:
        # tcnn grid scale: exp2f(l * log2f(b)) * N_min - 1, computed in
        # FLOAT32 like the CUDA reference — f64 here rounds some exact-
        # integer scales (e.g. b=1.5, l=3: 53.0 vs 53.000000000000007)
        # the other way, changing ceil() and with it the level resolution
        # and table layout (tcnn ABI rule 6, io/snapshot.py)
        import numpy as np
        log2b = np.log2(np.float32(self.per_level_scale))
        return tuple(
            float(np.exp2(np.float32(l) * log2b, dtype=np.float32)
                  * np.float32(self.base_resolution) - np.float32(1.0))
            for l in range(self.n_levels)
        )

    @functools.cached_property
    def level_resolutions(self) -> Tuple[int, ...]:
        return tuple(int(math.ceil(s)) + 1 for s in self.level_scales)

    @functools.cached_property
    def level_params(self) -> Tuple[int, ...]:
        """Number of table rows per level (dense if it fits, else hashed)."""
        T = 1 << self.log2_hashmap_size
        out = []
        for res in self.level_resolutions:
            dense = res ** self.n_dims
            params = min(dense, T)
            params = ((params + 7) // 8) * 8  # tcnn aligns to 8
            out.append(params)
        return tuple(out)

    @functools.cached_property
    def level_is_dense(self) -> Tuple[bool, ...]:
        T = 1 << self.log2_hashmap_size
        return tuple(res ** self.n_dims <= T for res in self.level_resolutions)

    @functools.cached_property
    def level_offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for p in self.level_params:
            offs.append(acc)
            acc += p
        return tuple(offs)

    @property
    def n_params(self) -> int:
        return self.level_offsets[-1] + self.level_params[-1]

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @classmethod
    def from_config(cls, enc: dict) -> "HashGridMeta":
        return cls(
            n_dims=int(enc["n_pos_dims"]),
            n_levels=int(enc.get("n_levels", 16)),
            n_features_per_level=int(enc.get("n_features_per_level", 2)),
            log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
            base_resolution=int(enc.get("base_resolution", 16)),
            per_level_scale=float(enc.get("per_level_scale", 2.0)),
            interpolation=str(enc.get("interpolation", "Linear")).lower(),
        )

    def init_params(self, key: jax.Array, dtype=jnp.float32) -> jax.Array:
        """tcnn initializes grid features uniform in [-1e-4, 1e-4].

        The table is a FLAT 1-D parameter of n_params * F floats. Row r,
        feature f lives at index r * F + f."""
        return jax.random.uniform(
            key, (self.n_params * self.n_features_per_level,), dtype=dtype,
            minval=-1e-4, maxval=1e-4,
        )


def _corner_offsets(d: int) -> np.ndarray:
    """(2^D, D) binary corner offsets."""
    c = np.arange(1 << d)
    return np.stack([(c >> i) & 1 for i in range(d)], axis=-1).astype(np.int32)


def _indices_and_weights(meta: HashGridMeta, posT: jax.Array):
    """Flat table indices + interpolation weights, N-minor layout.

    posT: (D, N) float32 in [0, 1].
    Returns idx (L, C, N) int32 rows into the table, weights (L, C, N) f32,
    frac (L, D, N), and per-corner per-dim weights w (L, C, D, N).
    """
    D, L, C = meta.n_dims, meta.n_levels, 1 << meta.n_dims
    scales = jnp.asarray(meta.level_scales, jnp.float32)          # (L,)
    res = jnp.asarray(meta.level_resolutions, jnp.int32)          # (L,)
    x = posT[None, :, :] * scales[:, None, None] + 0.5            # (L,D,N)
    x0f = jnp.floor(x)
    frac = x - x0f                                                # (L,D,N)
    if meta.interpolation == "smoothstep":
        wfrac = frac * frac * (3.0 - 2.0 * frac)
    else:
        wfrac = frac
    x0 = x0f.astype(jnp.int32)

    offs = jnp.asarray(_corner_offsets(D))                        # (C,D)
    coord = x0[:, None, :, :] + offs[None, :, :, None]            # (L,C,D,N)
    coord = jnp.clip(coord, 0, res[:, None, None, None] - 1)

    # Dense (row-major stride) index.
    strides = []
    for l in range(L):
        s, acc = [], 1
        for _ in range(D):
            s.append(acc)
            acc *= meta.level_resolutions[l]
        strides.append(s)
    strides = jnp.asarray(strides, jnp.int32)                     # (L,D)
    dense_idx = jnp.sum(coord * strides[:, None, :, None], axis=2)  # (L,C,N)

    # Spatial hash index.
    cu = coord.astype(jnp.uint32)
    h = cu[:, :, 0, :] * jnp.uint32(_PRIMES[0])
    for d in range(1, D):
        h = h ^ (cu[:, :, d, :] * jnp.uint32(_PRIMES[d]))
    params = jnp.asarray(meta.level_params, jnp.uint32)           # (L,)
    hash_idx = (h % params[:, None, None]).astype(jnp.int32)

    is_dense = jnp.asarray(meta.level_is_dense)[:, None, None]
    local_idx = jnp.where(is_dense, dense_idx, hash_idx)
    level_off = jnp.asarray(meta.level_offsets, jnp.int32)[:, None, None]
    idx = local_idx + level_off                                   # (L,C,N)

    # D-linear weights: prod over dims of (frac or 1-frac).
    offs_f = jnp.asarray(offs, jnp.float32)                       # (C,D)
    w = jnp.where(offs_f[None, :, :, None] > 0, wfrac[:, None, :, :],
                  1.0 - wfrac[:, None, :, :])                     # (L,C,D,N)
    weights = jnp.prod(w, axis=2)                                 # (L,C,N)
    return idx, weights, frac, w


def _gather_features(table: jax.Array, idx: jax.Array, F: int):
    """Gather table rows with N-minor output: idx (L,C,N) → (L,C,F,N).
    ``table`` is the flat (P*F,) parameter vector."""
    fidx = idx[:, :, None, :] * F + jnp.arange(F, dtype=jnp.int32)[None, None, :, None]
    return jnp.take(table, fidx, axis=0)                          # (L,C,F,N)


def _forward(table: jax.Array, pos: jax.Array, meta: HashGridMeta) -> jax.Array:
    N = pos.shape[0]
    L, F = meta.n_levels, meta.n_features_per_level
    posT = pos.T                                                  # (D,N)
    idx, weights, _, _ = _indices_and_weights(meta, posT)
    feats = _gather_features(table, idx, F)                       # (L,C,F,N)
    out = jnp.sum(feats * weights[:, :, None, :].astype(feats.dtype), axis=1)
    # (L,F,N) → (N, L*F)
    return out.reshape(L * F, N).T


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def hashgrid_encode(table: jax.Array, pos: jax.Array, meta: HashGridMeta) -> jax.Array:
    """Encode positions: (N, D) in [0,1] → (N, L*F) features (level-major).
    ``table``: flat (n_params * F,) parameter vector."""
    return _forward(table, pos, meta)


def _encode_fwd(table, pos, meta):
    return _forward(table, pos, meta), (table, pos)


def _encode_bwd(meta, residuals, g):
    table, pos = residuals
    D, L, C, F = meta.n_dims, meta.n_levels, 1 << meta.n_dims, meta.n_features_per_level
    N = pos.shape[0]
    posT = pos.T
    idx, weights, frac, w = _indices_and_weights(meta, posT)
    gT = g.T.reshape(L, F, N)                                     # (L,F,N)

    # d/dtable: scatter-add weighted cotangents into flat table entries.
    vals = weights[:, :, None, :] * gT[:, None, :, :]             # (L,C,F,N)
    fidx = idx[:, :, None, :] * F + jnp.arange(F, dtype=jnp.int32)[None, None, :, None]
    d_table = jnp.zeros_like(table).at[fidx.reshape(-1)].add(
        vals.reshape(-1).astype(table.dtype), mode="drop")

    # d/dpos: d(weight_c)/d(pos_d) = ±(prod_{d'≠d} w_d') · chain · scale_l.
    feats = _gather_features(table, idx, F).astype(jnp.float32)   # (L,C,F,N)
    gdot = jnp.sum(feats * gT[:, None, :, :].astype(jnp.float32), axis=2)  # (L,C,N)
    offs = jnp.asarray(_corner_offsets(D), jnp.float32)           # (C,D)
    sign = jnp.where(offs > 0, 1.0, -1.0)[None, :, :, None]       # (1,C,D,1)
    prod_excl = []
    for d in range(D):
        others = [w[:, :, dd, :] for dd in range(D) if dd != d]
        p = others[0]
        for o in others[1:]:
            p = p * o
        prod_excl.append(p)
    prod_excl = jnp.stack(prod_excl, axis=2)                      # (L,C,D,N)
    if meta.interpolation == "smoothstep":
        chain = (6.0 * frac * (1.0 - frac))[:, None, :, :]        # (L,1,D,N)
    else:
        chain = 1.0
    scales = jnp.asarray(meta.level_scales, jnp.float32)
    dw_dpos = sign * prod_excl * chain * scales[:, None, None, None]
    d_posT = jnp.sum(gdot[:, :, None, :] * dw_dpos, axis=(0, 1))  # (D,N)
    return d_table, d_posT.T.astype(pos.dtype)


hashgrid_encode.defvjp(_encode_fwd, _encode_bwd)


def hashgrid_encode_with_max_level(table, pos, meta: HashGridMeta, max_level=None):
    """Encode with optional progressive level masking.

    ``max_level`` ∈ [0,1] (scalar or per-sample (N,)) masks levels ≥
    max_level·L to zero (ref: tcnn set_max_level_gpu usage at
    src/testbed_nerf.cu:3251-3259).
    """
    out = hashgrid_encode(table, pos, meta)
    if max_level is None:
        return out
    L, F = meta.n_levels, meta.n_features_per_level
    level_ids = jnp.arange(L * F) // F
    ml = jnp.asarray(max_level)
    thresh = ml * L
    if ml.ndim == 0:
        mask = (level_ids < thresh).astype(out.dtype)
        return out * mask[None, :]
    mask = (level_ids[None, :] < thresh[:, None]).astype(out.dtype)
    return out * mask
