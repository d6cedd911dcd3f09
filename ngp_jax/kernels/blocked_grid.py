"""Blocked multiresolution grid: 128-value rows of overlapping vertex blocks.

- Each level's table is organized as rows of 128 lanes; one row holds an
  **overlapping block of 4×4×4 vertices × 2 features** (stride 3 cells;
  2D: 8×8 vertices, stride 7). Any sample's 2^D interpolation corners lie
  in **exactly one row** (base-local coords ∈ [0, stride)), so a lookup
  is: row id → in-row corner lanes → weighted reduce.
- Coarse ("dense") levels store a canonical raster vertex grid and are
  expanded to the blocked layout on the fly with strided slices (copies
  stay tied → the interpolated field stays C0-continuous, like tcnn).
- Fine levels are "hash-tiled": the block coordinate is spatially hashed
  (instant-ngp primes, arXiv 2201.05989 eq. 4) into a power-of-two row
  count. The original design used ``morton(block) % 2^k``, but the LOW
  bits of a Morton code are spatially PERIODIC — blocks separated by the
  tile period collide systematically, forcing the fine-level field to
  repeat across the scene (a hard PSNR ceiling on fox). Prime hashing
  makes collisions incoherent like tcnn's. These levels trade tcnn's C0
  guarantee at 3-cell block boundaries for single-row lookups; the
  per-level feature magnitudes are small and seams never align across
  levels. Ablation (albert.exr image fit, 400 equal steps, identical
  capacity): blocked 39.29 dB vs tcnn-layout gather 38.52 dB.

Parameter count per level: n_rows · 128 floats. Capacity is matched to a
given tcnn log2_hashmap_size by choosing n_rows = 2^T · F / 128.

``encode`` is the production path: it gathers only the 2^D · F values
each (sample, level) uses from the flattened table, so its backward is a
scatter-add of those values. ``encode_reference`` gathers whole 128-lane
rows first; it is the independent formulation the tests compare against.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

LANES = 128

# instant-ngp spatial-hash primes (paper eq. 4; identity along x)
_HASH_PRIMES = (1, 2654435761, 805459861)


def _block_geom(n_dims: int) -> tuple[int, int]:
    """(vertices per side, stride in cells) for a 128-lane block."""
    if n_dims == 3:
        return 4, 3   # 4^3 * 2 = 128
    if n_dims == 2:
        return 8, 7   # 8^2 * 2 = 128
    raise ValueError("blocked grid supports 2D and 3D")


def _morton_nd_np(coords: np.ndarray, n_dims: int) -> np.ndarray:
    out = np.zeros(coords.shape[:-1], np.uint64)
    for bit in range(21):
        for d in range(n_dims):
            out |= ((coords[..., d].astype(np.uint64) >> bit) & 1) << (bit * n_dims + d)
    return out


def _part_bits(x, n_dims: int):
    """Interleave zeros between bits (jnp, uint32, 10 bits per dim)."""
    x = x.astype(jnp.uint32)
    if n_dims == 2:
        x &= jnp.uint32(0xFFFF)
        x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
        x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
        x = (x | (x << 2)) & jnp.uint32(0x33333333)
        x = (x | (x << 1)) & jnp.uint32(0x55555555)
        return x
    x &= jnp.uint32(0x3FF)
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def morton_nd(coords: jax.Array, n_dims: int) -> jax.Array:
    """coords (..., D) int → Morton code (uint32)."""
    out = _part_bits(coords[..., 0], n_dims)
    for d in range(1, n_dims):
        out = out | (_part_bits(coords[..., d], n_dims) << d)
    return out


@dataclasses.dataclass(frozen=True)
class BlockedGridMeta:
    """Static config of the blocked multiresolution grid."""

    n_dims: int
    n_levels: int
    base_resolution: int
    per_level_scale: float
    log2_rows: int = 11              # rows per level: uniform (L, R, 128) table
    n_features_per_level: int = 2    # fixed: 2 (packed into the 128 lanes)
    row_hash: str = "prime"          # "prime" (tcnn-like) | "morton" (legacy)

    @functools.cached_property
    def level_scales(self) -> Tuple[float, ...]:
        return tuple(
            math.exp2(l * math.log2(self.per_level_scale)) * self.base_resolution - 1.0
            for l in range(self.n_levels))

    @functools.cached_property
    def level_resolutions(self) -> Tuple[int, ...]:
        return tuple(int(math.ceil(s)) + 1 for s in self.level_scales)

    @functools.cached_property
    def level_blocks_per_dim(self) -> Tuple[int, ...]:
        _, stride = _block_geom(self.n_dims)
        return tuple((res + stride - 1) // stride for res in self.level_resolutions)

    @property
    def rows(self) -> int:
        return 1 << self.log2_rows

    @functools.cached_property
    def level_is_dense(self) -> Tuple[bool, ...]:
        """Dense = every block gets its own row (no Morton aliasing)."""
        return tuple(b ** self.n_dims <= self.rows
                     for b in self.level_blocks_per_dim)

    @property
    def total_rows(self) -> int:
        return self.n_levels * self.rows

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def n_params(self) -> int:
        return self.total_rows * LANES

    @classmethod
    def from_hashgrid_config(cls, enc: dict) -> "BlockedGridMeta":
        """Map a tcnn HashGrid config onto the blocked grid with matched
        parameter budget: rows = 2^log2_hashmap_size · F / 128."""
        import os
        n_dims = int(enc["n_pos_dims"])
        F = int(enc.get("n_features_per_level", 2))
        log2_T = int(enc.get("log2_hashmap_size", 19))
        log2_rows = max(6, log2_T + int(math.log2(F)) - 7)
        env_rows = os.environ.get("NGP_BLOCKED_LOG2_ROWS")
        if env_rows:
            # ablation override: selection cost is linear in rows
            log2_rows = int(env_rows)
        if "log2_rows" in enc:
            # snapshot-stamped layout beats derivation AND the env knob:
            # a stored table must decode with the geometry it was
            # trained under (save_snapshot stamps this via
            # BlockedGridEncoding.resolved_config)
            log2_rows = int(enc["log2_rows"])
        row_hash = enc.get("row_hash",
                           os.environ.get("NGP_BLOCKED_HASH", "prime"))
        # never allocate more rows than the finest level can address
        # (small scenes/images would otherwise get giant empty tables)
        probe = cls(n_dims=n_dims,
                    n_levels=int(enc.get("n_levels", 16)),
                    base_resolution=int(enc.get("base_resolution", 16)),
                    per_level_scale=float(enc.get("per_level_scale", 2.0)),
                    log2_rows=log2_rows, n_features_per_level=F,
                    row_hash=row_hash)
        max_blocks = max(b ** n_dims for b in probe.level_blocks_per_dim)
        log2_needed = max(6, math.ceil(math.log2(max(max_blocks, 1))))
        return dataclasses.replace(probe,
                                   log2_rows=min(log2_rows, log2_needed))

    def init_params(self, key: jax.Array, dtype=jnp.float32) -> jax.Array:
        """(L, R, 128) table, uniform ±1e-4 like tcnn."""
        return jax.random.uniform(
            key, (self.n_levels, self.rows, LANES), dtype=dtype,
            minval=-1e-4, maxval=1e-4)


def lookup_geometry(meta: BlockedGridMeta, pos: jax.Array):
    """Per (sample, level): row id, base-local vertex coords, fractions.

    pos: (N, D) in [0,1]. Returns
      rows   (L, N) int32   — absolute row in the concatenated table
      local  (L, N, D) int32 — base-vertex coords within the block [0, side-2]
      frac   (L, N, D) f32   — interpolation fractions
    """
    D, L = meta.n_dims, meta.n_levels
    side, stride = _block_geom(D)
    scales = jnp.asarray(meta.level_scales, jnp.float32)
    x = pos.T[None] * scales[:, None, None] + 0.5          # (L, D, N)
    x0f = jnp.floor(x)
    frac = x - x0f
    base = x0f.astype(jnp.int32)                           # vertex base coords
    block = base // stride                                 # (L, D, N)
    local = base - block * stride                          # ∈ [0, stride)
    # clamp blocks into the level's block grid (positions slightly ≥ res)
    nblk = jnp.asarray(meta.level_blocks_per_dim, jnp.int32)[:, None, None]
    block = jnp.clip(block, 0, nblk - 1)

    # dense: raster index over blocks; tiled: morton % 2^k
    strides_per_level = []
    for l in range(L):
        s, acc = [], 1
        for _ in range(D):
            s.append(acc)
            acc *= meta.level_blocks_per_dim[l]
        strides_per_level.append(s)
    bstr = jnp.asarray(strides_per_level, jnp.int32)       # (L, D)
    dense_row = jnp.sum(block * bstr[:, :, None], axis=1)  # (L, N)
    blockT = jnp.moveaxis(block, 1, -1)                    # (L, N, D)
    if meta.row_hash == "morton":
        h = morton_nd(blockT, D)
    else:
        # spatial hash of the BLOCK coordinate (instant-ngp primes):
        # incoherent collisions — morton%2^k collides periodically
        bu = blockT.astype(jnp.uint32)
        h = bu[..., 0] * jnp.uint32(_HASH_PRIMES[0])
        for d in range(1, D):
            h = h ^ (bu[..., d] * jnp.uint32(_HASH_PRIMES[d]))
    tiled_row = (h & jnp.uint32(meta.rows - 1)).astype(jnp.int32)
    is_dense = jnp.asarray(meta.level_is_dense)[:, None]
    rows = jnp.where(is_dense, dense_row, tiled_row)        # (L, N), per-level
    return rows, jnp.moveaxis(local, 1, -1), jnp.moveaxis(frac, 1, -1)


def corner_lanes_and_weights(meta: BlockedGridMeta, local: jax.Array,
                             frac: jax.Array):
    """(L, N, D) local+frac → lanes (L, N, C) int32 (feature-0 lanes) and
    weights (L, N, C) f32, where C = 2^D. Lane layout within a row:
    vertex raster index within the block · 2 + feature."""
    D = meta.n_dims
    side, _ = _block_geom(D)
    C = 1 << D
    corners = np.stack([(np.arange(C) >> d) & 1 for d in range(D)],
                       axis=-1).astype(np.int32)           # (C, D)
    cor = jnp.asarray(corners)
    v = local[:, :, None, :] + cor[None, None]             # (L, N, C, D)
    lane_strides = np.asarray([side ** d for d in range(D)], np.int32)
    lanes = jnp.sum(v * jnp.asarray(lane_strides), axis=-1) * \
        meta.n_features_per_level                           # (L, N, C)
    w = jnp.where(cor[None, None] > 0, frac[:, :, None, :],
                  1.0 - frac[:, :, None, :])
    return lanes, jnp.prod(w, axis=-1)


def encode(table: jax.Array, pos: jax.Array,
           meta: BlockedGridMeta) -> jax.Array:
    """(L, R, 128) table, (N, D) positions in [0, 1] → (N, L·F) features.

    One gather of the F contiguous features of each of the 2^D corners,
    at flat index ``(l·R + row)·128 + lane``, then a weighted sum over
    the corners (elementwise, so no matmul precision setting applies)."""
    L, F = meta.n_levels, meta.n_features_per_level
    N = pos.shape[0]
    rows, local, frac = lookup_geometry(meta, pos)
    lanes, weights = corner_lanes_and_weights(meta, local, frac)
    level_base = jnp.arange(L, dtype=jnp.int32)[:, None] * meta.rows
    flat = ((level_base + rows)[:, :, None] * LANES + lanes) // F  # (L,N,C)
    vals = table.reshape(-1, F)[flat]                          # (L,N,C,F)
    out = jnp.sum(vals * weights[..., None], axis=2)           # (L, N, F)
    return out.transpose(1, 0, 2).reshape(N, L * F)


def encode_reference(table: jax.Array, pos: jax.Array,
                     meta: BlockedGridMeta) -> jax.Array:
    """Row-gather formulation: fetch each lookup's whole 128-lane row,
    then select the corner lanes from it. Same math as ``encode`` by an
    independent route; kept as the test reference."""
    L, F = meta.n_levels, meta.n_features_per_level
    N = pos.shape[0]
    rows, local, frac = lookup_geometry(meta, pos)
    lanes, weights = corner_lanes_and_weights(meta, local, frac)
    rowdata = jnp.take_along_axis(
        table, rows[:, :, None].astype(jnp.int32), axis=1)  # (L, N, 128)
    C = lanes.shape[-1]
    feats = []
    for f in range(F):
        vals = jnp.take_along_axis(rowdata, lanes + f, axis=-1)  # (L,N,C)
        feats.append(jnp.sum(vals * weights, axis=-1))     # (L, N)
    out = jnp.stack(feats, axis=-1)                        # (L, N, F)
    return out.transpose(1, 0, 2).reshape(N, L * F)
