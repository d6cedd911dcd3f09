"""Cascaded occupancy grid: maintenance + lookups.

Equivalent of the reference's density-grid subsystem
(ref: src/testbed_nerf.cu:465-620, 2761-2859): a 128³ grid per cascade
storing an EMA'd max-splat of σ·Δt_min, thresholded into a bitfield with
max-pooled mips. Everything here is one jitted update — cell sweep,
density eval, EMA, mean, bit packing, mip pooling — with no host sync.

Layout (redesign; differs from the reference's Morton order):
- grid values: ((max_cascade+1)·128³,) float32 in LINEAR (z,y,x) order per
  cascade. Linear order makes every maintenance step a reshape/slice —
  the mip max-pool is a (64,2,64,2,64,2) any-reduce plus a center-cube
  slice assignment, and the periodic cell sweep is a strided slice — so
  the update needs NO scatter at all. It also removes the per-sample Morton
  bit-interleave from the hot march path.
- bitfield: (NERF_CASCADES·128³//8,) uint8. Byte index = linear index of
  (x//2, y//2, z//2) in a 64³ grid; bit = (x&1) | (y&1)<<1 | (z&1)<<2 —
  i.e. bytes are 2×2×2 blocks like the reference's Morton packing, but
  block order is linear.
- The REFERENCE layout (Morton, ref: cascaded_grid_idx_at) is preserved at
  the snapshot boundary: ``density_to_morton``/``density_from_morton``
  convert when reading/writing ``density_grid_binary`` payloads
  (ref: src/testbed.cu:3018-3023).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ngp_jax.common import (GRID_VOLUME, NERF_CASCADES, NERF_GRIDSIZE,
                            NERF_MIN_OPTICAL_THICKNESS, MIN_CONE_STEPSIZE)

G = NERF_GRIDSIZE          # 128
GH = NERF_GRIDSIZE // 2    # 64 (byte-block grid side)


# --- Morton (z-order) encoding — snapshot-boundary + parity tests only -------

def _part1by2(x: jax.Array) -> jax.Array:
    x = x.astype(jnp.uint32) & jnp.uint32(0x3FF)
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def _compact1by2(x: jax.Array) -> jax.Array:
    x = x.astype(jnp.uint32) & jnp.uint32(0x09249249)
    x = (x | (x >> 2)) & jnp.uint32(0x030C30C3)
    x = (x | (x >> 4)) & jnp.uint32(0x0300F00F)
    x = (x | (x >> 8)) & jnp.uint32(0x030000FF)
    x = (x | (x >> 16)) & jnp.uint32(0x000003FF)
    return x


def morton3d(x, y, z) -> jax.Array:
    return (_part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)).astype(jnp.int32)


def morton3d_invert(idx) -> tuple[jax.Array, jax.Array, jax.Array]:
    i = jnp.asarray(idx).astype(jnp.uint32)
    return (_compact1by2(i).astype(jnp.int32),
            _compact1by2(i >> 1).astype(jnp.int32),
            _compact1by2(i >> 2).astype(jnp.int32))


def _morton_perm() -> np.ndarray:
    """linear index → Morton index, one 128³ cascade (static, cached)."""
    global _MORTON_PERM
    if _MORTON_PERM is None:
        idx = np.arange(GRID_VOLUME, dtype=np.uint32)
        x = idx % G
        y = (idx // G) % G
        z = idx // (G * G)

        def part(v):
            v = v.astype(np.uint32) & 0x3FF
            v = (v | (v << 16)) & 0x030000FF
            v = (v | (v << 8)) & 0x0300F00F
            v = (v | (v << 4)) & 0x030C30C3
            v = (v | (v << 2)) & 0x09249249
            return v
        _MORTON_PERM = (part(x) | (part(y) << 1) | (part(z) << 2)).astype(np.int64)
    return _MORTON_PERM


_MORTON_PERM = None


def density_to_morton(density: np.ndarray) -> np.ndarray:
    """Linear-layout density → reference Morton layout (per cascade)."""
    d = np.asarray(density).reshape(-1, GRID_VOLUME)
    out = np.empty_like(d)
    out[:, _morton_perm()] = d
    return out.reshape(np.asarray(density).shape)


def density_from_morton(density: np.ndarray) -> np.ndarray:
    """Reference Morton-layout density → linear layout (per cascade)."""
    d = np.asarray(density).reshape(-1, GRID_VOLUME)
    out = d[:, _morton_perm()]
    return out.reshape(np.asarray(density).shape)


# --- mip / cell helpers (ref: src/testbed_nerf.cu:267-352,449-463) -----------

def mip_from_pos(pos: jax.Array, max_cascade: int) -> jax.Array:
    """Smallest cascade whose [0,1]-scaled cube contains pos (pos in
    ngp/world units, scene centered at 0.5)."""
    maxval = jnp.max(jnp.abs(pos - 0.5), axis=-1)
    # frexpf: maxval = m·2^e with m ∈ [0.5,1) → e = floor(log2(maxval)) + 1
    exponent = jnp.floor(jnp.log2(jnp.maximum(maxval, 1e-10))).astype(jnp.int32) + 1
    return jnp.clip(exponent + 1, 0, max_cascade)


def mip_from_dt(dt: jax.Array, pos: jax.Array, max_cascade: int) -> jax.Array:
    mip = mip_from_pos(pos, max_cascade)
    d = dt * (2 * NERF_GRIDSIZE)
    e = jnp.floor(jnp.log2(jnp.maximum(d, 1e-10))).astype(jnp.int32) + 1
    return jnp.where(d < 1.0, mip, jnp.clip(jnp.maximum(e, mip), 0, max_cascade))


def cell_coords_at(pos: jax.Array, mip: jax.Array) -> jax.Array:
    """Integer cell coords (N,3) of pos at the given mip."""
    scale = jnp.exp2(-mip.astype(jnp.float32))[:, None]
    p = (pos - 0.5) * scale + 0.5
    return jnp.clip((p * NERF_GRIDSIZE).astype(jnp.int32), 0, NERF_GRIDSIZE - 1)


def cell_idx_at(pos: jax.Array, mip: jax.Array) -> jax.Array:
    """LINEAR cell index of pos at the given mip (pos (N,3), mip (N,))."""
    i = cell_coords_at(pos, mip)
    return (i[:, 2] * G + i[:, 1]) * G + i[:, 0]


def occupied_at(bitfield: jax.Array, pos: jax.Array, mip: jax.Array) -> jax.Array:
    """Occupancy lookup (ref: density_grid_occupied_at)."""
    i = cell_coords_at(pos, mip)
    byte = ((i[:, 2] >> 1) * GH + (i[:, 1] >> 1)) * GH + (i[:, 0] >> 1)
    bit = (i[:, 0] & 1) | ((i[:, 1] & 1) << 1) | ((i[:, 2] & 1) << 2)
    v = jnp.take(bitfield, byte + mip * (GRID_VOLUME // 8), mode="clip")
    return (v >> bit.astype(jnp.uint8)) & jnp.uint8(1) > 0


# --- grid state ---------------------------------------------------------------

class OccupancyGrid(NamedTuple):
    """Functional state of the cascaded grid."""
    density: jax.Array    # ((max_cascade+1)·128³,) f32 linear, <0 untrained
    bitfield: jax.Array   # (NERF_CASCADES·128³//8,) uint8
    mean: jax.Array       # scalar f32: mean clamped level-0 density
    ema_step: jax.Array   # int32 update counter
    coarse: jax.Array = None  # (NERF_CASCADES·16³,) uint8 conservative mask


GC = 16  # coarse mask side (128 / 8)


def init_grid(max_cascade: int) -> OccupancyGrid:
    # fresh_zeros: the grid is donated through the train chunk; eager
    # jnp.zeros of equal shape/dtype may share one constant buffer
    from ngp_jax.common import fresh_zeros
    n = GRID_VOLUME * (max_cascade + 1)
    return OccupancyGrid(
        density=fresh_zeros((n,), jnp.float32),
        bitfield=fresh_zeros((NERF_CASCADES * GRID_VOLUME // 8,), jnp.uint8),
        mean=fresh_zeros((), jnp.float32),
        ema_step=fresh_zeros((), jnp.int32),
        coarse=fresh_zeros((NERF_CASCADES * GC ** 3,), jnp.uint8),
    )


def _linear_coords(idx: jax.Array):
    x = idx % G
    y = (idx // G) % G
    z = idx // (G * G)
    return x, y, z


def cell_center_positions(max_cascade: int) -> jax.Array:
    """World positions of all cell centers for every cascade, linear order
    — used by mark_untrained (ref: mark_untrained_density_grid)."""
    idx = jnp.arange(GRID_VOLUME, dtype=jnp.int32)
    x, y, z = _linear_coords(idx)
    base = (jnp.stack([x, y, z], -1).astype(jnp.float32) + 0.5) / NERF_GRIDSIZE
    levels = jnp.exp2(jnp.arange(max_cascade + 1, dtype=jnp.float32))
    pos = (base[None] - 0.5) * levels[:, None, None] + 0.5   # (C, V, 3)
    return pos.reshape(-1, 3)


def mark_untrained(max_cascade: int, xforms: jax.Array, focal: jax.Array,
                   resolution: jax.Array) -> jax.Array:
    """Mark cells invisible from every training camera with -1
    (ref: mark_untrained_density_grid, src/testbed_nerf.cu:369-417).

    xforms: (I, 3, 4) camera-to-world; focal: (I, 2); resolution: (I, 2).
    Returns the initial density vector ((max_cascade+1)·V,) in linear order.
    """
    pos = cell_center_positions(max_cascade)                  # (N, 3)
    levels = jnp.repeat(jnp.arange(max_cascade + 1), GRID_VOLUME)
    voxel_radius = 0.5 * (3.0 ** 0.5) * jnp.exp2(
        levels.astype(jnp.float32)) / NERF_GRIDSIZE         # (N,)

    def visible_from(carry, cam):
        xf, f, res = cam
        ploc = pos - xf[:, 3][None]                           # (N, 3)
        x, y, z = (jnp.matmul(ploc, xf[:, i], precision="highest")
                   for i in range(3))
        half = res.astype(jnp.float32) * 0.5
        vis = (z > 0) & \
            (jnp.abs(x) - voxel_radius < z / f[0] * half[0]) & \
            (jnp.abs(y) - voxel_radius < z / f[1] * half[1])
        return carry | vis, None

    seen, _ = jax.lax.scan(visible_from,
                           jnp.zeros(pos.shape[0], bool),
                           (xforms, focal, resolution))
    return jnp.where(seen, 0.0, -1.0)


def update_grid(
    grid: OccupancyGrid,
    density_fn: Callable[[jax.Array], jax.Array],
    key: jax.Array,
    max_cascade: int,
    decay: float = 0.95,
    n_uniform: int = GRID_VOLUME // 4,
    n_nonuniform: int = GRID_VOLUME // 4,
    aabb_min: jax.Array | float = 0.0,
    aabb_size: jax.Array | float = 1.0,
) -> OccupancyGrid:
    """One grid maintenance step.

    The reference samples ¼ of cells uniformly + ¼ biased toward occupied
    ones with an LCG retry loop and scatter-max splats
    (ref: update_density_grid_nerf :2761-2842). Redesign: a
    deterministic BLOCK-CYCLIC SWEEP with the same per-update budget
    (n_uniform + n_nonuniform cells): update k visits the contiguous cell
    block [b·n, (b+1)·n) with b = ema_step mod n_blocks, so every cell is
    refreshed exactly every `n_blocks` updates — the same expected cadence
    as the reference's random sampling with a strictly better worst case —
    and the update is a dynamic_slice + dynamic_update_slice (no scatter,
    no gather, no strided relayout). Sample positions are still jittered
    uniformly within each cell.

    ``density_fn`` maps *warped* positions (N,3)∈[0,1]³ → σ (N,).
    ``aabb_min/size`` define the training AABB for the warp.
    """
    n_cascades = max_cascade + 1
    n_cells = GRID_VOLUME * n_cascades
    budget = max(n_uniform + n_nonuniform, 1)
    k1, _ = jax.random.split(key)

    if budget >= n_cells:
        # full sweep (warmup, ref: all cells while step < 256)
        idx = jnp.arange(n_cells, dtype=jnp.int32)
        level = idx // GRID_VOLUME
        x, y, z = _linear_coords(idx % GRID_VOLUME)
        cell = jnp.stack([x, y, z], -1).astype(jnp.float32)
        u = jax.random.uniform(k1, (n_cells, 3))
        lv = jnp.exp2(level.astype(jnp.float32))[:, None]
        pos = ((cell + u) / NERF_GRIDSIZE - 0.5) * lv + 0.5
        warped = (pos - aabb_min) / aabb_size
        splat = density_fn(warped) * MIN_CONE_STEPSIZE
        density = jnp.where(grid.density < 0.0, grid.density,
                            jnp.maximum(grid.density * decay, splat))
        return rebuild_bitfield(grid._replace(
            density=density, ema_step=grid.ema_step + 1), max_cascade)

    # INTERLEAVED slab-cyclic sweep: update k refreshes every n_blocks-th
    # z-slab (one slab = one z layer of 128² cells, contiguous in the
    # linear layout), rotating the phase each update. Spatial interleaving
    # is load-bearing, not cosmetic: a CONTIGUOUS half-grid block (round-3
    # design) interacted with the relative mean threshold catastrophically
    # on near-uniform early density — the decayed half (0.95·c) fell below
    # the mean (0.975·c) and an entire HALF-SPACE of the scene was culled
    # from training every window (found round 4: one partial sweep took
    # level-0 z<64 occupancy from 95% to 0%). Slab interleave keeps
    # refreshed/decayed cells mixed at 1-cell z granularity, so the cull
    # pattern is spatially uniform like the reference's random ¼ sampling
    # (ref: generate_grid_samples_nerf_nonuniform :465).
    # Implementation stays relayout-free: rows = z-slabs (C·128, 128²);
    # selecting every n_blocks-th row is a middle-dim slice after a
    # (rows/n_blocks, n_blocks, 128²) reshape — the minor (lane) dim is
    # untouched, so no scatter/gather/strided relayout anywhere.
    n_rows = n_cascades * G
    row_sz = G * G
    n_blocks = max(int(round(n_cells / budget)), 1)
    while n_rows % n_blocks:                     # need a divisor of rows
        n_blocks -= 1
    n_sel = n_rows // n_blocks
    phase = grid.ema_step % n_blocks                           # traced
    rows3 = jnp.arange(n_sel, dtype=jnp.int32) * n_blocks
    row_idx = rows3 + phase                                    # (n_sel,)
    idx = (row_idx[:, None] * row_sz
           + jnp.arange(row_sz, dtype=jnp.int32)[None]).reshape(-1)
    level = idx // GRID_VOLUME
    x, y, z = _linear_coords(idx % GRID_VOLUME)
    cell = jnp.stack([x, y, z], -1).astype(jnp.float32)
    n = n_sel * row_sz
    u = jax.random.uniform(k1, (n, 3))
    lv = jnp.exp2(level.astype(jnp.float32))[:, None]
    pos = ((cell + u) / NERF_GRIDSIZE - 0.5) * lv + 0.5
    warped = (pos - aabb_min) / aabb_size
    splat = density_fn(warped) * MIN_CONE_STEPSIZE             # (n,)

    # EMA decay everywhere (ref: ema_grid_samples_nerf decays all cells),
    # max-merge the swept slabs via a middle-dim dynamic slice.
    decayed = grid.density * decay
    d3 = decayed.reshape(n_sel, n_blocks, row_sz)
    slab = jax.lax.dynamic_slice(d3, (0, phase, 0),
                                 (n_sel, 1, row_sz))           # (n_sel,1,·)
    merged = jnp.maximum(slab, splat.reshape(n_sel, 1, row_sz))
    new_density = jax.lax.dynamic_update_slice(
        d3, merged, (0, phase, 0)).reshape(-1)
    new_density = jnp.where(grid.density < 0.0, grid.density, new_density)

    return rebuild_bitfield(grid._replace(
        density=new_density, ema_step=grid.ema_step + 1), max_cascade)


def rebuild_bitfield(grid: OccupancyGrid, max_cascade: int) -> OccupancyGrid:
    """Mean + threshold + bit packing + mip max-pool
    (ref: update_density_grid_mean_and_bitfield). All reshapes/slices in
    the linear layout — no scatter/gather."""
    level0 = grid.density[:GRID_VOLUME]
    mean = jnp.mean(jnp.maximum(level0, 0.0))
    thresh = jnp.minimum(NERF_MIN_OPTICAL_THICKNESS, mean)

    n_cascades = grid.density.shape[0] // GRID_VOLUME
    occ = grid.density.reshape(n_cascades, G, G, G) > thresh   # (C,z,y,x)

    def pack_level(cur):
        """(128³ bool) → (64³ uint8): byte = linear block (x//2,y//2,z//2),
        bit = x&1 | y&1<<1 | z&1<<2, as a strided weighted reduce."""
        b = cur.reshape(GH, 2, GH, 2, GH, 2).astype(jnp.int32)
        w = jnp.arange(2, dtype=jnp.int32)
        weights = (jnp.int32(1) <<
                   (w[:, None, None] * 4 + w[None, :, None] * 2
                    + w[None, None, :]))                       # (z1,y1,x1)
        return jnp.sum(
            b * weights[:, None, :, None, :].reshape(1, 2, 1, 2, 1, 2),
            axis=(1, 3, 5)).astype(jnp.uint8)                  # (GH,GH,GH)

    # mip max-pool (ref: bitfield_max_pool): the whole level-L cube maps to
    # the center half of level L+1. The packed BYTES of level L already ARE
    # its 2×2×2 any-pool (byte ≠ 0 ⇔ block occupied), and one level-L byte
    # block covers exactly one level-L+1 cell at offset +G/4 — so pooling
    # is (bytes != 0) OR'd into the center cube. No extra strided reduces.
    q = G // 4
    zero = jnp.zeros((G, G, G), bool)
    packed_levels = []
    for m in range(NERF_CASCADES):
        cur = occ[m] if m < n_cascades else zero
        if m > 0:
            pooled = packed_levels[m - 1] != 0                 # (GH,)³ bool
            cur = cur.at[q: 3 * q, q: 3 * q, q: 3 * q].set(
                cur[q: 3 * q, q: 3 * q, q: 3 * q] | pooled)
        packed_levels.append(pack_level(cur))
    packed = jnp.stack(packed_levels)                          # (8,GH,GH,GH)
    coarse = _build_coarse_mask(packed)
    return grid._replace(bitfield=packed.reshape(-1), mean=mean,
                         coarse=coarse)


def _build_coarse_mask(packed: jax.Array) -> jax.Array:
    """Conservative 16³ per-mip 'maybe occupied' mask for hierarchical
    (segment-level) march culling. A coarse cell is set iff any fine cell
    within ±1 coarse cell of it, at its own mip OR any coarser mip's
    overlapping region, is occupied — so a segment test at the midpoint's
    mip can never cull a sample a fine test would keep."""
    C = NERF_CASCADES
    byte_any = (packed != 0)                                   # (C,GH,GH,GH)
    # 4× any-pool: z/y via (non-minor) reshape, x via a pooling matmul
    # (a minor-dim (…,4) reshape relayouts; matmul avoids it)
    cz = byte_any.reshape(C, GC, 4, GH, GH).any(2)
    czy = cz.reshape(C, GC, GC, 4, GH).any(3)
    pool_mat = (jnp.arange(GH)[:, None] // 4 ==
                jnp.arange(GC)[None, :]).astype(jnp.float32)
    coarse = (czy.astype(jnp.float32) @ pool_mat) > 0          # (C,GC³)

    # union of coarser mips: mip m+1's center half == mip m's whole box
    levels = [coarse[m] for m in range(C)]
    for m in range(C - 2, -1, -1):
        q = GC // 4
        up = levels[m + 1][q: 3 * q, q: 3 * q, q: 3 * q]       # (8,8,8)
        up2 = jnp.repeat(jnp.repeat(jnp.repeat(up, 2, 0), 2, 1), 2, 2)
        levels[m] = levels[m] | up2
    u = jnp.stack(levels)

    # spatial dilation ±1 (conservative for any sample within the segment)
    pad = jnp.pad(u, ((0, 0), (1, 1), (1, 1), (1, 1)))
    d = u
    for dz in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                d = d | pad[:, dz: dz + GC, dy: dy + GC, dx: dx + GC]
    return d.astype(jnp.uint8).reshape(-1)


def coarse_occupied_at(coarse: jax.Array, pos: jax.Array,
                       mip: jax.Array) -> jax.Array:
    """Conservative segment-level occupancy lookup on the 16³ mask."""
    scale = jnp.exp2(-mip.astype(jnp.float32))[:, None]
    p = (pos - 0.5) * scale + 0.5
    i = jnp.clip((p * GC).astype(jnp.int32), 0, GC - 1)
    idx = ((i[:, 2] * GC + i[:, 1]) * GC + i[:, 0]) + mip * GC ** 3
    return jnp.take(coarse, idx, mode="clip") > 0
