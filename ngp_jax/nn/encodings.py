"""Input encodings: SphericalHarmonics, OneBlob, Frequency, Identity,
Composite, and the grid encodings (Hash/Dense/Tiled via HashGridMeta).

Functional equivalents of tiny-cuda-nn's encodings as used by the reference
configs (e.g. /root/reference/configs/nerf/base.json: SH degree 4 composite
with Identity). Pure jnp — XLA fuses these into the surrounding matmuls.

Each encoding is represented as an object with:
  - ``n_output_dims``
  - ``init_params(key)`` → pytree (empty tuple for parameterless encodings)
  - ``apply(params, x)`` → (N, n_output_dims)
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from ngp_jax.kernels.hashgrid import HashGridMeta, hashgrid_encode_with_max_level


class Identity:
    def __init__(self, n_dims: int, scale: float = 1.0, offset: float = 0.0):
        self.n_dims = n_dims
        self.scale = scale
        self.offset = offset
        self.n_output_dims = n_dims

    def init_params(self, key):
        return ()

    def apply(self, params, x, **_):
        return x * self.scale + self.offset


class Frequency:
    """NeRF-style frequency encoding: per dim, sin/cos at 2^k scales."""

    def __init__(self, n_dims: int, n_frequencies: int = 12):
        self.n_dims = n_dims
        self.n_frequencies = n_frequencies
        self.n_output_dims = n_dims * n_frequencies * 2

    def init_params(self, key):
        return ()

    def apply(self, params, x, **_):
        freqs = jnp.exp2(jnp.arange(self.n_frequencies, dtype=jnp.float32))
        ang = x[..., :, None] * freqs[None, :] * math.pi  # (N, D, K)
        out = jnp.stack([jnp.sin(ang), jnp.cos(ang)], axis=-1)  # (N, D, K, 2)
        return out.reshape(x.shape[0], self.n_output_dims)


class OneBlob:
    """One-blob encoding (Neural Importance Sampling): each scalar input is
    soft-binned with a quartic kernel of width 1/n_bins integrated per bin."""

    def __init__(self, n_dims: int, n_bins: int = 16):
        self.n_dims = n_dims
        self.n_bins = n_bins
        self.n_output_dims = n_dims * n_bins

    def init_params(self, key):
        return ()

    @staticmethod
    def _quartic_cdf(x, inv_radius):
        """CDF of the normalized quartic kernel 15/16 (1-u^2)^2 on [-1,1]."""
        u = jnp.clip(x * inv_radius, -1.0, 1.0)
        return 0.5 + (15.0 / 16.0) * (u - 2.0 * u**3 / 3.0 + u**5 / 5.0)

    def apply(self, params, x, **_):
        n = self.n_bins
        inv_radius = n * 0.5  # kernel radius = 2 * bin width (tcnn uses 1/n * 2)
        edges = jnp.arange(n + 1, dtype=jnp.float32) / n        # (n+1,)
        d = edges[None, None, :] - x[..., :, None]              # (N, D, n+1)
        cdf = self._quartic_cdf(d, inv_radius)
        out = cdf[..., 1:] - cdf[..., :-1]                      # (N, D, n)
        return out.reshape(x.shape[0], self.n_output_dims)


class SphericalHarmonics:
    """Real SH basis up to degree 4 (16 coeffs), matching tcnn's polynomial
    evaluation. Input is the *warped* direction in [0,1]^3 (ref:
    warp_direction, src/testbed_nerf.cu:291-294); we unwarp internally."""

    def __init__(self, n_dims: int = 3, degree: int = 4):
        assert n_dims == 3
        if not (1 <= degree <= 4):
            raise ValueError("SH degree 1..4 supported")
        self.degree = degree
        self.n_output_dims = degree * degree

    def init_params(self, key):
        return ()

    def apply(self, params, dirs01, **_):
        d = dirs01 * 2.0 - 1.0
        x, y, z = d[..., 0], d[..., 1], d[..., 2]
        xy, xz, yz = x * y, x * z, y * z
        x2, y2, z2 = x * x, y * y, z * z
        out = [jnp.full_like(x, 0.28209479177387814)]
        if self.degree >= 2:
            out += [
                -0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x,
            ]
        if self.degree >= 3:
            out += [
                1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * x2 - 0.54627421529603959 * y2,
            ]
        if self.degree >= 4:
            out += [
                0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2),
            ]
        return jnp.stack(out, axis=-1)


class Composite:
    """Applies nested encodings to consecutive slices of the input
    (ref: dir_encoding in configs/nerf/base.json)."""

    def __init__(self, parts: Sequence[tuple[int, Any]]):
        # parts: list of (n_dims_to_encode, encoding)
        self.parts = list(parts)
        self.n_output_dims = sum(e.n_output_dims for _, e in self.parts)

    def init_params(self, key):
        keys = jax.random.split(key, max(len(self.parts), 1))
        return tuple(e.init_params(k) for k, (_, e) in zip(keys, self.parts))

    def apply(self, params, x, **kw):
        outs, off = [], 0
        for p, (nd, enc) in zip(params, self.parts):
            outs.append(enc.apply(p, x[..., off:off + nd], **kw))
            off += nd
        return jnp.concatenate(outs, axis=-1)


class GridEncoding:
    """Hash/Dense/Tiled grid encoding wrapper around the hashgrid kernel."""

    def __init__(self, meta: HashGridMeta):
        self.meta = meta
        self.n_output_dims = meta.n_output_dims

    def init_params(self, key):
        return self.meta.init_params(key)

    def apply(self, params, x, max_level=None, **_):
        return hashgrid_encode_with_max_level(params, x, self.meta, max_level)


class BlockedGridEncoding:
    """Blocked multiresolution grid (see kernels/blocked_grid.py)."""

    def __init__(self, meta):
        self.meta = meta
        self.n_output_dims = meta.n_output_dims

    def resolved_config(self) -> dict:
        """Layout keys that MUST persist into snapshots: a table trained
        under one row hash / row count decodes to garbage under another
        (round-3 advisor: flipping the default row_hash silently broke
        old snapshots that carried no row_hash key)."""
        return {"row_hash": self.meta.row_hash,
                "log2_rows": self.meta.log2_rows}

    def init_params(self, key):
        return self.meta.init_params(key)

    def apply(self, params, x, max_level=None, **_):
        from ngp_jax.kernels.blocked_grid import encode
        out = encode(params, x, self.meta)
        if max_level is None:
            return out
        L, F = self.meta.n_levels, self.meta.n_features_per_level
        level_ids = jnp.arange(L * F) // F
        ml = jnp.asarray(max_level)
        thresh = ml * L
        mask = ((level_ids < thresh) if ml.ndim == 0
                else (level_ids[None, :] < thresh[:, None]))
        return out * mask.astype(out.dtype)


def create_encoding(n_dims: int, cfg: dict):
    """Factory mirroring tcnn::create_encoding (by ``otype``)."""
    otype = cfg.get("otype", "Identity").lower()
    if "grid" in otype:
        # HashGrid / DenseGrid / TiledGrid / BlockedGrid. HashGrid maps to
        # the blocked grid by default (NGP_GRID_IMPL=tcnn forces the
        # tcnn-layout gather implementation instead).
        import os
        c = dict(cfg)
        c.setdefault("n_pos_dims", n_dims)
        impl = os.environ.get("NGP_GRID_IMPL", "blocked").lower()
        if otype.startswith("blocked") or (impl == "blocked"
                                           and not otype.startswith("dense")
                                           and c["n_pos_dims"] in (2, 3)):
            from ngp_jax.kernels.blocked_grid import BlockedGridMeta
            return BlockedGridEncoding(BlockedGridMeta.from_hashgrid_config(c))
        if otype.startswith("dense"):
            c["log2_hashmap_size"] = 40  # effectively infinite → all dense
        meta = HashGridMeta.from_config(c)
        return GridEncoding(meta)
    if otype == "identity":
        return Identity(n_dims, cfg.get("scale", 1.0), cfg.get("offset", 0.0))
    if otype == "frequency":
        return Frequency(n_dims, cfg.get("n_frequencies", 12))
    if otype == "oneblob":
        return OneBlob(n_dims, cfg.get("n_bins", 16))
    if otype == "sphericalharmonics":
        return SphericalHarmonics(n_dims, cfg.get("degree", 4))
    if otype == "composite":
        parts, remaining = [], n_dims
        nested = cfg.get("nested", [])
        for i, sub in enumerate(nested):
            nd = sub.get("n_dims_to_encode")
            if nd is None:
                nd = remaining if i == len(nested) - 1 else remaining
            enc = create_encoding(nd, sub)
            parts.append((nd, enc))
            remaining -= nd
        return Composite(parts)
    raise ValueError(f"unknown encoding otype {cfg.get('otype')!r}")
