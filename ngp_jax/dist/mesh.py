"""Distributed execution: device mesh + sharding helpers.

The reference is strictly single-GPU (ref: README.md:239-241 — multi-GPU
unsupported); scaling here is a new, first-class design (SURVEY §2.10):

- **DP (ray/sample parallel)**: the batch axis of training samples/rays is
  sharded across the mesh's ``data`` axis; XLA inserts the gradient psum
  over the interconnect. Rays are embarrassingly parallel, so this is the main axis.
- **TP (table parallel)**: the hash table is the only large parameter
  (tens of MB); for very large configs it can be sharded by rows across
  the ``model`` axis (gathers become all-gathers of requested rows).
  MLPs are tiny and always replicated.
- PP/SP/EP do not apply to these MLP workloads (no layers deep enough, no
  sequence axis, no experts) — recorded deliberately, mirroring SURVEY
  §2.10's analysis.

Everything is expressed with ``jax.sharding`` + jit (GSPMD); there is no
hand-written collective on the training path.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices=None) -> Mesh:
    """Create a (data, model) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_model
    dev = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(dev, axis_names=("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (sample/ray) axis across the data axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def table_sharding(mesh: Mesh) -> NamedSharding:
    """Row-shard the flat hash table across the model axis (TP)."""
    return NamedSharding(mesh, P("model"))


def make_tp_blocked_encode(meta, mesh: Mesh, data_sharded: bool = True):
    """TP execution path for the blocked-grid encoding: the (L, R, 128)
    table is row-sharded over the ``model`` axis; every shard computes the
    GLOBAL lookup geometry, contributes partial features from the rows it
    owns (out-of-shard corners masked to zero), and a psum over the mesh
    combines them. Gradients flow back shard-locally through the psum —
    each device accumulates dTable only for its own rows, so table memory
    AND backward bandwidth scale 1/M (the gigapixel/large-T regime,
    SURVEY §2.10 TP).

    Returns encode(table_sharded, pos) → (N, L·F). ``data_sharded`` also
    shards the sample axis over ``data`` (DP×TP).
    """
    from jax import shard_map
    from ngp_jax.kernels.blocked_grid import (corner_lanes_and_weights,
                                              lookup_geometry)
    import jax.numpy as jnp

    M = mesh.shape["model"]
    if meta.rows % M:
        raise ValueError(f"rows {meta.rows} not divisible by model={M}")
    R_local = meta.rows // M

    def shard_fn(tbl_local, pos):
        lo = jax.lax.axis_index("model") * R_local
        rows, local, frac = lookup_geometry(meta, pos)       # global rows
        lanes, weights = corner_lanes_and_weights(meta, local, frac)
        lrows = rows - lo
        inside = (lrows >= 0) & (lrows < R_local)            # (L, N)
        lrows = jnp.clip(lrows, 0, R_local - 1)
        rowdata = jnp.take_along_axis(
            tbl_local, lrows[:, :, None].astype(jnp.int32), axis=1)
        feats = []
        for f in range(meta.n_features_per_level):
            vals = jnp.take_along_axis(rowdata, lanes + f, axis=-1)
            feats.append(jnp.sum(vals * weights, axis=-1) * inside)
        out = jnp.stack(feats, -1)                           # (L, N, F)
        out = out.transpose(1, 0, 2).reshape(pos.shape[0], -1)
        return jax.lax.psum(out, "model")

    pos_spec = P("data") if data_sharded else P()
    out_spec = P("data") if data_sharded else P()
    return shard_map(shard_fn, mesh=mesh,
                     in_specs=(P(None, "model", None), pos_spec),
                     out_specs=out_spec, check_vma=False)


def shard_params(params, mesh: Mesh, shard_tables: bool = False):
    """Place a parameter pytree on the mesh: tables optionally TP-sharded
    (1-D leaves above 1M elements), everything else replicated."""
    rep = replicated(mesh)
    tab = table_sharding(mesh)

    def place(x):
        if shard_tables and x.ndim == 1 and x.size >= (1 << 20):
            return jax.device_put(x, tab)
        return jax.device_put(x, rep)

    return jax.tree.map(place, params)
