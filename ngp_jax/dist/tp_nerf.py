"""Tensor-parallel NeRF training: the blocked hash table row-sharded
over the mesh's ``model`` axis, composable with ray DP over ``data``.

The reference is single-GPU with the whole table resident
(ref: README.md:239-241); gigapixel-class NeRF configs (T > 2^21) want
the table split. SURVEY §2.10 TP design: every shard computes the GLOBAL
lookup geometry, contributes the feature corners whose rows it owns
(out-of-shard corners masked to zero), and one psum over the mesh assembles
the encoding; gradients flow back shard-locally through the psum, so
table memory AND table-gradient bandwidth scale 1/M. The rest of the
step (march, compaction, MLP, composite loss, Adam) is the SAME
``NerfTrainer._train_step_impl`` the single-device and DP paths run —
only the encoding lookup and the parameter/optimizer sharding change.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


class TpBlockedGridEncoding:
    """Shard-local view of BlockedGridEncoding for use INSIDE a
    shard_map over a mesh with a ``model`` axis: ``params`` is the local
    (L, rows/M, 128) table shard; apply() masks out-of-shard rows and
    psums the partial features."""

    def __init__(self, base, n_model: int):
        if base.meta.rows % n_model:
            raise ValueError(
                f"rows {base.meta.rows} not divisible by model={n_model}")
        self.base = base
        self.meta = base.meta
        self.n_output_dims = base.n_output_dims
        self.n_model = n_model
        self.rows_local = base.meta.rows // n_model

    def resolved_config(self) -> dict:
        return self.base.resolved_config()

    def init_params(self, key):
        return self.base.init_params(key)   # full table (host-side init)

    def apply(self, params, x, max_level=None, **_):
        from ngp_jax.kernels.blocked_grid import (corner_lanes_and_weights,
                                                  lookup_geometry)
        meta = self.meta
        rows, local, frac = lookup_geometry(meta, x)       # global rows
        lanes, weights = corner_lanes_and_weights(meta, local, frac)
        lo = jax.lax.axis_index("model") * self.rows_local
        lrows = rows - lo
        inside = (lrows >= 0) & (lrows < self.rows_local)  # (L, N)
        lrows = jnp.clip(lrows, 0, self.rows_local - 1)
        rowdata = jnp.take_along_axis(
            params, lrows[:, :, None].astype(jnp.int32), axis=1)
        feats = []
        for f in range(meta.n_features_per_level):
            vals = jnp.take_along_axis(rowdata, lanes + f, axis=-1)
            feats.append(jnp.sum(vals * weights, axis=-1) * inside)
        out = jnp.stack(feats, -1)                         # (L, N, F)
        out = out.transpose(1, 0, 2).reshape(x.shape[0], -1)
        out = jax.lax.psum(out, "model")
        if max_level is None:
            return out
        L, F = meta.n_levels, meta.n_features_per_level
        level_ids = jnp.arange(L * F) // F
        ml = jnp.asarray(max_level)
        thresh = ml * L
        mask = ((level_ids < thresh) if ml.ndim == 0
                else (level_ids[None, :] < thresh[:, None]))
        return out * mask.astype(out.dtype)


def _table_specs(tree, table_spec):
    """Spec pytree matching ``tree``: the pos-encoding table leaf gets
    ``table_spec`` (row axis over 'model'), everything else replicated."""
    def spec(path, _):
        head = path[0]
        key = getattr(head, "key", getattr(head, "name", None))
        return table_spec if key == "pos_encoding" else P()
    return jax.tree_util.tree_map_with_path(spec, tree)


def make_tp_nerf_train_step(trainer, mesh: Mesh,
                            n_rays_per_device: int = 256,
                            samples_per_device: int = 1 << 13):
    """Build a jitted DPxTP train step: rays shard over ``data``, the
    blocked table row-shards over ``model`` (axis 1 of the (L, R, 128)
    table). BINDS the trainer's model to the TP encoding — use a
    dedicated trainer instance.

    step(params, opt_state, cam, cam_m, cam_v, error_map, sharp_grid,
         err_state, bitfield, coarse, grid_mean, key, data)
      → (params, opt_state, loss)
    ``params`` / ``opt_state`` pass in and come out with the table
    row-sharded (as global arrays under jit with NamedSharding).
    """
    from ngp_jax.nn.encodings import BlockedGridEncoding
    base = trainer.model.pos_encoding
    if not isinstance(base, BlockedGridEncoding):
        raise ValueError("TP NeRF requires the blocked-grid encoding")
    M = mesh.shape["model"]
    trainer.model.pos_encoding = TpBlockedGridEncoding(base, M)

    table_spec = P(None, "model", None)
    p_specs = _table_specs(trainer.params, table_spec)
    s_specs = type(trainer.opt_state)(
        step=P(), mu=p_specs, nu=p_specs, ema_params=p_specs)

    def per_device(params, opt_state, cam, cam_m, cam_v, error_map,
                   sharp_grid, err_state, bitfield, coarse, grid_mean,
                   key, data):
        # same rays for every model shard within a data row
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        params, opt_state, *_, stats, _ = trainer._train_step_impl(
            params, opt_state, cam, cam_m, cam_v, error_map,
            sharp_grid, err_state, bitfield, coarse, grid_mean, key,
            data, n_rays=n_rays_per_device, axis_name="data",
            capacity=samples_per_device)
        return params, opt_state, stats.loss

    sharded = shard_map(
        per_device, mesh=mesh,
        in_specs=(p_specs, s_specs) + tuple(P() for _ in range(11)),
        out_specs=(p_specs, s_specs, P()),
        check_vma=False)
    return jax.jit(sharded)
