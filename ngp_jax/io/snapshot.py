"""Snapshot save/load (msgpack).

Mirrors the reference's snapshot shape (ref: Testbed::save_snapshot /
load_snapshot, src/testbed.cu:3008-3106): one msgpack document holding the
full network-config JSON plus a ``snapshot`` section with weights, the
fp16-compressed density grid, dataset metadata and training counters.

Differences, by design:
- Model parameters are stored as a named pytree (component → array with
  dtype/shape) instead of tcnn's single flat ``params_binary`` buffer —
  this framework's parameter layout (blocked grid) is not byte-compatible
  with tiny-cuda-nn's. A converter for importing reference msgpacks is
  tracked separately (``import_reference_snapshot``).
- Arrays are saved little-endian with explicit dtype + shape.

Schema (top level):
  {**network_config,
   "snapshot": {
     "version": 2,                  # matches SNAPSHOT_FORMAT_VERSION
     PARAMS_KEY: {...},             # pytree of arrays (train params)
     EMA_PARAMS_KEY: {...},         # EMA copy used for inference
     "density_grid_binary": bytes,  # fp16, Morton order (ref-compatible)
     "density_grid_size": 128,
     "max_cascade": int,
     "training_step": int,
     "loss": float,
     "aabb": {"min": [...], "max": [...]},
     "bounding_radius": float,
     "nerf": {"aabb_scale": int, "rgb": {"rays_per_batch": int},
               "dataset": {...camera metadata...}},
  }}
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import msgpack
import numpy as np

SNAPSHOT_FORMAT_VERSION = 2
# section keys of the on-disk format (existing snapshots carry these names)
PARAMS_KEY = "ngp_tpu_params"
EMA_PARAMS_KEY = "ngp_tpu_ema_params"
OPTIMIZER_KEY = "ngp_tpu_optimizer"


def _pack_array(a) -> dict:
    a = np.asarray(a)
    return {"__ndarray__": True, "dtype": str(a.dtype),
            "shape": list(a.shape), "data": a.tobytes()}


def _unpack_array(d: dict) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


def _pack_tree(tree) -> Any:
    if isinstance(tree, dict):
        return {k: _pack_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__tuple__": True,
                "items": [_pack_tree(v) for v in tree]}
    if tree is None or isinstance(tree, (int, float, str, bool, bytes)):
        return tree
    return _pack_array(tree)


def _unpack_tree(obj):
    if isinstance(obj, dict):
        if obj.get("__ndarray__"):
            return _unpack_array(obj)
        if obj.get("__tuple__"):
            return tuple(_unpack_tree(v) for v in obj["items"])
        return {k: _unpack_tree(v) for k, v in obj.items()}
    return obj


def save_snapshot(path, network_config: dict, params, ema_params,
                  density_grid: Optional[np.ndarray] = None,
                  max_cascade: int = 0, training_step: int = 0,
                  loss: float = 0.0, aabb_scale: int = 1,
                  aabb_min=None, aabb_max=None,
                  rays_per_batch: int = 4096,
                  dataset_meta: Optional[dict] = None,
                  extra: Optional[dict] = None) -> None:
    """Write a snapshot msgpack (ref schema: src/testbed.cu:3008-3042)."""
    snap = {
        "version": SNAPSHOT_FORMAT_VERSION,
        PARAMS_KEY: _pack_tree(params),
        EMA_PARAMS_KEY: _pack_tree(ema_params),
        "density_grid_size": 128,
        "max_cascade": int(max_cascade),
        "training_step": int(training_step),
        "loss": float(loss),
        "bounding_radius": float(aabb_scale) * (3.0 ** 0.5) / 2.0,
        "nerf": {
            "aabb_scale": int(aabb_scale),
            "rgb": {"rays_per_batch": int(rays_per_batch)},
            "dataset": _pack_tree(dataset_meta or {}),
        },
    }
    if density_grid is not None:
        # bytes are Morton-ordered like the reference's payload
        # (ref: cascaded_grid_idx_at); in-memory arrays are linear
        from ngp_jax.grid.occupancy import density_to_morton
        snap["density_grid_binary"] = density_to_morton(
            np.asarray(density_grid, np.float16)).tobytes()
    if aabb_min is not None:
        snap["aabb"] = {"min": [float(x) for x in np.atleast_1d(aabb_min)],
                        "max": [float(x) for x in np.atleast_1d(aabb_max)]}
    if extra:
        snap.update(_pack_tree(extra))
    doc = dict(network_config)
    doc["snapshot"] = snap
    Path(path).write_bytes(msgpack.packb(doc, use_bin_type=True))


def load_snapshot(path) -> dict:
    """Read a snapshot; returns the full document with arrays decoded.
    Rejects incompatible versions like the reference (src/testbed.cu:3052)."""
    doc = msgpack.unpackb(Path(path).read_bytes(), raw=False,
                          strict_map_key=False)
    snap = doc.get("snapshot")
    if snap is None:
        raise ValueError(f"{path}: not a snapshot msgpack")
    version = snap.get("version", 0)
    if PARAMS_KEY in snap:
        snap[PARAMS_KEY] = _unpack_tree(snap[PARAMS_KEY])
        snap[EMA_PARAMS_KEY] = _unpack_tree(snap[EMA_PARAMS_KEY])
    elif "params_binary" not in snap:
        raise ValueError(
            f"snapshot version {version}: neither {PARAMS_KEY} nor a "
            "reference params_binary payload present")
    if "density_grid_binary" in snap:
        from ngp_jax.grid.occupancy import density_from_morton
        snap["density_grid"] = density_from_morton(np.frombuffer(
            snap["density_grid_binary"], np.float16).astype(np.float32))
    if "nerf" in snap and "dataset" in snap["nerf"]:
        snap["nerf"]["dataset"] = _unpack_tree(snap["nerf"]["dataset"])
    return doc


def load_msgpack_config(path) -> dict:
    """Network config embedded in a snapshot msgpack (ref:
    load_network_config accepting .msgpack, src/testbed.cu:120-146)."""
    doc = msgpack.unpackb(Path(path).read_bytes(), raw=False,
                          strict_map_key=False)
    doc.pop("snapshot", None)
    return doc


# --------------------------------------------------------------------------
# Reference (tiny-cuda-nn) snapshot interchange
# --------------------------------------------------------------------------
#
# TCNN ABI ASSUMPTIONS — the single source of truth for both codecs.
# Each row cites where the rule is visible in the reference tree; a
# CUDA-produced snapshot can be validated against this table in minutes
# (no such file ships in this zero-egress environment, so the rules are
# cross-checked against usage sites + an independently hand-constructed
# golden-bytes fixture, tests/test_snapshot_golden.py).
#
# | # | rule | reference evidence |
# |---|------|--------------------|
# | 1 | params_binary is ONE flat fp16 buffer of all trainable params   |
# |   | (snapshot["params_type"] == "__half")                           |
# |   |   ref: src/testbed.cu:3008-3106 save/load_snapshot              |
# | 2 | NerfNetwork param order: density MLP, rgb MLP, pos encoding,    |
# |   | dir encoding (SH: no params)                                    |
# |   |   ref: nerf_network.h:361-394 set_params                        |
# | 3 | NetworkWithInputEncoding (sdf/image/volume Testbed modes) param |
# |   | order: MLP first, then encoding — same member order as rule 2   |
# |   |   ref: nerf_network.h pattern; testbed.cu:2290-2360 builds      |
# |   |   NetworkWithInputEncoding for the non-NeRF modes               |
# | 4 | MLP matrices are (n_out, n_in) ROW-major; our x·W layout is the |
# |   | transpose                                                       |
# |   |   ref: tcnn FullyFusedMLP weight layout (usage:                 |
# |   |   nerf_network.h:81-99 width plumbing)                          |
# | 5 | MLP input widths pad to the next multiple of 16; output widths  |
# |   | pad to 16 (density MLP emits 16 = 1 density + 15 latent)        |
# |   |   ref: nerf_network.h:81-99; padded rgb out rule :169           |
# | 6 | HashGrid levels concatenate; per-level entries = min(res^D, T)  |
# |   | rounded UP to a multiple of 8; F features interleave per entry  |
# |   |   ref: grid resolution rules mirrored in                        |
# |   |   kernels/hashgrid.py:HashGridMeta (level_params)               |
# | 7 | density_grid_binary is fp16 in MORTON order, 128^3 per cascade  |
# |   |   ref: cascaded_grid_idx_at (testbed_nerf.cu)                   |


def _tcnn_mlp_widths(doc: dict, meta):
    """The (n_in, n_out) sequences tcnn allocates for the NerfNetwork's two
    MLPs, with tcnn's 16-multiple padding (ref: nerf_network.h:81-99 +
    set_params order :361-394)."""
    n_neurons = int(doc["network"].get("n_neurons", 64))
    n_hidden = int(doc["network"].get("n_hidden_layers", 1))
    rgb_neurons = int(doc.get("rgb_network", {}).get("n_neurons", 64))
    rgb_hidden = int(doc.get("rgb_network", {}).get("n_hidden_layers", 2))
    pos_padded = ((meta.n_output_dims + 15) // 16) * 16
    density_widths = [(pos_padded, n_neurons)]
    density_widths += [(n_neurons, n_neurons)] * (n_hidden - 1)
    density_widths += [(n_neurons, 16)]
    rgb_in = 32  # next_multiple(16 density out + 16 SH, 16)
    rgb_widths = [(rgb_in, rgb_neurons)]
    rgb_widths += [(rgb_neurons, rgb_neurons)] * (rgb_hidden - 1)
    rgb_widths += [(rgb_neurons, 16)]  # padded output; rgb = first 3
    return density_widths, rgb_widths


def export_reference_snapshot(path, network_config: dict, params,
                              aabb_scale: int = 1,
                              density_grid: Optional[np.ndarray] = None,
                              max_cascade: int = 0, training_step: int = 0,
                              loss: float = 0.0, rays_per_batch: int = 4096,
                              dataset_meta: Optional[dict] = None) -> None:
    """Write a tcnn-compatible ``params_binary`` snapshot that the CUDA
    reference (and our ``import_reference_snapshot``) can load.

    ``params`` must be a tcnn-layout pytree (NGP_GRID_IMPL=tcnn):
    {"pos_encoding": flat fp table, "density_net": (W...), "rgb_net": (W...)}.
    Buffer order matches NerfNetwork::set_params (ref: nerf_network.h:361-394):
    density MLP, rgb MLP, pos encoding, dir encoding (SH: no params).
    Matrices are stored (n_out, n_in) row-major with input widths padded to
    16 (tcnn ABI); ours are (n_in, n_out) for x·W — transposed on the way
    out, zero-padding the extra rows/cols tcnn allocates.
    """
    from ngp_jax.config import autofill_hashgrid_config
    from ngp_jax.kernels.hashgrid import HashGridMeta

    enc_cfg = autofill_hashgrid_config(dict(network_config["encoding"]), 3,
                                       2048.0, aabb_scale=aabb_scale)
    meta = HashGridMeta.from_config(enc_cfg)
    density_widths, rgb_widths = _tcnn_mlp_widths(network_config, meta)

    def emit_mlp(mats, widths):
        out = []
        for w, (n_in, n_out) in zip(mats, widths):
            w = np.asarray(w, np.float32)
            full = np.zeros((n_in, n_out), np.float32)
            full[: w.shape[0], : w.shape[1]] = w
            out.append(full.T.reshape(-1))   # (n_out, n_in) row-major
        return out

    chunks = []
    chunks += emit_mlp(params["density_net"], density_widths)
    chunks += emit_mlp(params["rgb_net"], rgb_widths)
    table = np.asarray(params["pos_encoding"], np.float32).reshape(-1)
    assert table.size == meta.n_params * meta.n_features_per_level, \
        f"table size {table.size} != tcnn layout {meta.n_params * meta.n_features_per_level}"
    chunks.append(table)
    flat = np.concatenate(chunks).astype(np.float16)

    snap = {
        "version": SNAPSHOT_FORMAT_VERSION,
        "n_params": int(flat.size),
        "params_type": "__half",
        "params_binary": flat.tobytes(),
        "density_grid_size": 128,
        "training_step": int(training_step),
        "loss": float(loss),
        "bounding_radius": float(aabb_scale) * (3.0 ** 0.5) / 2.0,
        "nerf": {
            "aabb_scale": int(aabb_scale),
            "rgb": {"rays_per_batch": int(rays_per_batch),
                    "measured_batch_size": 1 << 18,
                    "measured_batch_size_before_compaction": 1 << 18},
            "dataset": _pack_tree(dataset_meta or {}),
        },
    }
    if density_grid is not None:
        from ngp_jax.grid.occupancy import density_to_morton
        snap["density_grid_binary"] = density_to_morton(
            np.asarray(density_grid, np.float16)).tobytes()
    half = aabb_scale / 2.0
    snap["aabb"] = {"min": [0.5 - half] * 3, "max": [0.5 + half] * 3}
    doc = dict(network_config)
    doc["snapshot"] = snap
    Path(path).write_bytes(msgpack.packb(doc, use_bin_type=True))


def _tcnn_encoded_widths(network_cfg: dict, enc_out: int,
                         n_output_dims: int):
    """(n_in, n_out) sequence tcnn allocates for a NetworkWithInputEncoding
    MLP (ABI rules 4-5): encoding output padded to 16 feeds the first
    layer; the last layer's output pads to 16."""
    n = int(network_cfg.get("n_neurons", 64))
    hidden = int(network_cfg.get("n_hidden_layers", 1))
    in_pad = (enc_out + 15) // 16 * 16
    out_pad = max((n_output_dims + 15) // 16 * 16, 16)
    widths = [(in_pad, n)]
    widths += [(n, n)] * (hidden - 1)
    widths += [(n, out_pad)]
    return widths


def _encoded_meta(doc: dict, n_input_dims: int, desired_resolution: float):
    from ngp_jax.config import autofill_hashgrid_config
    from ngp_jax.kernels.hashgrid import HashGridMeta
    enc_cfg = autofill_hashgrid_config(dict(doc["encoding"]), n_input_dims,
                                       desired_resolution)
    return HashGridMeta.from_config(enc_cfg), enc_cfg


def export_reference_snapshot_encoded(
        path, network_config: dict, params, n_input_dims: int,
        n_output_dims: int, desired_resolution: float = 2048.0,
        training_step: int = 0, loss: float = 0.0,
        extra: Optional[dict] = None) -> None:
    """tcnn ``params_binary`` export for the NetworkWithInputEncoding
    primitives (sdf / image / volume Testbed modes): MLP first, then the
    hash table (ABI rule 3). ``params`` is the EncodedNetwork pytree
    {"encoding": flat tcnn-layout table, "net": (W, ...)}."""
    meta, _ = _encoded_meta(network_config, n_input_dims,
                            desired_resolution)
    widths = _tcnn_encoded_widths(network_config["network"],
                                  meta.n_output_dims, n_output_dims)
    chunks = []
    for w, (n_in, n_out) in zip(params["net"], widths):
        w = np.asarray(w, np.float32)
        full = np.zeros((n_in, n_out), np.float32)
        full[: w.shape[0], : w.shape[1]] = w
        chunks.append(full.T.reshape(-1))       # (n_out, n_in) row-major
    table = np.asarray(params["encoding"], np.float32).reshape(-1)
    expect = meta.n_params * meta.n_features_per_level
    assert table.size == expect, \
        f"table size {table.size} != tcnn layout {expect}"
    chunks.append(table)
    flat = np.concatenate(chunks).astype(np.float16)
    snap = {
        "version": SNAPSHOT_FORMAT_VERSION,
        "n_params": int(flat.size),
        "params_type": "__half",
        "params_binary": flat.tobytes(),
        "training_step": int(training_step),
        "loss": float(loss),
    }
    if extra:
        snap.update(_pack_tree(extra))
    doc = dict(network_config)
    doc["snapshot"] = snap
    Path(path).write_bytes(msgpack.packb(doc, use_bin_type=True))


def import_reference_snapshot_encoded(path, n_input_dims: int,
                                      n_output_dims: int,
                                      desired_resolution: float = 2048.0):
    """Import a tcnn NetworkWithInputEncoding snapshot (the reference's
    sdf/image/volume modes). Returns (network_config, params, snapshot)
    where params matches EncodedNetwork with NGP_GRID_IMPL=tcnn."""
    doc = msgpack.unpackb(Path(path).read_bytes(), raw=False,
                          strict_map_key=False)
    snap = doc["snapshot"]
    raw = snap.get("params_binary")
    if raw is None:
        raise ValueError("no params_binary — not a reference snapshot")
    flat = np.frombuffer(raw, np.float16).astype(np.float32)
    meta, enc_cfg = _encoded_meta(doc, n_input_dims, desired_resolution)
    widths = _tcnn_encoded_widths(doc["network"], meta.n_output_dims,
                                  n_output_dims)
    off = 0
    mats = []
    for n_in, n_out in widths:
        n = n_in * n_out
        mats.append(flat[off: off + n].reshape(n_out, n_in).T.copy())
        off += n
    n_table = meta.n_params * meta.n_features_per_level
    table = flat[off: off + n_table].copy()
    off += n_table
    # trim the tcnn padding back to our exact shapes
    mats[0] = mats[0][: meta.n_output_dims]
    mats[-1] = mats[-1][:, :n_output_dims]
    cfg = {k: v for k, v in doc.items() if k != "snapshot"}
    params = {"encoding": table, "net": tuple(mats)}
    return cfg, params, snap


# --------------------------------------------------------------------------
# Reference (tiny-cuda-nn) snapshot import
# --------------------------------------------------------------------------

def import_reference_snapshot(path):
    """Import a CUDA-reference snapshot msgpack (tcnn Trainer::serialize).

    Layout assumptions (tcnn ABI, cross-checked against usage in
    nerf_network.h set_params order: density MLP, rgb MLP, pos encoding,
    dir encoding):
    - ``snapshot.params_binary``: fp16 buffer of all trainable params.
    - MLP layers store (n_out, n_in) row-major matrices, input widths
      padded to 16; our MLP multiplies x·W so matrices are transposed.
    - HashGrid params: levels concatenated, F features interleaved per
      entry — identical to our tcnn-layout flat table.

    Returns (network_config, params_pytree, snapshot_dict) where the
    pytree matches NGP_GRID_IMPL=tcnn models. Experimental: validated
    structurally (shape accounting) — no CUDA-produced snapshot ships in
    this environment to test against byte-for-byte.
    """
    import math

    doc = msgpack.unpackb(Path(path).read_bytes(), raw=False,
                          strict_map_key=False)
    snap = doc["snapshot"]
    raw = snap.get("params_binary")
    if raw is None:
        raise ValueError("no params_binary — not a reference snapshot")
    params = np.frombuffer(raw, np.float16).astype(np.float32)

    from ngp_jax.config import autofill_hashgrid_config
    from ngp_jax.kernels.hashgrid import HashGridMeta
    aabb_scale = int(snap.get("nerf", {}).get("aabb_scale", 1))
    enc_cfg = autofill_hashgrid_config(doc["encoding"], 3, 2048.0,
                                       aabb_scale=aabb_scale)
    meta = HashGridMeta.from_config(enc_cfg)

    def take_mlp(off, widths):
        mats = []
        for n_in, n_out in widths:
            n = n_in * n_out
            w = params[off: off + n].reshape(n_out, n_in).T.copy()
            mats.append(w)
            off += n
        return tuple(mats), off

    density_widths, rgb_widths = _tcnn_mlp_widths(doc, meta)

    off = 0
    density_net, off = take_mlp(off, density_widths)
    rgb_net, off = take_mlp(off, rgb_widths)
    n_table = meta.n_params * meta.n_features_per_level
    table = params[off: off + n_table].copy()
    off += n_table

    # trim padded widths down to our exact shapes
    density_net = (density_net[0][: meta.n_output_dims],) + density_net[1:]
    rgb_net = rgb_net[:-1] + (rgb_net[-1][:, :3],)

    # build the model to get the exact pytree structure (dir encodings are
    # parameterless but structured, e.g. Composite → tuple of parts)
    import os
    cfg = {k: v for k, v in doc.items() if k != "snapshot"}
    prev = os.environ.get("NGP_GRID_IMPL")
    os.environ["NGP_GRID_IMPL"] = "tcnn"
    try:
        import jax
        from ngp_jax.nn.models import NerfNetwork
        cfg_built = dict(cfg)
        cfg_built["encoding"] = enc_cfg
        model = NerfNetwork(cfg_built)
        skeleton = model.init_params(jax.random.PRNGKey(0))
    finally:
        if prev is None:
            os.environ.pop("NGP_GRID_IMPL", None)
        else:
            os.environ["NGP_GRID_IMPL"] = prev
    out_params = dict(skeleton)
    out_params["pos_encoding"] = table
    out_params["density_net"] = density_net
    out_params["rgb_net"] = rgb_net
    return cfg, out_params, snap
