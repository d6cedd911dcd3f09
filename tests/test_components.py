"""Breadth tests: camera path, mesh export, volume, multi-NeRF data model,
Testbed facade, samplers, render buffer."""
import json

import numpy as np
import pytest


def test_camera_path_spline_and_json(tmp_path):
    from ngp_jax.io.camera_path import CameraKeyframe, CameraPath
    kfs = []
    for i in range(4):
        m = np.eye(4, dtype=np.float32)[:3]
        m[:, 3] = [i, 0, 0]
        kfs.append(CameraKeyframe.from_matrix(m, fov=50 + i))
    path = CameraPath(kfs, duration_seconds=2.0)
    mid = path.eval(0.5)
    assert 0.0 < mid.T[0] < 3.0
    # endpoints approach first/last keyframes (B-spline doesn't interpolate
    # exactly, but must stay within the hull)
    p = tmp_path / "path.json"
    path.save(p)
    loaded = CameraPath.load(p)
    assert len(loaded.keyframes) == 4
    np.testing.assert_allclose(loaded.keyframes[2].T, kfs[2].T)
    assert loaded.keyframes[1].fov == 51


def test_camera_path_legacy_dof_key(tmp_path):
    from ngp_jax.io.camera_path import CameraPath
    doc = {"time": 1.0, "path": [{"R": [0, 0, 0, 1], "T": [0, 0, 0],
                                  "dof": 0.25, "fov": 40}]}
    p = tmp_path / "legacy.json"
    p.write_text(json.dumps(doc))
    path = CameraPath.load(p)
    assert path.keyframes[0].aperture_size == 0.25


def test_quat_roundtrip():
    from ngp_jax.io.camera_path import quat_to_rotmat, rotmat_to_quat
    rng = np.random.default_rng(3)
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        m = quat_to_rotmat(q.astype(np.float32))
        q2 = rotmat_to_quat(m)
        assert min(np.linalg.norm(q2 - q), np.linalg.norm(q2 + q)) < 1e-5


def test_marching_tetrahedra_plane():
    from ngp_jax.render.mesh_export import marching_tetrahedra
    res = 16
    lin = np.linspace(0, 1, res, dtype=np.float32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    field = g[..., 0] - 0.5  # plane x = 0.5
    v, f = marching_tetrahedra(field, 0.0)
    assert len(f) > 0
    np.testing.assert_allclose(v[:, 0], 0.5, atol=1e-5)


def test_volume_grid_mapping():
    from ngp_jax.data.nanovdb import VolumeGrid
    dense = np.zeros((64, 32, 16), np.float32)
    dense[32, 16, 8] = 2.0
    g = VolumeGrid(dense)
    assert g.world2index_scale == 64
    assert g.global_majorant == 2.0
    # aabb is centered and proportional
    np.testing.assert_allclose(g.aabb_max - g.aabb_min,
                               [1.0, 0.5, 0.25])


def test_nvdb_header_roundtrip(tmp_path):
    """Write a header per the reference's POD layout and parse it back."""
    import struct
    from ngp_jax.data.nanovdb import NANOVDB_MAGIC, read_header
    header = struct.pack("<QIHH", NANOVDB_MAGIC, 32 << 21, 1, 0)
    meta = struct.pack("<QQQQII", 1000, 2000, 0, 123, 0, 1)
    meta += np.zeros(6, np.float64).tobytes()
    meta += np.asarray([0, 0, 0, 8, 8, 8], np.int32).tobytes()
    meta += np.ones(3, np.float64).tobytes()
    meta += struct.pack("<I", 5)
    meta += struct.pack("<4I", 0, 0, 0, 0) + struct.pack("<3I", 0, 0, 0)
    meta += struct.pack("<HHI", 0, 0, 0)
    raw = header + meta + b"smok\0"
    m, off = read_header(raw)
    assert m.grid_size == 1000 and m.voxel_count == 123
    assert m.name == "smok"
    assert (m.index_bbox[1] == 8).all()


def test_mask3d_shapes():
    import jax.numpy as jnp
    from ngp_jax.render.multi_nerf import Mask3D, apply_masks
    sphere = Mask3D(shape="sphere", radius=0.5, feather=0.1)
    pts = jnp.asarray([[0.0, 0, 0], [0.6, 0, 0], [2.0, 0, 0]])
    a = np.asarray(sphere.sample(pts))
    assert a[0] == 1.0 and a[2] == 0.0
    # subtract mask carves out of an "all" base
    sub = Mask3D(shape="box", mode="subtract", dims=np.ones(3) * 2,
                 feather=0.01)
    merged = np.asarray(apply_masks([Mask3D.All("add"), sub], pts))
    assert merged[0] == 0.0  # carved out near origin


def test_render_request_dataclasses():
    from ngp_jax.render.multi_nerf import (DownsampleInfo, NerfDescriptor,
                                           RenderCameraProperties,
                                           RenderOutputProperties,
                                           RenderRequest)
    r = RenderRequest(
        output=RenderOutputProperties(width=64, height=48,
                                      downsample=DownsampleInfo.MakeFromMip(1)),
        camera=RenderCameraProperties(),
        nerfs=[NerfDescriptor(snapshot_path="x.msgpack")])
    assert r.output.downsample.scale == 2


def test_testbed_image_mode(tmp_path):
    from ngp_jax.api.testbed import Testbed, mode_from_scene
    from ngp_jax.common import TestbedMode
    from ngp_jax.data.image_io import save_exr
    img = np.random.rand(64, 64, 4).astype(np.float32)
    p = tmp_path / "t.exr"
    save_exr(p, img, dtype=np.float32)
    assert mode_from_scene(p) == TestbedMode.IMAGE
    tb = Testbed(TestbedMode.IMAGE)
    tb.training_batch_size = 1 << 12
    tb.load_training_data(p)
    tb.train(5)
    out = tb.render(32, 32)
    assert out.shape == (32, 32, 4)
    assert tb.n_params() > 0


def test_tonemap_curves():
    import jax.numpy as jnp
    from ngp_jax.common import TonemapCurve
    from ngp_jax.render.buffer import tonemap
    x = jnp.asarray([0.0, 0.5, 4.0])
    for c in TonemapCurve:
        y = np.asarray(tonemap(x, c))
        assert y[0] <= y[1] <= y[2] or c == TonemapCurve.IDENTITY
        if c != TonemapCurve.IDENTITY:
            assert y[2] <= 1.0 + 1e-6
