"""SDF engine: BVH correctness on analytic shapes, trainer smoke, IoU."""
import numpy as np
import pytest

from ngp_jax.data.mesh import TriangleBvh, load_mesh, load_obj


def make_cube_mesh():
    """Unit cube [0.25, 0.75]^3 as 12 triangles."""
    lo, hi = 0.25, 0.75
    v = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)], np.float32)
    # faces with outward winding (winding irrelevant for raystab)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    f = []
    for a, b, c, d in quads:
        f += [[a, b, c], [a, c, d]]
    return v, np.asarray(f, np.int32)


def test_bvh_signed_distance_cube():
    v, f = make_cube_mesh()
    bvh = TriangleBvh(v, f)
    pts = np.array([[0.5, 0.5, 0.5],     # center: inside, dist 0.25
                    [0.5, 0.5, 0.9],     # outside, dist 0.15
                    [0.1, 0.5, 0.5]],    # outside, dist 0.15
                   np.float32)
    d = bvh.signed_distance(pts, mode=TriangleBvh.MODE_RAYSTAB)
    np.testing.assert_allclose(d, [-0.25, 0.15, 0.15], atol=1e-5)


def test_bvh_raytrace_cube():
    v, f = make_cube_mesh()
    bvh = TriangleBvh(v, f)
    o = np.array([[0.5, 0.5, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t, tri, n = bvh.raytrace(o, d)
    np.testing.assert_allclose(t[0], 0.25, atol=1e-5)
    assert tri[0] >= 0


def test_surface_sampling_on_surface():
    v, f = make_cube_mesh()
    bvh = TriangleBvh(v, f)
    s = bvh.sample_surface(1000, np.random.default_rng(0))
    d = np.abs(bvh.signed_distance(s, mode=TriangleBvh.MODE_WATERTIGHT))
    assert d.max() < 1e-5


def test_mesh_normalization():
    v, f, scale, off = load_mesh("/root/reference/data/sdf/bunny.obj")
    assert v.min() >= 0.0 and v.max() <= 1.0
    assert (v.max(0) - v.min(0)).max() < 1.0


@pytest.mark.smoke
def test_sdf_trainer_learns_cube(tmp_path):
    import jax
    from ngp_jax.config import load_network_config
    from ngp_jax.train.sdf import SdfTrainer
    v, f = make_cube_mesh()
    # write a tiny obj
    p = tmp_path / "cube.obj"
    with open(p, "w") as fh:
        for vv in v:
            fh.write("v %f %f %f\n" % tuple(vv))
        for ff in f:
            fh.write("f %d %d %d\n" % tuple(ff + 1))
    cfg = load_network_config("configs/sdf/base.json")
    cfg["encoding"]["n_levels"] = 6
    cfg["encoding"]["log2_hashmap_size"] = 14
    cfg["optimizer"]["nested"]["nested"]["learning_rate"] = 1e-3
    tr = SdfTrainer(p, cfg, batch_size=1 << 12)
    tr.train(120)
    iou = tr.calculate_iou(n_samples=1 << 15)
    assert iou > 0.5, iou


def test_pathescape_sign_matches_watertight_on_cube():
    """PathEscape (mode 2, ref: src/optix/pathescape.cu): random-walk
    escape voting must agree with the pseudonormal test on a closed cube."""
    import numpy as np
    from ngp_jax.data.mesh import TriangleBvh

    v, f = make_cube_mesh()
    bvh = TriangleBvh(v, f)
    pts = np.array([[0.5, 0.5, 0.5],      # inside
                    [0.6, 0.4, 0.5],      # inside
                    [0.9, 0.9, 0.9],      # outside (near corner)
                    [0.1, 0.5, 0.5]],     # outside
                   np.float32)
    d_w = bvh.signed_distance(pts, mode=TriangleBvh.MODE_WATERTIGHT)
    d_p = bvh.signed_distance(pts, mode=TriangleBvh.MODE_PATHESCAPE)
    assert np.all(np.sign(d_w) == np.sign(d_p)), (d_w, d_p)
    np.testing.assert_allclose(np.abs(d_w), np.abs(d_p), rtol=1e-5)


def test_octree_uniform_sampling(tmp_path):
    """Octree-uniform branch (ref: uniform_octree_sample_kernel,
    testbed_sdf.cu:1118-1143): the 1/8 uniform samples must land inside
    dilated surface leaves, not the whole AABB."""
    import numpy as np
    from ngp_jax.train.sdf import SdfTrainer

    v, f = make_cube_mesh()
    mesh = tmp_path / "cube.obj"
    with open(mesh, "w") as fh:
        for vv in v:
            fh.write("v %f %f %f\n" % tuple(vv))
        for ff in f:
            fh.write("f %d %d %d\n" % tuple(ff + 1))
    cfg = {
        "loss": {"otype": "MAPE"},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-3},
        "encoding": {"otype": "HashGrid", "n_levels": 4,
                     "log2_hashmap_size": 12, "base_resolution": 16},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 32,
                    "n_hidden_layers": 1},
    }
    tr = SdfTrainer(mesh, cfg, batch_size=2048, use_octree_uniform=True,
                    octree_depth=5)
    pos, dist = tr.generate_training_batch()
    assert np.isfinite(dist).all()
    # every generated point lies within ~2 leaf sizes of the surface
    # (surface/perturbed by construction; uniform via occupied leaves)
    d = np.abs(tr.bvh.signed_distance(pos.astype(np.float32),
                                      mode=tr.sign_mode))
    leaf = 2.0 ** (1 - 5)
    assert float(np.quantile(d, 0.99)) < 4 * leaf, float(d.max())


def test_takikawa_trains_and_iou_uses_octree_semantics(tmp_path):
    """Takikawa (octree-masked) encoding: features exist only in the
    surface band, so IoU must count outside-octree samples as correct
    (ref: compare_signs_kernel, src/testbed_sdf.cu:464-466 — 'assume,
    when using the octree, that the model is always correct outside').
    Round-4 CPU A/B on armadillo: base 0.9896 vs takikawa 0.9987 @400."""
    import numpy as np
    from ngp_jax.config import load_network_config
    from ngp_jax.train.sdf import SdfTrainer
    v, f = make_cube_mesh()
    p = tmp_path / "cube.obj"
    with open(p, "w") as fh:
        for vv in v:
            fh.write("v %f %f %f\n" % tuple(vv))
        for ff in f:
            fh.write("f %d %d %d\n" % tuple(ff + 1))
    cfg = load_network_config("configs/sdf/takikawa.json")
    cfg["encoding"]["n_levels"] = 6        # depth 6 keeps the test tiny
    cfg["optimizer"]["nested"]["nested"]["learning_rate"] = 1e-3
    tr = SdfTrainer(p, cfg, batch_size=1 << 12)
    assert tr.tak_encoding is not None
    # contains(): true on the surface itself, false deep inside the
    # solid (the center is half an edge from any face — far outside the
    # ±1-cell surface band at depth 6)
    surf = tr.bvh.sample_surface(64, np.random.default_rng(0))
    assert np.asarray(tr.tak_encoding.contains(surf)).all()
    center = tr.vertices.mean(0, keepdims=True).astype(np.float32)
    assert not np.asarray(tr.tak_encoding.contains(center)).any()
    tr.train(120)
    iou = tr.calculate_iou(n_samples=1 << 15)
    assert iou > 0.5, iou
