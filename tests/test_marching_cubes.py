"""Marching cubes (self-derived case tables) — watertightness, topology,
triangle economy vs marching tetrahedra."""
import numpy as np


def _sphere_field(n=32, r=0.35):
    lin = np.linspace(0.0, 1.0, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2) - r


def _edge_counts(faces):
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], 0)
    e = np.sort(e, axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    return counts


def test_mc_sphere_watertight_and_accurate():
    from ngp_jax.render.mesh_export import marching_cubes

    field = _sphere_field()
    verts, faces = marching_cubes(field, 0.0)
    assert len(faces) > 100
    # watertight: every edge shared by exactly two triangles
    assert (_edge_counts(faces) == 2).all()
    # genus 0: V - E + F == 2
    E = len(faces) * 3 // 2
    assert len(verts) - E + len(faces) == 2
    # vertices lie on the isosurface
    r = np.linalg.norm(verts - 0.5, axis=1)
    assert float(np.abs(r - 0.35).max()) < 0.01


def test_mc_consistent_orientation():
    """All face normals point the same way relative to the inside region
    (outward for inside = field < threshold)."""
    from ngp_jax.render.mesh_export import marching_cubes

    field = _sphere_field()
    verts, faces = marching_cubes(field, 0.0)
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    fn /= np.linalg.norm(fn, axis=1, keepdims=True) + 1e-12
    centers = verts[faces].mean(1) - 0.5
    centers /= np.linalg.norm(centers, axis=1, keepdims=True) + 1e-12
    dots = (fn * centers).sum(1)
    # consistently oriented (all outward or all inward — then fixed
    # convention below)
    assert (dots > 0.5).all() or (dots < -0.5).all()
    # convention: outward normals around the inside region
    assert (dots > 0.5).all()


def test_mc_watertight_on_random_field():
    """Ambiguous-face cases must still close up across cell boundaries
    (the fixed per-face pairing rule is applied identically from both
    sides of every shared face)."""
    from ngp_jax.render.mesh_export import marching_cubes

    rng = np.random.RandomState(11)
    field = rng.randn(14, 14, 14).astype(np.float32)
    # smooth slightly so the surface is not pure noise, keep ambiguities
    for ax in range(3):
        field = (field + np.roll(field, 1, ax)) / 2
    # close the field at the domain boundary (surfaces exiting the grid
    # would otherwise legitimately leave open edges)
    field[[0, -1], :, :] = 10.0
    field[:, [0, -1], :] = 10.0
    field[:, :, [0, -1]] = 10.0
    verts, faces = marching_cubes(field, 0.0)
    assert len(faces) > 0
    assert (_edge_counts(faces) == 2).all()


def test_mc_triangle_economy_vs_tets():
    from ngp_jax.render.mesh_export import (marching_cubes,
                                            marching_tetrahedra)

    field = _sphere_field(24)
    _, f_mc = marching_cubes(field, 0.0)
    _, f_tet = marching_tetrahedra(field, 0.0)
    assert len(f_mc) < 0.65 * len(f_tet)


def test_extract_mesh_defaults_to_mc():
    from ngp_jax.render.mesh_export import extract_mesh_from_density

    def density_fn(pos):
        d = np.linalg.norm(np.asarray(pos) - 0.5, axis=-1)
        return np.where(d < 0.3, 10.0, 0.0).astype(np.float32)

    verts, faces = extract_mesh_from_density(density_fn, res=24,
                                             threshold=2.5,
                                             smooth_iters=0)
    assert len(faces) > 50
    assert (_edge_counts(faces) == 2).all()
    r = np.linalg.norm(verts - 0.5, axis=1)
    assert float(np.abs(r - 0.3).max()) < 0.06
