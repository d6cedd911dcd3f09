"""Playback cache (frozen-model voxel distillation + slice compositing).

The brute-force reference replicates the playback sampling semantics
per screen pixel exactly (same slab planes, bilinear in-plane taps,
front/back nested-cascade split) — the renderer must agree up to its
ray-grid interpolation error.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from ngp_jax.render.playback import (PlaybackCache, PlaybackOptions,
                                     PlaybackRenderer, _PERMS,
                                     _cascade_lattice)


def _smooth_cache(n_casc=1, D=32, seed=0):
    """Smooth random volumes (band-limited so interpolation differences
    stay small): gaussian density blobs + slowly-varying color."""
    rng = np.random.RandomState(seed)
    vols, sides = [], []
    for c in range(n_casc):
        side = 2.0 ** c
        ax = _cascade_lattice(D, side)
        X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")  # world x,y,z
        sigma = np.zeros((D, D, D), np.float32)
        for _ in range(3):
            ctr = 0.5 + (rng.rand(3) - 0.5) * side * 0.5
            w = side * (0.15 + 0.1 * rng.rand())
            sigma += 8.0 / side * np.exp(
                -((X - ctr[0]) ** 2 + (Y - ctr[1]) ** 2
                  + (Z - ctr[2]) ** 2) / (2 * w * w))
        rgb = np.stack([0.5 + 0.4 * np.sin(3 * X / side),
                        0.5 + 0.4 * np.cos(2 * Y / side),
                        0.5 + 0.4 * np.sin(4 * Z / side)], -1)
        if c > 0:
            inner = np.abs(ax - 0.5) < side / 4 - 1e-9
            own = ~(inner[:, None, None] & inner[None, :, None]
                    & inner[None, None, :])
            sigma *= own
        # storage is (worldZ, worldY, worldX, ch), sigma-premultiplied
        vol = np.concatenate([rgb * sigma[..., None], sigma[..., None]],
                             -1).transpose(2, 1, 0, 3)
        vols.append(jnp.asarray(vol, jnp.float32))
        sides.append(side)
    return PlaybackCache(vols=tuple(vols), sides=tuple(sides))


def _lookat_xform(eye, target=(0.5, 0.5, 0.5)):
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    up0 = np.float32([0, 0, 1]) if abs(fwd[2]) < 0.9 else \
        np.float32([0, 1, 0])
    right = np.cross(fwd, up0)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], 1).astype(np.float32)


def _brute_force(cache, xform, W, H, fx, fy, bg=(0, 0, 0),
                 t_near=0.05, min_dz=0.05):
    """Per-pixel exact reference of the playback sampling semantics."""
    xf = np.asarray(xform, np.float32)
    e_w = xf[:, 3]
    px = (np.arange(W, dtype=np.float32) + 0.5) / W
    py = (np.arange(H, dtype=np.float32) + 0.5) / H
    u, v = np.meshgrid(px, py)
    d_cam = np.stack([(u - 0.5) * W / fx, (v - 0.5) * H / fy,
                      np.ones_like(u)], -1).reshape(-1, 3)
    d_w = d_cam @ xf[:, :3].T
    d_w /= np.linalg.norm(d_w, axis=-1, keepdims=True)

    fwd = xf[:, 2]
    axis = int(np.argmax(np.abs(fwd)))
    perm = _PERMS[axis]
    flip = bool(fwd[axis] < 0)
    e = e_w[list(perm)].copy()
    d = d_w[:, list(perm)].copy()
    if flip:
        e[2] = 1.0 - e[2]
        d[:, 2] = -d[:, 2]
    N = d.shape[0]
    dz_ok = d[:, 2] > min_dz

    # inner-cube entry/exit per pixel per cascade boundary
    def cube_t(side):
        lo, hi = 0.5 - side / 2, 0.5 + side / 2
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (np.float32([lo, lo, lo]) - e) / d
            t1 = (np.float32([hi, hi, hi]) - e) / d
        tin = np.minimum(t0, t1).max(-1)
        tout = np.maximum(t0, t1).min(-1)
        miss = tin > tout
        return (np.where(miss, np.inf, tin),
                np.where(miss, np.inf, tout))

    ts, ods, rgbs = [], [], []
    for ci, volj in enumerate(cache.vols):
        vol = np.asarray(volj, np.float32)       # (z', y', x', 4) ...
        # test volumes are stored in world order; permute + flip here
        t = (2 - perm[2], 2 - perm[1], 2 - perm[0], 3)
        vol = vol.transpose(t)
        if flip:
            vol = vol[::-1]
        D = vol.shape[0]
        side = cache.sides[ci]
        vox = side / D
        lo = 0.5 - side / 2
        zs = _cascade_lattice(D, side)
        if ci > 0:
            t_in, t_out = cube_t(cache.sides[ci - 1])
        else:
            t_in = np.full(N, np.inf)
            t_out = np.full(N, np.inf)
        for k in range(D):
            with np.errstate(divide="ignore"):
                t_k = (zs[k] - e[2]) / np.where(dz_ok, d[:, 2], 1.0)
            pos = e[None] + t_k[:, None] * d                 # (N, 3)
            ux = (pos[:, 0] - lo) / vox - 0.5
            uy = (pos[:, 1] - lo) / vox - 0.5
            # bilinear with zero padding
            x0 = np.floor(ux).astype(int)
            y0 = np.floor(uy).astype(int)
            smp = np.zeros((N, 4), np.float32)
            for dx_ in (0, 1):
                for dy_ in (0, 1):
                    xi, yi = x0 + dx_, y0 + dy_
                    wgt = np.clip(1 - np.abs(ux - xi), 0, 1) * \
                        np.clip(1 - np.abs(uy - yi), 0, 1)
                    ok = (xi >= 0) & (xi < D) & (yi >= 0) & (yi < D)
                    xi_, yi_ = np.clip(xi, 0, D - 1), np.clip(yi, 0, D - 1)
                    smp += np.where(ok, wgt, 0.0)[:, None] \
                        * vol[k, yi_, xi_]
            sig = np.maximum(smp[:, 3], 0.0)
            dt = vox / np.where(dz_ok, d[:, 2], 1.0)
            od = sig * dt
            live = dz_ok & (t_k > t_near) & \
                ((t_k < t_in) | (t_k > t_out))
            ods.append(np.where(live, od, 0.0))
            rgbs.append(smp[:, :3] / np.maximum(sig, 1e-9)[:, None])
            ts.append(np.where(live, t_k, np.inf))
    ts = np.stack(ts, 1)                                    # (N, S)
    ods = np.stack(ods, 1)
    rgbs = np.stack(rgbs, 1)
    order = np.argsort(ts, axis=1, kind="stable")
    ods = np.take_along_axis(ods, order, 1)
    rgbs = np.take_along_axis(rgbs, order[..., None], 1)
    excl = np.cumsum(ods, 1) - ods
    w = np.exp(-excl) * (1 - np.exp(-ods))
    rgb = (w[..., None] * rgbs).sum(1)
    T = np.exp(-ods.sum(1))
    rgb = rgb + T[:, None] * np.asarray(bg, np.float32)[None]
    return np.concatenate([rgb, (1 - T)[:, None]],
                          -1).reshape(H, W, 4)


@pytest.mark.parametrize("eye", [(0.5, 0.5, -1.2), (1.9, 0.55, 0.45),
                                 (0.45, -1.1, 0.62)])
def test_playback_matches_brute_force_single_cascade(eye):
    cache = _smooth_cache(n_casc=1, D=32)
    xf = _lookat_xform(eye)
    W = H = 40
    fx = fy = 44.0
    r = PlaybackRenderer(cache, PlaybackOptions(
        width=W, height=H, int_scale=2.0, zb=8, linear_out=False))
    img = r.render(xf, W, H, focal=(fx, fy))
    ref = _brute_force(cache, xf, W, H, fx, fy)
    assert np.isfinite(img).all()
    assert float(np.abs(img - ref).mean()) < 5e-3
    assert float(np.abs(img - ref).max()) < 6e-2


def test_playback_matches_brute_force_nested_cascades():
    cache = _smooth_cache(n_casc=2, D=32, seed=3)
    xf = _lookat_xform((0.5, 0.52, -1.6))
    W = H = 40
    fx = fy = 36.0
    r = PlaybackRenderer(cache, PlaybackOptions(
        width=W, height=H, int_scale=2.0, outer_int_scale=2.0, zb=8,
        linear_out=False))
    img = r.render(xf, W, H, focal=(fx, fy))
    ref = _brute_force(cache, xf, W, H, fx, fy)
    assert np.isfinite(img).all()
    assert float(np.abs(img - ref).mean()) < 6e-3
    assert float(np.abs(img - ref).max()) < 8e-2


def test_playback_axis_symmetry():
    """A spherically-symmetric blob rendered from the six axis-aligned
    directions gives (nearly) the same image — covers every permute and
    flip branch."""
    D = 32
    ax = _cascade_lattice(D, 1.0)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sigma = 14.0 * np.exp(-((X - 0.5) ** 2 + (Y - 0.5) ** 2
                            + (Z - 0.5) ** 2) / 0.02).astype(np.float32)
    vol = np.concatenate([0.7 * sigma[..., None],
                          0.3 * sigma[..., None],
                          0.5 * sigma[..., None],
                          sigma[..., None]], -1).transpose(2, 1, 0, 3)
    cache = PlaybackCache(vols=(jnp.asarray(vol),), sides=(1.0,))
    W = H = 32
    imgs = []
    for axis_ in range(3):
        for s in (+1, -1):
            eye = np.float32([0.5, 0.5, 0.5])
            eye[axis_] -= 1.5 * s
            r = PlaybackRenderer(cache, PlaybackOptions(
                width=W, height=H, int_scale=2.0, linear_out=False))
            imgs.append(r.render(_lookat_xform(eye), W, H,
                                 focal=(40.0, 40.0)))
    for im in imgs[1:]:
        assert float(np.abs(im - imgs[0]).mean()) < 6e-3


def test_bake_and_roundtrip(tmp_path):
    """bake_playback_cache runs on a real trainer, respects occupancy
    masking, and caches round-trip through save/load."""
    from synthetic import make_orbit_dataset
    from ngp_jax.config import load_network_config
    from ngp_jax.grid import occupancy as occ
    from ngp_jax.render.playback import (bake_playback_cache,
                                         load_playback_cache,
                                         save_playback_cache)
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    ds = make_orbit_dataset(n_images=2, res=16, aabb_scale=2)
    cfg = load_network_config("configs/nerf/base.json")
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=64, march_steps=32, target_batch_size=1 << 10))
    # occupancy: a single occupied block in cascade 0
    dens = np.zeros(tr.grid.density.shape, np.float32)
    dens[:occ.GRID_VOLUME] = 1.0
    grid = occ.rebuild_bitfield(
        tr.grid._replace(density=jnp.asarray(dens)), tr.max_cascade)
    tr.grid = grid
    cache = bake_playback_cache(tr, D=16)
    assert len(cache.vols) == tr.max_cascade + 1
    v0 = np.asarray(cache.vols[0], np.float32)
    v1 = np.asarray(cache.vols[1], np.float32)
    assert (v0[..., 3] > 0).any()          # cascade 0 fully occupied
    # cascade 1's own cells are empty; only the mip-pooled bits over the
    # cascade-0 region may carry values (kept for seam-correct taps)
    D1 = v1.shape[0]
    q = (np.arange(D1) + 0.5) / D1
    outer = np.abs(q - 0.5) >= 0.25
    m = outer[:, None, None] | outer[None, :, None] | outer[None, None, :]
    assert not (v1[..., 3][m] != 0).any()
    # render a frame end to end
    r = PlaybackRenderer(cache, PlaybackOptions(width=16, height=16))
    img = r.render(ds.xforms[0], 16, 16, focal=(20.0, 20.0))
    assert np.isfinite(img).all()
    path = str(tmp_path / "cache.npz")
    save_playback_cache(path, cache)
    c2 = load_playback_cache(path)
    assert len(c2.vols) == len(cache.vols)
    np.testing.assert_allclose(
        np.asarray(c2.vols[0], np.float32), v0, atol=1e-2)


class _AnalyticModel:
    """Fake NerfNetwork with an analytic field: rgb depends on position,
    sigma is a soft box — catches bake-storage/render-axis inconsistency
    end to end (the brute force samples the BAKED volume, so any axis
    mismatch between bake and render shows up as misregistration)."""

    def rgb_sigma(self, params, pos01, dir01, extra=None):
        import jax.numpy as jnp
        p = pos01
        rgb = jnp.stack([p[:, 0], p[:, 1], p[:, 2]], -1)
        inside = ((p > 0.30) & (p < 0.55)).all(-1)
        # asymmetric second blob along x only (breaks axis symmetry)
        blob = ((p[:, 0] > 0.6) & (p[:, 0] < 0.8)
                & (abs(p[:, 1] - 0.45) < 0.1)
                & (abs(p[:, 2] - 0.5) < 0.08))
        sigma = 25.0 * inside + 40.0 * blob
        return rgb, sigma


def test_bake_geometry_matches_brute_force():
    """bake_playback_cache + PlaybackRenderer on an analytic model ==
    brute-force sampling of the same baked volumes, for an eye OUTSIDE
    and an eye INSIDE the scene (fox cameras sit inside cascade 0)."""
    import types

    import jax.numpy as jnp
    from ngp_jax.grid import occupancy as occ
    from ngp_jax.render.playback import bake_playback_cache

    tr = types.SimpleNamespace()
    tr.model = _AnalyticModel()
    tr.max_cascade = 0
    tr.aabb_min = np.float32(0.0)
    tr.aabb_size = np.float32(1.0)
    tr.params = {}
    tr.opt_state = None
    tr.opt_cfg = None
    tr.dataset = types.SimpleNamespace(
        xforms=np.eye(4, dtype=np.float32)[None, :3])
    tr.grid = types.SimpleNamespace(
        bitfield=np.full((occ.NERF_CASCADES * occ.GRID_VOLUME // 8,),
                         255, np.uint8))
    cache = bake_playback_cache(tr, D=48, params={},
                                ref_eye=np.float32([0.5, 0.5, -1.0]))
    assert (np.asarray(cache.vols[0], np.float32)[..., 3] > 0).any()

    W = H = 40
    for eye in [(0.5, 0.45, -1.3), (0.42, 0.52, 0.47)]:
        xf = _lookat_xform(eye, target=(0.55, 0.5, 0.5))
        r = PlaybackRenderer(cache, PlaybackOptions(
            width=W, height=H, int_scale=2.0, linear_out=False))
        img = r.render(xf, W, H, focal=(44.0, 44.0))
        ref = _brute_force(cache, xf, W, H, 44.0, 44.0)
        assert np.isfinite(img).all()
        err = float(np.abs(img - ref).mean())
        assert err < 8e-3, (eye, err)


def test_bake_geometry_multicascade():
    """Same end-to-end check with max_cascade=1 (content in both
    cascades, aabb_scale=2 world mapping like fox-class scenes)."""
    import types

    from ngp_jax.grid import occupancy as occ
    from ngp_jax.render.playback import bake_playback_cache

    class _M:
        def rgb_sigma(self, params, pos01, dir01, extra=None):
            import jax.numpy as jnp
            # pos01 normalized by aabb [-0.5, 1.5] (scale 2): recover
            # world pos
            p = pos01 * 2.0 - 0.5
            rgb = jnp.stack([0.2 + 0.6 * p[:, 0] / 2.0,
                             jnp.full_like(p[:, 0], 0.5),
                             0.8 - 0.3 * p[:, 2] / 2.0], -1)
            inner = (abs(p - 0.5) < 0.22).all(-1)
            shell = ((abs(p - 0.5) < 0.9).all(-1)
                     & (abs(p[:, 0] - 0.5) > 0.6))
            sigma = 30.0 * inner + 12.0 * shell
            return jnp.clip(rgb, 0, 1), sigma

    tr = types.SimpleNamespace()
    tr.model = _M()
    tr.max_cascade = 1
    tr.aabb_min = np.float32(-0.5)
    tr.aabb_size = np.float32(2.0)
    tr.params = {}
    tr.opt_state = None
    tr.opt_cfg = None
    tr.dataset = types.SimpleNamespace(
        xforms=np.eye(4, dtype=np.float32)[None, :3])
    tr.grid = types.SimpleNamespace(
        bitfield=np.full((occ.NERF_CASCADES * occ.GRID_VOLUME // 8,),
                         255, np.uint8))
    cache = bake_playback_cache(tr, D=40, params={},
                                ref_eye=np.float32([0.5, 0.5, -1.0]))
    assert (np.asarray(cache.vols[1], np.float32)[..., 3] > 0).any()

    W = H = 36
    for eye in [(0.5, 0.48, -0.2), (0.55, 0.5, 0.52)]:
        xf = _lookat_xform(eye, target=(0.5, 0.52, 0.55))
        r = PlaybackRenderer(cache, PlaybackOptions(
            width=W, height=H, int_scale=2.0, outer_int_scale=2.0,
            linear_out=False))
        img = r.render(xf, W, H, focal=(40.0, 40.0))
        ref = _brute_force(cache, xf, W, H, 40.0, 40.0)
        err = float(np.abs(img - ref).mean())
        assert np.isfinite(img).all()
        assert err < 1e-2, (eye, err)


@pytest.mark.slow
def test_testbed_playback_roundtrip(tmp_path):
    """Testbed.bake_playback + render_playback runs end to end on a tiny
    in-memory scene (the Blender flow) and round-trips save/load."""
    from ngp_jax.api.testbed import Testbed
    from ngp_jax.common import TestbedMode

    tb = Testbed(TestbedMode.NERF)
    tb.reload_network_from_json({
        "encoding": {"otype": "HashGrid", "n_levels": 4,
                     "log2_hashmap_size": 12},
        "network": {"otype": "FullyFusedMLP", "n_neurons": 16,
                    "n_hidden_layers": 1},
        "rgb_network": {"n_neurons": 16, "n_hidden_layers": 1},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
        "loss": {"otype": "Huber"},
    })
    tb.create_empty_nerf_dataset(n_images=2, aabb_scale=1)
    img = np.zeros((16, 16, 4), np.float32)
    img[4:12, 4:12] = (0.8, 0.2, 0.1, 1.0)
    xf = np.eye(4, dtype=np.float32)[:3]
    xf[2, 3] = -2.0
    for i in range(2):
        tb.set_image(i, img, xf)
    tb.nerf.training.n_images_for_training = 2
    tb.training_batch_size = 1 << 10
    tb.shall_train = True
    for _ in range(3):
        tb.frame()
    tb.set_camera_to_training_view(0)
    live = tb.render(16, 16, spp=1, linear=True)
    tb.bake_playback(D=24, D_inner=24, path=str(tmp_path / "pb.npz"))
    pb = tb.render_playback(16, 16)
    assert pb.shape == live.shape
    assert np.isfinite(pb).all()
    tb.load_playback(str(tmp_path / "pb.npz"))
    pb2 = tb.render_playback(16, 16)
    np.testing.assert_allclose(pb2, pb, atol=1e-2)


class _DirLinearModel:
    """rgb(d) = base + 0.3*d — exactly representable by degree-1 SH."""

    def rgb_sigma(self, params, pos01, dir01, extra=None):
        import jax.numpy as jnp
        p = pos01
        d = dir01 * 2.0 - 1.0
        inside = ((p > 0.35) & (p < 0.65)).all(-1)
        sigma = 50.0 * inside
        base = jnp.stack([jnp.full_like(sigma, 0.5),
                          jnp.full_like(sigma, 0.4),
                          jnp.full_like(sigma, 0.45)], -1)
        return jnp.clip(base + 0.3 * d, 0.0, 1.0), sigma


def _tiny_trainer(model):
    import types
    from ngp_jax.grid import occupancy as occ
    tr = types.SimpleNamespace()
    tr.model = model
    tr.max_cascade = 0
    tr.aabb_min = np.float32(0.0)
    tr.aabb_size = np.float32(1.0)
    tr.params = {}
    tr.opt_state = None
    tr.opt_cfg = None
    tr.dataset = types.SimpleNamespace(
        xforms=np.eye(4, dtype=np.float32)[None, :3])
    tr.grid = types.SimpleNamespace(
        bitfield=np.full((occ.NERF_CASCADES * occ.GRID_VOLUME // 8,),
                         255, np.uint8))
    return tr


def test_sh_bake_matches_diffuse_on_dir_independent_model():
    """SH of a direction-independent field reproduces the diffuse bake's
    render exactly (constant -> c0 Y00 only)."""
    from ngp_jax.render.playback import bake_playback_cache

    tr = _tiny_trainer(_AnalyticModel())
    c_diff = bake_playback_cache(tr, D=32, params={},
                                 ref_eye=np.float32([0.5, 0.5, -1.0]))
    c_sh = bake_playback_cache(tr, D=32, params={}, sh_degree=1)
    assert np.asarray(c_sh.vols[0]).shape[-1] == 13
    W = H = 32
    xf = _lookat_xform((0.5, 0.45, -1.2))
    img_d = PlaybackRenderer(c_diff, PlaybackOptions(
        width=W, height=H, int_scale=2.0, linear_out=False)).render(
        xf, W, H, focal=(40., 40.))
    img_s = PlaybackRenderer(c_sh, PlaybackOptions(
        width=W, height=H, int_scale=2.0, linear_out=False)).render(
        xf, W, H, focal=(40., 40.))
    assert float(np.abs(img_s - img_d).max()) < 2e-2


def test_sh_bake_captures_linear_view_dependence():
    """A dir-linear rgb field is EXACT under degree-1 SH: rendering the
    opaque box from opposite sides must show rgb(base +- 0.3*fwd), which
    a diffuse bake cannot (it returns the same color both ways)."""
    from ngp_jax.render.playback import bake_playback_cache

    tr = _tiny_trainer(_DirLinearModel())
    cache = bake_playback_cache(tr, D=40, params={}, sh_degree=1)
    W = H = 24
    cols = {}
    for tag, eye in [("front", (0.5, 0.5, -1.0)), ("back", (0.5, 0.5, 2.0))]:
        xf = _lookat_xform(eye)
        img = PlaybackRenderer(cache, PlaybackOptions(
            width=W, height=H, int_scale=2.0, linear_out=False)).render(
            xf, W, H, focal=(52., 52.))
        cols[tag] = img[H // 2, W // 2, :3]
    # center rays: d = +z (front) / -z (back); rgb(d) = base + 0.3*d
    # componentwise, so only the BLUE channel shifts by +-0.3
    exp_front = np.float32([0.5, 0.4, 0.45 + 0.3])
    exp_back = np.float32([0.5, 0.4, 0.45 - 0.3])
    np.testing.assert_allclose(cols["front"], exp_front, atol=0.08)
    np.testing.assert_allclose(cols["back"], exp_back, atol=0.08)
    assert float(np.abs(cols["front"] - cols["back"]).max()) > 0.4


def test_linear_out_applies_srgb_to_linear():
    """linear_out converts the model-space (sRGB) composite exactly like
    the live renderer (nerf_render.py:1176) — regression guard for the
    round-5 double-sRGB bug (+9 dB on fox once fixed)."""
    from ngp_jax.common import srgb_to_linear_np

    cache = _smooth_cache(n_casc=1, D=24)
    xf = _lookat_xform((0.5, 0.5, -1.2))
    W = H = 24
    raw = PlaybackRenderer(cache, PlaybackOptions(
        width=W, height=H, linear_out=False)).render(
        xf, W, H, focal=(28., 28.))
    lin = PlaybackRenderer(cache, PlaybackOptions(
        width=W, height=H, linear_out=True)).render(
        xf, W, H, focal=(28., 28.))
    np.testing.assert_allclose(
        lin[..., :3], srgb_to_linear_np(np.clip(raw[..., :3], 0, None)),
        atol=1e-5)
    np.testing.assert_allclose(lin[..., 3], raw[..., 3], atol=1e-6)
