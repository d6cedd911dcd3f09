"""Wave (live-sample) renderer: must match the static segmented path
bit-for-bit at equal per-segment caps (the wave path changes WHERE network
evaluation happens — dynamically counted fixed-shape blocks — not the
math; ref analog: NerfTracer::trace compaction loop,
src/testbed_nerf.cu:2140-2267)."""
import numpy as np
import pytest

from synthetic import make_orbit_dataset


def _setup(march_steps=256, res=16):
    import jax.numpy as jnp
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    ds = make_orbit_dataset(res=res)
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=2048, march_steps=march_steps))
    tr.train(4)    # non-trivial density field
    bits = jnp.full_like(tr.grid.bitfield, 255)
    return tr, ds, bits


@pytest.mark.parametrize("mode_name,sync", [
    ("SHADE", "bulk"), ("DEPTH", "bulk"), ("AO", "bulk"),
    ("SHADE", "exact")])
def test_wave_matches_static(mode_name, sync):
    from ngp_jax.common import RenderMode
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    kw = dict(width=12, height=12, march_steps=256, chunk=64,
              march_segments=4, render_mode=RenderMode[mode_name],
              linear_out=False, background=(0.2, 0.1, 0.3, 0.0))
    r_static = NerfRenderer.for_trainer(tr, RenderOptions(
        samples_per_chunk_factor=32, **kw))
    r_wave = NerfRenderer.for_trainer(tr, RenderOptions(
        wave=True, wave_cap=32, wave_sync=sync, wave_fused=False,
        wave_dispatch="host", **kw))
    img_s = r_static.render(tr.params, bits, ds.xforms[0], 12, 12,
                            focal=(14., 14.))
    img_w = r_wave.render(tr.params, bits, ds.xforms[0], 12, 12,
                          focal=(14., 14.))
    assert np.isfinite(img_w).all()
    np.testing.assert_allclose(img_w, img_s, rtol=2e-4, atol=2e-5)


def test_wave_counts_live_samples_only():
    """An empty bitfield ⇒ zero network evaluations (the static path
    would still pay every slot)."""
    import jax.numpy as jnp
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, _ = _setup()
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        width=8, height=8, march_steps=256, chunk=64, wave=True,
        linear_out=False, background=(0.5, 0.5, 0.5, 0.0)))
    empty = jnp.zeros_like(tr.grid.bitfield)
    img = r.render(tr.params, empty, ds.xforms[0], 8, 8, focal=(10., 10.))
    assert r.last_wave_samples == 0
    np.testing.assert_allclose(img[..., :3], 0.5, atol=1e-6)
    np.testing.assert_allclose(img[..., 3], 0.0, atol=1e-6)


def test_wave_spp_and_masks():
    """spp accumulation + Mask3D alpha modulation agree with the static
    path under snap-to-centers (deterministic rays)."""
    from ngp_jax.common import RenderMode
    from ngp_jax.render.multi_nerf import Mask3D
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    xf = np.eye(4, dtype=np.float32)
    xf[:3, 3] = 0.5
    mask = Mask3D(shape="box", transform=xf,
                  dims=np.asarray([0.4, 0.4, 0.4], np.float32),
                  feather=0.1)
    kw = dict(width=8, height=8, march_steps=256, chunk=64,
              march_segments=2, render_mode=RenderMode.SHADE,
              linear_out=False, snap_to_pixel_centers=True, spp=2)
    r_s = NerfRenderer.for_trainer(tr, RenderOptions(
        samples_per_chunk_factor=32, **kw), masks=[mask])
    r_w = NerfRenderer.for_trainer(tr, RenderOptions(
        wave=True, wave_cap=32, wave_fused=False,
        wave_dispatch="host", **kw), masks=[mask])
    img_s = r_s.render(tr.params, bits, ds.xforms[0], 8, 8,
                       focal=(10., 10.), spp=2)
    img_w = r_w.render(tr.params, bits, ds.xforms[0], 8, 8,
                       focal=(10., 10.), spp=2)
    np.testing.assert_allclose(img_w, img_s, rtol=2e-4, atol=2e-5)


def test_hier_march_matches_flat_on_sparse_grid():
    """wave_march="hier" must reproduce the flat wave render exactly on a
    sparse bitfield (the realistic regime — the coarse mask is
    conservative), and fall back to flat when the segment stream
    overflows (tiny wave_hier_frac headroom)."""
    import jax
    import jax.numpy as jnp
    from ngp_jax.grid import occupancy as occ
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, _ = _setup()
    dens = jnp.where(jax.random.uniform(jax.random.PRNGKey(0),
                                        tr.grid.density.shape) > 0.97,
                     1.0, 0.0)                       # ~3% occupied
    grid = occ.rebuild_bitfield(tr.grid._replace(density=dens),
                                tr.max_cascade)
    kw = dict(width=12, height=12, march_steps=256, chunk=64, wave=True,
              wave_cap=32, wave_fused=False, wave_dispatch="host",
              linear_out=False, background=(0.2, 0.1, 0.3, 0.0))
    img_flat = NerfRenderer.for_trainer(tr, RenderOptions(
        wave_march="flat", **kw)).render(
        tr.params, grid.bitfield, ds.xforms[0], 12, 12, focal=(14., 14.))
    img_hier = NerfRenderer.for_trainer(tr, RenderOptions(
        wave_march="hier", **kw)).render(
        tr.params, grid.bitfield, ds.xforms[0], 12, 12, focal=(14., 14.))
    np.testing.assert_array_equal(img_hier, img_flat)

    # overflow → flat fallback still yields the exact image (frac so
    # large the bound 4096 can't hold a dense chunk's segments)
    bits_full = jnp.full_like(tr.grid.bitfield, 255)
    imgs = []
    for frac in (8, 10 ** 6):
        imgs.append(NerfRenderer.for_trainer(tr, RenderOptions(
            wave_march="hier", wave_hier_frac=frac, **kw)).render(
            tr.params, bits_full, ds.xforms[0], 12, 12, focal=(14., 14.)))
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_fused_wave_matches_static_single_segment():
    """wave_fused (the round-5 default: ONE compact+eval+composite body
    per chunk) must match the static path with march_segments=1 at the
    equal whole-ray cap bit-for-bit — the fusion removes dispatches and
    bucket padding, not math."""
    from ngp_jax.common import RenderMode
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    kw = dict(width=12, height=12, march_steps=256, chunk=64,
              render_mode=RenderMode.SHADE, linear_out=False,
              background=(0.2, 0.1, 0.3, 0.0))
    r_static = NerfRenderer.for_trainer(tr, RenderOptions(
        march_segments=1, samples_per_chunk_factor=128, **kw))
    # wave_cap 32 x march_segments 4 = whole-ray cap 128
    r_fused = NerfRenderer.for_trainer(tr, RenderOptions(
        wave=True, wave_cap=32, march_segments=4, wave_fused=True,
        wave_dispatch="host", **kw))
    img_s = r_static.render(tr.params, bits, ds.xforms[0], 12, 12,
                            focal=(14., 14.))
    img_f = r_fused.render(tr.params, bits, ds.xforms[0], 12, 12,
                           focal=(14., 14.))
    assert np.isfinite(img_f).all()
    np.testing.assert_allclose(img_f, img_s, rtol=2e-4, atol=2e-5)


def test_fused_wave_close_to_segmented():
    """Fused and segmented waves differ only in decimation granularity +
    early-out placement — images must agree closely on a normal scene."""
    from ngp_jax.common import RenderMode
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    kw = dict(width=12, height=12, march_steps=256, chunk=64,
              march_segments=4, wave=True, wave_cap=32,
              render_mode=RenderMode.SHADE, linear_out=False,
              background=(0.2, 0.1, 0.3, 0.0))
    img_seg = NerfRenderer.for_trainer(tr, RenderOptions(
        wave_fused=False, wave_dispatch="host", **kw)).render(
        tr.params, bits, ds.xforms[0], 12, 12, focal=(14., 14.))
    img_fus = NerfRenderer.for_trainer(tr, RenderOptions(
        wave_fused=True, wave_dispatch="host", **kw)).render(
        tr.params, bits, ds.xforms[0], 12, 12, focal=(14., 14.))
    np.testing.assert_allclose(img_fus, img_seg, atol=5e-2)

def test_wave2_matches_static():
    """The device-dispatch wave (round 5: march to the segment stream +
    lax.switch bucket selection, zero host syncs) must match the static
    path at the equal whole-ray cap — same decimation + composite math,
    different dispatch/layout."""
    from ngp_jax.common import RenderMode
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    kw = dict(width=12, height=12, march_steps=256, chunk=64,
              render_mode=RenderMode.SHADE, linear_out=False,
              background=(0.2, 0.1, 0.3, 0.0))
    r_static = NerfRenderer.for_trainer(tr, RenderOptions(
        march_segments=1, samples_per_chunk_factor=128, **kw))
    # full bitfield ⇒ every inside segment survives: frac=1 sizes the
    # stream for it (the overflow-fallback test covers small bounds)
    r_w2 = NerfRenderer.for_trainer(tr, RenderOptions(
        wave=True, wave_cap=32, march_segments=4,
        wave_dispatch="device", wave2_frac=1, **kw))
    img_s = r_static.render(tr.params, bits, ds.xforms[0], 12, 12,
                            focal=(14., 14.))
    img_w = r_w2.render(tr.params, bits, ds.xforms[0], 12, 12,
                        focal=(14., 14.))
    assert np.isfinite(img_w).all()
    assert r_w2.last_wave_samples > 0
    np.testing.assert_allclose(img_w, img_s, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("mode_name", ["DEPTH", "AO"])
def test_wave2_modes_match_fused_host(mode_name):
    """DEPTH/AO under device dispatch agree with the host fused wave
    (identical math, different dispatch)."""
    from ngp_jax.common import RenderMode
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    kw = dict(width=12, height=12, march_steps=256, chunk=64,
              march_segments=4, wave=True, wave_cap=32,
              render_mode=RenderMode[mode_name], linear_out=False,
              background=(0.2, 0.1, 0.3, 0.0))
    img_h = NerfRenderer.for_trainer(tr, RenderOptions(
        wave_fused=True, wave_dispatch="host", **kw)).render(
        tr.params, bits, ds.xforms[0], 12, 12, focal=(14., 14.))
    img_d = NerfRenderer.for_trainer(tr, RenderOptions(
        wave_dispatch="device", wave2_frac=1, **kw)).render(
        tr.params, bits, ds.xforms[0], 12, 12, focal=(14., 14.))
    np.testing.assert_allclose(img_d, img_h, rtol=2e-4, atol=2e-5)


def test_wave2_spp_masks_and_sparse_grid():
    """Device dispatch under spp accumulation + Mask3D + a sparse
    bitfield matches the static path (deterministic snap-to-centers)."""
    import jax
    import jax.numpy as jnp
    from ngp_jax.common import RenderMode
    from ngp_jax.grid import occupancy as occ
    from ngp_jax.render.multi_nerf import Mask3D
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, _ = _setup()
    dens = jnp.where(jax.random.uniform(jax.random.PRNGKey(0),
                                        tr.grid.density.shape) > 0.9,
                     1.0, 0.0)
    grid = occ.rebuild_bitfield(tr.grid._replace(density=dens),
                                tr.max_cascade)
    xf = np.eye(4, dtype=np.float32)
    xf[:3, 3] = 0.5
    mask = Mask3D(shape="box", transform=xf,
                  dims=np.asarray([0.4, 0.4, 0.4], np.float32),
                  feather=0.1)
    kw = dict(width=8, height=8, march_steps=256, chunk=64,
              march_segments=1, render_mode=RenderMode.SHADE,
              linear_out=False, snap_to_pixel_centers=True, spp=2)
    r_s = NerfRenderer.for_trainer(tr, RenderOptions(
        samples_per_chunk_factor=64, **kw), masks=[mask])
    r_w = NerfRenderer.for_trainer(tr, RenderOptions(
        wave=True, wave_cap=64, wave_dispatch="device", wave2_frac=1,
        **kw), masks=[mask])
    img_s = r_s.render(tr.params, grid.bitfield, ds.xforms[0], 8, 8,
                       focal=(10., 10.), spp=2)
    img_w = r_w.render(tr.params, grid.bitfield, ds.xforms[0], 8, 8,
                       focal=(10., 10.), spp=2)
    np.testing.assert_allclose(img_w, img_s, rtol=2e-4, atol=2e-5)


def test_wave2_overflow_falls_back_to_static():
    """A segment-stream bound too small for a dense chunk must NOT
    silently under-render: the group is re-rendered on the static path."""
    from ngp_jax.common import RenderMode
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    kw = dict(width=12, height=12, march_steps=256, chunk=64,
              render_mode=RenderMode.SHADE, linear_out=False,
              background=(0.2, 0.1, 0.3, 0.0))
    img_ref = NerfRenderer.for_trainer(tr, RenderOptions(
        march_segments=4, samples_per_chunk_factor=32, **kw)).render(
        tr.params, bits, ds.xforms[0], 12, 12, focal=(14., 14.))
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        wave=True, wave_cap=32, march_segments=4, wave_dispatch="device",
        wave2_frac=10 ** 6, **kw))
    img = r.render(tr.params, bits, ds.xforms[0], 12, 12,
                   focal=(14., 14.))
    np.testing.assert_allclose(img, img_ref, rtol=2e-4, atol=2e-5)


def test_wave2_decimates_to_fit_top_bucket():
    """When the live total exceeds the largest switch bucket, the per-ray
    cap halves on device until the stream fits — the render stays finite
    and close to the uncapped image (denser decimation, same optical
    depth)."""
    from ngp_jax.common import RenderMode
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    kw = dict(width=12, height=12, march_steps=256, chunk=64,
              march_segments=4, wave=True, wave_cap=32,
              render_mode=RenderMode.SHADE, linear_out=False,
              background=(0.2, 0.1, 0.3, 0.0))
    img_full = NerfRenderer.for_trainer(tr, RenderOptions(
        wave_dispatch="device", wave2_frac=1, **kw)).render(
        tr.params, bits, ds.xforms[0], 12, 12, focal=(14., 14.))
    img_tiny = NerfRenderer.for_trainer(tr, RenderOptions(
        wave_dispatch="device", wave2_top_bucket=1 << 9, wave2_frac=1,
        **kw)).render(
        tr.params, bits, ds.xforms[0], 12, 12, focal=(14., 14.))
    assert np.isfinite(img_tiny).all()
    np.testing.assert_allclose(img_tiny, img_full, atol=7e-2)


def test_wave2_flat_matches_static():
    """The flat device-dispatch program (stream = the (R, K) lattice;
    the fallback for scenes the coarse mask cannot cull) matches the
    static path at the equal whole-ray cap."""
    from ngp_jax.common import RenderMode
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    kw = dict(width=12, height=12, march_steps=256, chunk=64,
              render_mode=RenderMode.SHADE, linear_out=False,
              background=(0.2, 0.1, 0.3, 0.0))
    img_s = NerfRenderer.for_trainer(tr, RenderOptions(
        march_segments=1, samples_per_chunk_factor=128, **kw)).render(
        tr.params, bits, ds.xforms[0], 12, 12, focal=(14., 14.))
    r_w = NerfRenderer.for_trainer(tr, RenderOptions(
        wave=True, wave_cap=32, march_segments=4, wave_dispatch="device",
        wave_march="flat", **kw))
    img_w = r_w.render(tr.params, bits, ds.xforms[0], 12, 12,
                       focal=(14., 14.))
    assert r_w.last_wave_samples > 0
    np.testing.assert_allclose(img_w, img_s, rtol=2e-4, atol=2e-5)


def test_wave2_overflow_reroutes_to_flat():
    """A hier-stream overflow must re-render on the FLAT device program
    (and stick to it), matching the static image."""
    from ngp_jax.common import RenderMode
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions

    tr, ds, bits = _setup()
    kw = dict(width=12, height=12, march_steps=256, chunk=64,
              render_mode=RenderMode.SHADE, linear_out=False,
              background=(0.2, 0.1, 0.3, 0.0))
    img_ref = NerfRenderer.for_trainer(tr, RenderOptions(
        march_segments=4, samples_per_chunk_factor=32, **kw)).render(
        tr.params, bits, ds.xforms[0], 12, 12, focal=(14., 14.))
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        wave=True, wave_cap=32, march_segments=4, wave_dispatch="device",
        wave2_frac=10 ** 6, **kw))
    img = r.render(tr.params, bits, ds.xforms[0], 12, 12,
                   focal=(14., 14.))
    assert r.last_wave_samples > 0 and r._wave2_flat_sticky
    np.testing.assert_allclose(img, img_ref, rtol=2e-4, atol=2e-5)
