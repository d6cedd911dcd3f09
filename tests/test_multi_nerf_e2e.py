"""Fork flagship path end-to-end: train a tiny NeRF, save a snapshot,
render it through the Blender RenderRequest engine (with a second
transformed instance + masks)."""
import numpy as np
import pytest

from synthetic import make_orbit_dataset
from test_nerf_e2e import render_gt_sphere


@pytest.mark.slow
def test_render_request_roundtrip(tmp_path):
    import jax
    from ngp_jax.config import load_network_config
    from ngp_jax.render.multi_nerf import (Mask3D, MultiNerfRenderer,
                                           NerfDescriptor,
                                           RenderCameraProperties,
                                           RenderOutputProperties,
                                           RenderRequest, DownsampleInfo)
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    res, focal = 32, 32.0
    center = np.array([0.5, 0.5, 0.5])
    color = np.array([0.2, 0.7, 0.3], np.float32)
    ds = make_orbit_dataset(n_images=8, res=res, radius=1.4, focal=focal)
    imgs = np.stack([
        render_gt_sphere(res, ds.xforms[i], focal, center, 0.22, color,
                         np.zeros(3)) for i in range(8)])
    ds.images = imgs
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 6
    cfg["encoding"]["log2_hashmap_size"] = 14
    # budget note (round 4): 2^13 samples honestly supports only ~64 full
    # rays on this dense synthetic scene; the old config "passed" because
    # segment truncation silently trained ~91 rays' worth while marching
    # 512. With truncation eliminated (step-0 ray-budget probe), give the
    # test a budget that trains ~128 rays and a couple more boundaries.
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=512, target_batch_size=1 << 14, march_steps=1024))
    tr.train(96)
    snap = tmp_path / "sphere.msgpack"
    tr.save_snapshot(snap, cfg)

    cam = RenderCameraProperties(
        transform=np.vstack([ds.xforms[0], [0, 0, 0, 1]]),
        focal_length=focal)
    out = RenderOutputProperties(width=32, height=32, spp=1,
                                 background_color=(0, 0, 0, 0),
                                 flip_y=False)
    req = RenderRequest(output=out, camera=cam,
                        nerfs=[NerfDescriptor(snapshot_path=str(snap))])
    r = MultiNerfRenderer(march_steps=1024, chunk=1 << 10)
    img = r.render(req)
    assert img.shape == (32, 32, 4)
    # the sphere should show: center pixel opaque-ish, corner transparent
    assert img[16, 16, 3] > 0.3, img[16, 16]
    assert img[1, 1, 3] < 0.2, img[1, 1]

    # second instance translated +x via descriptor transform + a subtract
    # mask carving the original: center pixel should lose opacity
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = 0.6
    req2 = RenderRequest(
        output=out, camera=cam,
        nerfs=[NerfDescriptor(snapshot_path=str(snap),
                              masks=[Mask3D(shape="sphere", mode="subtract",
                                            radius=2.0, feather=0.05,
                                            transform=np.eye(4, dtype=np.float32))]),
               NerfDescriptor(snapshot_path=str(snap), transform=m)])
    img2 = r.render(req2)
    assert img2[16, 16, 3] < img[16, 16, 3] + 1e-3
    # downsample preview path
    req3 = RenderRequest(
        output=RenderOutputProperties(width=32, height=32, spp=1,
                                      downsample=DownsampleInfo.MakeFromMip(1),
                                      flip_y=True),
        camera=cam, nerfs=[NerfDescriptor(snapshot_path=str(snap))])
    img3 = r.render(req3)
    assert img3.shape == (16, 16, 4)

    # composite-mode A/B (ref nearest-proxy cull, nerf_renderer.cu:376-428):
    # two IDENTICAL overlapping proxies at opacity 0.5. "sum" superposes
    # their densities (0.5σ + 0.5σ = σ → as opaque as one full proxy);
    # "nearest" (the DEFAULT, matching reference semantics) lets the first
    # proxy claim each lattice point exclusively (→ identical to rendering
    # a single proxy at opacity 0.5).
    assert r.composite_mode == "nearest", "ref semantics must be default"
    half2 = [NerfDescriptor(snapshot_path=str(snap), opacity=0.5),
             NerfDescriptor(snapshot_path=str(snap), opacity=0.5)]
    req_ab = RenderRequest(output=out, camera=cam, nerfs=half2)
    rs = MultiNerfRenderer(march_steps=1024, chunk=1 << 10,
                           composite_mode="sum")
    rs.fields = r.fields          # share loaded fields (same snapshot)
    img_sum = rs.render(req_ab)
    rn = r                        # default renderer IS the nearest path
    img_near = rn.render(req_ab)
    img_half = rn.render(RenderRequest(
        output=out, camera=cam,
        nerfs=[NerfDescriptor(snapshot_path=str(snap), opacity=0.5)]))
    c = (16, 16)
    assert abs(img_near[c][3] - img_half[c][3]) < 2e-2, \
        (img_near[c], img_half[c])
    assert img_sum[c][3] > img_near[c][3] + 0.05, \
        (img_sum[c], img_near[c])


@pytest.mark.slow
def test_render_request_spp_dof_tonemap(tmp_path):
    """spp / aperture / tonemap on RenderRequest must be honored
    (ref: render_request.cuh:17-125 + per-ray thin-lens DoF,
    common_device.cuh:260-317 — round-1 carried these as dead fields)."""
    import jax
    from ngp_jax.common import TonemapCurve
    from ngp_jax.config import load_network_config
    from ngp_jax.render.multi_nerf import (MultiNerfRenderer,
                                           NerfDescriptor,
                                           RenderCameraProperties,
                                           RenderOutputProperties,
                                           RenderRequest)
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    ds = make_orbit_dataset(n_images=2, res=16)
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=128, target_batch_size=1024, march_steps=1024))
    tr.train(2)
    snap = tmp_path / "s.msgpack"
    tr.save_snapshot(str(snap), cfg)

    def req(**kw):
        cam_kw = {k: kw.pop(k) for k in ("aperture_size", "focus_z")
                  if k in kw}
        cam = RenderCameraProperties(
            transform=np.vstack([ds.xforms[0], [0, 0, 0, 1]]),
            focal_length=16.0, **cam_kw)
        out = RenderOutputProperties(width=8, height=8,
                                     background_color=(0.1, 0.1, 0.1, 1),
                                     flip_y=False, **kw)
        return RenderRequest(output=out, camera=cam,
                             nerfs=[NerfDescriptor(snapshot_path=str(snap))])

    r = MultiNerfRenderer(march_steps=512, chunk=64)
    base = r.render(req(spp=1))
    multi = r.render(req(spp=3))
    assert np.isfinite(multi).all()
    dof = r.render(req(spp=2, aperture_size=0.2, focus_z=1.5))
    assert np.isfinite(dof).all()
    toned = r.render(req(spp=1, tonemap_curve=TonemapCurve.ACES))
    assert not np.allclose(base, toned), "tonemap must change the frame"
