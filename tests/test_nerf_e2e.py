"""End-to-end NeRF: train on a synthetic solid-sphere scene rendered
analytically, then re-render a training view and compare."""
import numpy as np
import pytest

from synthetic import make_orbit_dataset


def render_gt_sphere(res, xform, focal, center, radius, color, bg):
    """Analytic render of an opaque Lambertian-free sphere."""
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    u = (xs + 0.5) / res - 0.5
    v = (ys + 0.5) / res - 0.5
    d = np.stack([u * res / focal, v * res / focal, np.ones_like(u)], -1)
    dw = d @ xform[:, :3].T
    dw /= np.linalg.norm(dw, axis=-1, keepdims=True)
    o = xform[:, 3]
    oc = o - center
    b = (dw * oc).sum(-1)
    c = (oc * oc).sum() - radius ** 2
    disc = b * b - c
    hit = disc > 0
    img = np.empty((res, res, 4), np.float32)
    img[..., :3] = bg
    img[..., 3] = 0.0
    img[hit, :3] = color
    img[hit, 3] = 1.0
    return img


@pytest.mark.slow
def test_nerf_learns_and_renders_sphere():
    import jax
    from ngp_jax.config import load_network_config
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    res = 48
    focal = 48.0
    center = np.array([0.5, 0.5, 0.5])
    radius = 0.22
    color = np.array([0.8, 0.3, 0.2], np.float32)
    n_img = 12
    ds = make_orbit_dataset(n_images=n_img, res=res, radius=1.4, focal=focal)
    imgs = np.stack([
        render_gt_sphere(res, ds.xforms[i], focal, center, radius, color,
                         bg=np.zeros(3))
        for i in range(n_img)])
    # premultiplied alpha: color only where alpha=1 → already premultiplied
    ds.images = imgs

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 8
    cfg["encoding"]["log2_hashmap_size"] = 15
    # march_steps must cover the whole unit box: aabb_scale=1 → cone 0 →
    # uniform dt = sqrt(3)/1024, so crossing needs the full 1024 slots
    tc = NerfTrainerConfig(n_rays=1024, target_batch_size=1 << 14,
                           march_steps=1024, random_bg_color=True)
    tr = NerfTrainer(ds, cfg, tcfg=tc)
    tr.train(150)

    # density should be high inside the sphere, low outside
    inside = tr.density_at(center[None] + [[0.0, 0.0, 0.05]])
    outside = tr.density_at(center[None] + [[0.0, 0.0, 0.45]])
    assert inside[0] > 10 * max(outside[0], 1e-3), (inside, outside)

    # re-render a training view and compare against the analytic image
    from ngp_jax.opt.optimizers import inference_params
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
    opts = RenderOptions(width=res, height=res, fov_axis_focal=focal,
                         background=(0, 0, 0, 0), linear_out=True,
                         chunk=1 << 11, march_steps=1024,
                         samples_per_chunk_factor=256)
    r = NerfRenderer.for_trainer(tr, opts)
    p = inference_params(tr.params, tr.opt_state, tr.opt_cfg)
    img = r.render(p, tr.grid.bitfield, ds.xforms[0], res, res,
                   focal=(focal, focal), spp=1)
    gt = imgs[0]
    # compare in sRGB-ish space on the alpha-over-black composite
    mse = float(np.mean((img[..., :3] - gt[..., :3]) ** 2))
    psnr = -10 * np.log10(max(mse, 1e-10))
    # opacity should roughly match the sphere silhouette
    sil_err = float(np.mean(np.abs(img[..., 3] - gt[..., 3])))
    assert psnr > 14.0, psnr
    assert sil_err < 0.2, sil_err
