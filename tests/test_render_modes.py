"""Render-mode coverage: every reference ERenderMode variant the headless
build supports must produce a finite frame (ref: common.h:80-92 +
composite_kernel_nerf glow block :843-940)."""
import numpy as np
import pytest

from synthetic import make_orbit_dataset


@pytest.mark.slow
@pytest.mark.parametrize("mode_name,extra", [
    ("SHADE", {"glow_mode": 3, "glow_y_cutoff": 0.6}),
    ("NORMALS", {}),
    ("POSITIONS", {}),
    ("POSITIONS", {"show_accel": 0}),   # density-grid mip visualization
    ("DEPTH", {}),
    ("AO", {}),
    ("COST", {}),
    ("SLICE", {}),
    ("ENCODING_VIS", {}),
    ("DISTORTION", {}),
])
def test_render_mode_finite(mode_name, extra):
    import jax.numpy as jnp
    from ngp_jax.common import RenderMode
    from ngp_jax.config import load_network_config
    from ngp_jax.render.nerf_render import NerfRenderer, RenderOptions
    from ngp_jax.train.nerf import NerfTrainer, NerfTrainerConfig

    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    ds = make_orbit_dataset(res=16)
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(
        n_rays=256, target_batch_size=2048, march_steps=256))
    bits = jnp.full_like(tr.grid.bitfield, 255)
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        width=8, height=8, march_steps=256, chunk=64,
        render_mode=RenderMode[mode_name], linear_out=False, **extra))
    img = r.render(tr.params, bits, ds.xforms[0], 8, 8, focal=(10., 10.))
    assert img.shape == (8, 8, 4)
    assert np.isfinite(img).all()
