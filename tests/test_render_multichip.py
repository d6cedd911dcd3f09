"""Frame-sharded rendering over the virtual mesh must reproduce the
single-device image (chunk keys match)."""
import jax
import numpy as np
import pytest

from synthetic import make_orbit_dataset


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_render_multichip_matches_single():
    import jax.numpy as jnp
    from ngp_jax.config import load_network_config
    from ngp_jax.dist.mesh import make_mesh
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
        width=32, height=16, march_steps=256, chunk=256,
        linear_out=False))
    single = r.render(tr.params, bits, ds.xforms[0], 32, 16,
                      focal=(20.0, 20.0))
    mesh = make_mesh(n_data=4, devices=jax.devices()[:4])
    multi = r.render_multichip(mesh, tr.params, bits, ds.xforms[0],
                               32, 16, focal=(20.0, 20.0))
    assert multi.shape == single.shape
    np.testing.assert_allclose(multi, single, atol=2e-5)
