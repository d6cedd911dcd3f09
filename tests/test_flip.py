"""LDR-FLIP parity vs the NVIDIA implementation the reference vendors.

Ours is an independent implementation of the published metric; the
vendored code (read-only, /root/reference/scripts/flip) is used here as
a black-box oracle only.
"""
import sys

import numpy as np
import pytest

sys.path.insert(0, "/root/reference/scripts")

try:
    import flip as nv_flip
    import flip.utils as nv_utils
    HAVE_NV = True
except Exception:                                  # pragma: no cover
    HAVE_NV = False


def _pair(seed=0, H=48, W=64):
    rng = np.random.RandomState(seed)
    base = rng.rand(H, W, 3).astype(np.float64)
    # smooth + structured content (edges) + a perturbed copy
    for ax in (0, 1):
        base = (base + np.roll(base, 1, ax) + np.roll(base, 2, ax)) / 3
    base[H // 3:, : W // 2] *= 0.3
    test = np.clip(base + 0.08 * rng.randn(H, W, 3), 0, 1)
    return np.clip(base, 0, 1), test


@pytest.mark.skipif(not HAVE_NV, reason="vendored FLIP unavailable")
@pytest.mark.parametrize("seed,ppd", [(0, 67.0), (3, 30.0), (7, 67.0)])
def test_flip_map_matches_vendored(seed, ppd):
    from ngp_jax.utils.flip import compute_flip_map

    ref, tst = _pair(seed)
    ours = compute_flip_map(ref, tst, ppd)
    theirs = nv_flip.compute_flip(nv_utils.HWCtoCHW(ref),
                                  nv_utils.HWCtoCHW(tst), ppd)[0]
    assert ours.shape == theirs.shape
    assert float(np.abs(ours - theirs).max()) < 1e-6


@pytest.mark.skipif(not HAVE_NV, reason="vendored FLIP unavailable")
def test_flip_scalar_matches_vendored_mean():
    from ngp_jax.utils.flip import flip

    ref, tst = _pair(5)
    ppd = 0.7 * (3840 / 0.7) * (np.pi / 180)
    theirs = float(np.mean(nv_flip.compute_flip(
        nv_utils.HWCtoCHW(ref), nv_utils.HWCtoCHW(tst), ppd)))
    assert abs(flip(tst, ref) - theirs) < 1e-8


def test_flip_basic_properties():
    from ngp_jax.utils.flip import flip

    ref, tst = _pair(1)
    assert flip(ref, ref) < 1e-6          # identical images → ~0
    v = flip(tst, ref)
    assert 0.0 < v < 1.0
    worse = np.clip(tst + 0.3, 0, 1)
    assert flip(worse, ref) > v
