"""ngp_jax — neural graphics primitives in JAX.

A from-scratch JAX re-design of instant-ngp + the blender-ngp fork
(reference: JamesPerlman/blender-ngp). Four neural primitives (NeRF, SDF,
image, volume) built on a shared multiresolution hash encoding and small
bias-free MLPs, with an occupancy-grid ray marcher expressed as masked
fixed-shape compute under jit.
"""

__version__ = "0.1.0"

import os as _os
from pathlib import Path as _Path

import jax as _jax

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it, every process of this checkout shares one fixed directory
# (the path is part of the cache key, so it must not move).
_CACHE_DIR = _Path(__file__).resolve().parent.parent / ".jax_cache"
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", str(_CACHE_DIR))
