"""Model composition.

- ``EncodedNetwork``: encoding → MLP, the tcnn NetworkWithInputEncoding
  equivalent used by the image/sdf/volume engines.
- ``NerfNetwork``: the two-MLP NeRF composition of the reference
  (ref: include/neural-graphics-primitives/nerf_network.h:77-548):
  pos → hash encoding → density MLP (16 outputs, [0] = raw density);
  [density MLP outputs ⊕ dir encoding ⊕ extra dims] → RGB MLP → 3 outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from ngp_jax.common import NerfActivation, network_activation
from ngp_jax.nn.encodings import create_encoding
from ngp_jax.nn.mlp import MLP


class EncodedNetwork:
    """encoding(x) → MLP. Params: {"encoding": ..., "net": (...)}"""

    def __init__(self, n_input_dims: int, n_output_dims: int,
                 encoding_cfg: dict, network_cfg: dict):
        self.encoding = create_encoding(n_input_dims, encoding_cfg)
        self.net = MLP.from_config(self.encoding.n_output_dims, n_output_dims,
                                   network_cfg)
        self.n_input_dims = n_input_dims
        self.n_output_dims = n_output_dims

    def init_params(self, key):
        k1, k2 = jax.random.split(key)
        return {"encoding": self.encoding.init_params(k1),
                "net": self.net.init_params(k2)}

    def matrix_mask(self, params):
        """True for MLP weight matrices (L2-regularized), False for the
        encoding table (ref: optimize_matrix_params split, testbed.cu:2556)."""
        return {"encoding": jax.tree.map(lambda _: False, params["encoding"]),
                "net": jax.tree.map(lambda _: True, params["net"])}

    def apply(self, params, x, max_level=None):
        feat = self.encoding.apply(params["encoding"], x, max_level=max_level)
        return self.net.apply(params["net"], feat)


# Width of the density MLP output (1 density + 15 latent features fed to the
# RGB head) — matches the reference's padded 16-wide geometry feature vector.
DENSITY_MLP_OUT = 16


class NerfNetwork:
    """Density + RGB composition with directional encoding.

    apply() consumes *warped* inputs: positions in [0,1]^3 (AABB-relative)
    and directions warped to [0,1]^3 ((d+1)/2), like the reference network
    (ref: warp_position/warp_direction, src/testbed_nerf.cu:267-305).
    """

    def __init__(self, config: dict, n_extra_dims: int = 0):
        self.n_extra_dims = n_extra_dims
        enc_cfg = config["encoding"]
        self.pos_encoding = create_encoding(3, enc_cfg)
        self.dir_encoding = create_encoding(3 + n_extra_dims,
                                            config.get("dir_encoding",
                                                       {"otype": "SphericalHarmonics",
                                                        "degree": 4}))
        self.density_net = MLP.from_config(
            self.pos_encoding.n_output_dims, DENSITY_MLP_OUT, config["network"])
        rgb_in = self.dir_encoding.n_output_dims + DENSITY_MLP_OUT
        self.rgb_net = MLP.from_config(rgb_in, 3, config.get("rgb_network",
                                                             config["network"]))
        self.rgb_activation = NerfActivation.LOGISTIC
        self.density_activation = NerfActivation.EXPONENTIAL

    def init_params(self, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return {
            "pos_encoding": self.pos_encoding.init_params(k1),
            "dir_encoding": self.dir_encoding.init_params(k2),
            "density_net": self.density_net.init_params(k3),
            "rgb_net": self.rgb_net.init_params(k4),
        }

    def matrix_mask(self, params):
        return {
            "pos_encoding": jax.tree.map(lambda _: False, params["pos_encoding"]),
            "dir_encoding": jax.tree.map(lambda _: False, params["dir_encoding"]),
            "density_net": jax.tree.map(lambda _: True, params["density_net"]),
            "rgb_net": jax.tree.map(lambda _: True, params["rgb_net"]),
        }

    def density_raw(self, params, pos01, max_level=None):
        """Raw (pre-activation) density MLP output, (N, 16)."""
        feat = self.pos_encoding.apply(params["pos_encoding"], pos01,
                                       max_level=max_level)
        return self.density_net.apply(params["density_net"], feat)

    def density(self, params, pos01, max_level=None):
        """Activated density σ, (N,). ref: network_to_density (Exponential)."""
        raw = self.density_raw(params, pos01, max_level=max_level)
        return network_activation(raw[..., 0], self.density_activation)

    def apply(self, params, pos01, dir01, extra=None, max_level=None):
        """Full forward: returns (rgb_raw (N,3), density_raw (N,)) —
        pre-activation, matching the reference network's 4-channel output."""
        h = self.density_raw(params, pos01, max_level=max_level)
        din = dir01 if extra is None else jnp.concatenate([dir01, extra], -1)
        dfeat = self.dir_encoding.apply(params["dir_encoding"], din)
        rgb_in = jnp.concatenate([h.astype(jnp.float32),
                                  dfeat.astype(jnp.float32)], axis=-1)
        rgb_raw = self.rgb_net.apply(params["rgb_net"], rgb_in)
        return rgb_raw, h[..., 0]

    def rgb_sigma(self, params, pos01, dir01, extra=None, max_level=None):
        """Activated (rgb, σ)."""
        rgb_raw, d_raw = self.apply(params, pos01, dir01, extra, max_level)
        rgb = network_activation(rgb_raw, self.rgb_activation)
        sigma = network_activation(d_raw, self.density_activation)
        return rgb, sigma
