"""Bias-free MLP matching tiny-cuda-nn's FullyFusedMLP/CutlassMLP semantics.

tcnn MLPs have NO bias terms; hidden width is 16/32/64/128 and activations
are applied per hidden layer (ref: configs/*/base.json use 64-wide ReLU).
We compute in bfloat16 with fp32 accumulation (preferred_element_type)
and keep master weights in fp32; XLA hands the matmuls to the tensor
cores.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp


def _activation(x, name: str):
    name = name.lower()
    if name == "none":
        return x
    if name == "relu":
        return jnp.maximum(x, 0.0)
    if name == "leakyrelu":
        return jnp.where(x > 0, x, 0.01 * x)
    if name == "exponential":
        return jnp.exp(x)
    if name == "sigmoid" or name == "logistic":
        return jax.nn.sigmoid(x)
    if name == "sine":
        return jnp.sin(x)
    if name == "squareplus":
        return 0.5 * (x + jnp.sqrt(x * x + 4.0))
    if name == "softplus":
        return jax.nn.softplus(x)
    if name == "tanh":
        return jnp.tanh(x)
    raise ValueError(f"unknown activation {name!r}")


@dataclasses.dataclass(frozen=True)
class MLP:
    """Static MLP spec. Params are a tuple of fp32 weight matrices
    (in_features, out_features); apply() casts to bf16 for the tensor cores."""

    n_input_dims: int
    n_output_dims: int
    n_neurons: int = 64
    n_hidden_layers: int = 1
    activation: str = "ReLU"
    output_activation: str = "None"
    compute_dtype: object = jnp.bfloat16

    @property
    def layer_shapes(self) -> Sequence[tuple[int, int]]:
        if self.n_hidden_layers == 0:
            return [(self.n_input_dims, self.n_output_dims)]
        shapes = [(self.n_input_dims, self.n_neurons)]
        for _ in range(self.n_hidden_layers - 1):
            shapes.append((self.n_neurons, self.n_neurons))
        shapes.append((self.n_neurons, self.n_output_dims))
        return shapes

    def init_params(self, key: jax.Array):
        """Xavier/Glorot-uniform init (tcnn's default for MLP layers)."""
        params = []
        for shape in self.layer_shapes:
            key, sub = jax.random.split(key)
            fan_in, fan_out = shape
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            params.append(jax.random.uniform(
                sub, shape, jnp.float32, minval=-limit, maxval=limit))
        return tuple(params)

    def apply(self, params, x):
        cdt = self.compute_dtype
        h = x.astype(cdt)
        n = len(params)
        for i, w in enumerate(params):
            h = jnp.dot(h, w.astype(cdt), preferred_element_type=jnp.float32)
            if i < n - 1:
                h = _activation(h, self.activation).astype(cdt)
        out = _activation(h, self.output_activation)
        return out

    @classmethod
    def from_config(cls, n_input_dims: int, n_output_dims: int, cfg: dict) -> "MLP":
        return cls(
            n_input_dims=n_input_dims,
            n_output_dims=n_output_dims,
            n_neurons=int(cfg.get("n_neurons", 64)),
            n_hidden_layers=int(cfg.get("n_hidden_layers", 1)),
            activation=str(cfg.get("activation", "ReLU")),
            output_activation=str(cfg.get("output_activation", "None")),
        )
