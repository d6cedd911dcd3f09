"""Network-config JSON loading.

Reproduces the reference's config plane (ref: src/testbed.cu:120-146
``load_network_config``): commented JSON (tcnn configs use ``//`` and
``/* */`` comments) plus a ``"parent"`` inheritance chain, and the
hash-grid hyperparameter auto-fill of ref src/testbed.cu:2290-2335.
"""
from __future__ import annotations

import copy
import json
import math
import re
from pathlib import Path
from typing import Any


def _strip_json_comments(text: str) -> str:
    """Remove // and /* */ comments outside of string literals."""
    out = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            out.append(c)
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
            continue
        out.append(c)
        i += 1
    s = "".join(out)
    # tolerate trailing commas
    s = re.sub(r",\s*([}\]])", r"\1", s)
    return s


def load_commented_json(path: str | Path) -> dict:
    text = Path(path).read_text()
    return json.loads(_strip_json_comments(text))


def load_network_config(path: str | Path) -> dict:
    """Load a network config, resolving the ``parent`` inheritance chain.

    Children override parents key-by-key at the top level (matching the
    reference's merge, which copies parent keys absent in the child).
    """
    path = Path(path)
    if path.suffix == ".msgpack":
        from ngp_jax.io.snapshot import load_msgpack_config
        return load_msgpack_config(path)
    cfg = load_commented_json(path)
    if "parent" in cfg:
        parent = load_network_config(path.parent / cfg.pop("parent"))
        merged = dict(parent)
        _deep_update(merged, cfg)
        cfg = merged
    return cfg


def _deep_update(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


def autofill_hashgrid_config(
    encoding: dict,
    n_pos_dims: int,
    desired_resolution: float = 2048.0,
    aabb_scale: int = 1,
) -> dict:
    """Auto-derive base_resolution / per_level_scale like the reference.

    ref: src/testbed.cu:2290-2335. ``desired_resolution`` is 2048 for NeRF,
    max(image resolution)/2 for images, world2index_scale for volumes.
    """
    enc = copy.deepcopy(encoding)
    enc["n_pos_dims"] = n_pos_dims
    n_features_per_level = enc.get("n_features_per_level", 2)
    if enc.get("n_features", 0) > 0:
        n_levels = enc["n_features"] // n_features_per_level
    else:
        n_levels = enc.get("n_levels", 16)
    enc["n_levels"] = n_levels
    log2_hashmap_size = enc.get("log2_hashmap_size", 15)
    base_resolution = enc.get("base_resolution", 0)
    if not base_resolution:
        base_resolution = 1 << (log2_hashmap_size // n_pos_dims)
    enc["base_resolution"] = base_resolution
    per_level_scale = enc.get("per_level_scale", 0.0)
    if per_level_scale <= 0.0 and n_levels > 1:
        per_level_scale = math.exp(
            math.log(desired_resolution * float(aabb_scale) / float(base_resolution))
            / (n_levels - 1)
        )
    enc["per_level_scale"] = per_level_scale
    return enc


def default_config_path(mode: str) -> Path:
    root = Path(__file__).resolve().parent.parent / "configs"
    return root / mode / "base.json"


def get(cfg: dict, path: str, default: Any = None) -> Any:
    """dotted-path lookup helper: get(cfg, "optimizer.nested.learning_rate")."""
    cur = cfg
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur
