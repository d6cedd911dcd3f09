"""Scene registry (ref: scripts/scenes.py): known datasets and their
modes/configs, plus mode inference for arbitrary paths."""
from __future__ import annotations

import os
from pathlib import Path

ROOT_DIR = Path(__file__).resolve().parent.parent
REFERENCE_DATA = Path(os.environ.get("NGP_DATA_DIR",
                                     "/root/reference/data"))
CONFIGS_DIR = ROOT_DIR / "configs"

scenes_nerf = {
    "fox": {"data_dir": REFERENCE_DATA / "nerf" / "fox",
            "dataset": "transforms.json"},
    # NeRF-synthetic scenes resolve if the dataset is present locally
    **{name: {"data_dir": REFERENCE_DATA / "nerf_synthetic" / name,
              "dataset_train": "transforms_train.json",
              "dataset_test": "transforms_test.json"}
       for name in ("lego", "drums", "ship", "mic", "ficus", "chair",
                    "hotdog", "materials")},
}

scenes_sdf = {
    "armadillo": {"data_path": REFERENCE_DATA / "sdf" / "armadillo.obj"},
    "bunny": {"data_path": REFERENCE_DATA / "sdf" / "bunny.obj"},
}

scenes_image = {
    "albert": {"data_path": REFERENCE_DATA / "image" / "albert.exr"},
    "einstein": {"data_path": REFERENCE_DATA / "image" / "albert.exr"},
}

scenes_volume = {
    "plume": {"procedural": True},
}


def get_scene(name: str):
    for mode, table in (("nerf", scenes_nerf), ("sdf", scenes_sdf),
                        ("image", scenes_image), ("volume", scenes_volume)):
        if name in table:
            return mode, table[name]
    return None, None


def mode_from_scene(path_or_name: str) -> str:
    mode, _ = get_scene(path_or_name)
    if mode:
        return mode
    from ngp_jax.api.testbed import mode_from_scene as infer
    m = infer(path_or_name)
    return m.value if m else ""


def default_config(mode: str) -> Path:
    return CONFIGS_DIR / mode / "base.json"
