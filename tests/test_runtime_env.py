"""Process-level contracts: where compiled programs are cached, that the
GPU smoke script refuses to run without a GPU, and that the NeRF main path
imports without the optional PIL and msgpack packages."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(code, env_extra=None, drop=(), cwd=ROOT, args=None):
    env = {k: v for k, v in os.environ.items()
           if k not in drop and not k.startswith("PYTEST")}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT),
                **(env_extra or {})})
    cmd = [sys.executable] + (args if args is not None else ["-c", code])
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=300)


def test_compilation_cache_defaults_to_checkout():
    r = _run("import jax, ngp_jax; "
             "print(jax.config.jax_compilation_cache_dir)",
             drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == str(ROOT / ".jax_cache")


def test_compilation_cache_honors_env(tmp_path):
    cache = tmp_path / "cache"
    code = ("import jax, jax.numpy as jnp, ngp_jax; "
            "print(jax.config.jax_compilation_cache_dir); "
            "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((64, 64)))"
            ".block_until_ready()")
    r = _run(code, env_extra={
        "JAX_COMPILATION_CACHE_DIR": str(cache),
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "script_alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    r = _run(None, args=[str(script)], cwd=cwd,
             env_extra={"PYTHONPATH": ""} if alone else None)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("module", ["ngp_jax.train.nerf",
                                    "ngp_jax.render.nerf_render"])
def test_nerf_path_imports_without_pil_and_msgpack(module):
    code = ("import sys; sys.modules['PIL'] = None; "
            "sys.modules['msgpack'] = None; "
            f"import {module}; print('imported')")
    r = _run(code)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("imported")
