"""Compile-cache placement and the no-GPU exits of the device scripts.

Each case runs in a child process: the persistent cache is configured once
per process, before its first compile, and the test process has compiled
long before."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, os, sys
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from jsplayer_tpu.utils.compile_cache import setup_compile_cache
path = setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(7.0)).block_until_ready()
print(json.dumps({"path": path,
                  "config": jax.config.jax_compilation_cache_dir}))
"""


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "JAX_ENABLE_COMPILATION_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _probe(env):
    import json

    r = subprocess.run([sys.executable, "-c", _PROBE, REPO], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cache_lands_in_env_dir(tmp_path):
    rec = _probe(_child_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)))
    assert rec["path"] == rec["config"] == str(tmp_path)
    assert any(tmp_path.iterdir()), "no cache entry written"


def test_cache_defaults_to_repo_dir():
    from jsplayer_tpu.utils.compile_cache import DEFAULT_DIR

    # the cache is switched off in the child: this checks where it would
    # go without writing into the checkout
    rec = _probe(_child_env(JAX_ENABLE_COMPILATION_CACHE="false"))
    assert rec["path"] == rec["config"] == DEFAULT_DIR
    assert DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_device_scripts_exit_nonzero_without_gpu(script):
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       env=_child_env(), cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "{" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied into a directory without the package fails."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=_child_env(),
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
