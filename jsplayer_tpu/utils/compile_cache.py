"""Placement of JAX's persistent compilation cache.

Every entry point that compiles the device programs (the CLI, bench.py,
chip_smoke.py) calls :func:`setup_compile_cache` before its first compile,
so a second run on the same machine reuses the compiled scans instead of
rebuilding them.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads the variable itself and this
  module changes nothing.
* Otherwise the cache lives at ``<repo>/.jax_cache`` — a fixed path (the
  path is part of what makes a later run find the entries), listed in
  ``.gitignore``.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Point the persistent compilation cache at its directory → the path.
    Call before the first jit compile of the process."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
