"""Test harness config: force an 8-device virtual CPU mesh so sharding paths
run in CI without accelerators (SURVEY.md §4 item 5)."""

import os

# Override any ambient platform selection (e.g. a local GPU): tests run on a
# deterministic 8-device virtual CPU mesh.  jax may already be imported by a
# pytest plugin, so set the config directly as well as the env.  The
# persistent compilation cache stays off (the CLI entry point would
# otherwise place one for every test process and child).
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
