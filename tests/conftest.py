"""Test harness config: the CPU with an 8-device virtual mesh unless
JAX_PLATFORMS says otherwise (card-only tests, marked `gpu`, run with
JAX_PLATFORMS=cuda on the GPU), x64 so DP parity tests run anywhere, and
the repo's compile cache. Must run before any jax computation."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from mdbench_tpu.backend import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# persistent compilation cache: repeat test runs pay jit compile once
# ($JAX_COMPILATION_CACHE_DIR if set, else <repo>/.jax_cache)
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
