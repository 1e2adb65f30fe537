"""JAX's persistent compilation cache for every helm_tpu entry point.

Compiling a PBS program takes seconds to minutes per batch shape. JAX's
persistent cache stores the compiled executables, so repeat runs of the
CLI, the serving daemon and the benchmarks skip compilation.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no other path. Otherwise the cache lives at `<repo>/.jax_cache`:
a fixed path, because the path is part of the cache's key.
`HELM_TPU_COMPILE_CACHE=""` turns the cache off (the test suite does).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    Returns the cache directory in effect, or None when
    HELM_TPU_COMPILE_CACHE="" turns it off."""
    import jax

    if os.environ.get("HELM_TPU_COMPILE_CACHE") == "":
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    outside = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if outside:
        return outside
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
