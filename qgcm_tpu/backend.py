"""Where the program runs: the one module that asks JAX which backend
is in use, picks the stepped-field dtype for it, and keeps the
persistent compilation cache.

Supported backends are the CPU (tests, float64 parity with the
double-precision Fortran reference) and an NVIDIA GPU (production).
"""

from __future__ import annotations

import os

import jax

# Root of the checkout this package was imported from.
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def platform() -> str:
    """The default backend's platform name: 'cpu' or 'gpu'."""
    return jax.default_backend()


def default_dtype() -> str:
    """Stepped-field dtype when the user names none: float64 on the CPU
    (parity with the reference), float32 on an accelerator, for
    throughput. float64 runs on the GPU too; ask for it explicitly."""
    return "float64" if platform() == "cpu" else "float32"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory: $JAX_COMPILATION_CACHE_DIR when set (code sets no other),
    else a directory the program already configured, else the fixed
    path <checkout>/.jax_cache. Never a temporary or per-process path:
    a later run finds only what was cached where it looks."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    path = env or jax.config.jax_compilation_cache_dir \
        or os.path.join(CHECKOUT, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
