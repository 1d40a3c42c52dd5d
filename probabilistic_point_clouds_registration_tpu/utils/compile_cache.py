"""Persistent XLA compilation cache, enabled once per process.

The registration programs are static-shape-specialized (padded cloud size,
bucket capacity, class widths, neighbor count), and sequence odometry
re-specializes whenever consecutive scans land in a different size class.
A durable on-disk cache compiles each class once per checkout instead of
once per process.

Where the cache lives:
  * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing else is
    set here.
  * otherwise: ``.jax_cache`` at the root of this checkout (listed in
    .gitignore) — a fixed path, because the path is part of the key, so a
    directory that moves never hits.
  * never on the CPU backend: jax 0.9's XLA:CPU executable serialization
    is unreliable here — full-suite runs died with SIGSEGV inside the
    cache machinery (loading an entry compiled on another host CPU,
    cpu_aot_loader "machine feature ... not supported on the host
    machine", and serializing a freshly compiled program), and CPU
    compiles are seconds.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: utils/ -> package -> checkout root.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_enabled = False


def cache_dir(platform: str) -> Path | None:
    """Directory this module points the cache at on ``platform``: None on
    the CPU or when ``JAX_COMPILATION_CACHE_DIR`` already names one."""
    if platform == "cpu" or os.environ.get(ENV_VAR):
        return None
    return DEFAULT_DIR


def enable_persistent_compilation_cache() -> bool:
    """Idempotently enable the cache for this process (see the module doc).

    Returns True when a cache directory is active after the call.
    """
    global _enabled
    if _enabled:
        return True
    import jax

    if jax.config.jax_compilation_cache_dir:
        _enabled = True
        return True
    path = cache_dir(jax.default_backend())
    if path is None:
        return False
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    _enabled = True
    return True
