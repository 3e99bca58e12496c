"""Persistent compilation cache.

Entry points (``chip_smoke.py``, ``bench.py``, ``demo.py``,
``python -m tame``) call :func:`enable_compile_cache`.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache there
and nothing is changed.  Otherwise the cache goes to one fixed directory
inside the checkout (``.jax_cache/xla``, git-ignored): the path is part
of what makes a later run find the entries, so it never depends on a
temporary directory, a process id or the time.

The CPU backend stays opt-in (``TAME_JAX_CACHE=1``) and host-keyed.
XLA:CPU AOT executables embed the build host's CPU feature set; loading
one on a machine with different features is at best a warning and at
worst a SIGILL/segfault (observed: a `.jax_cache` populated on an
AMX-capable host crashed `backend_compile_and_load` on a non-AMX host
mid-test-suite).  jax's cache key does not include the host features, so
the CPU cache is keyed by DIRECTORY instead: one subdirectory per
CPU-feature fingerprint.
"""

from __future__ import annotations

import hashlib
import os

import jax

_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def host_fingerprint() -> str:
    """Short hash of the host CPU feature flags (stable per machine)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.md5(line.encode()).hexdigest()[:8]
    except OSError:
        pass
    import platform

    return hashlib.md5(platform.processor().encode()).hexdigest()[:8]


def cache_dir() -> str:
    """Per-host persistent CPU cache directory (created on first use)."""
    path = os.path.join(_ROOT, host_fingerprint())
    os.makedirs(path, exist_ok=True)
    return path


def enable_persistent_cache(jax_module) -> str:
    """Point jax's compilation cache at the host-keyed CPU directory.

    OPT-IN via ``TAME_JAX_CACHE=1``: this jax build's XLA:CPU AOT
    serialize/deserialize path segfaults intermittently (observed both in
    ``put_executable_and_time`` on cache write and in
    ``backend_compile_and_load`` on read, plus at interpreter exit), so
    correctness-critical runs — the test suite above all — default to no
    persistent cache.  Set the env var to trade that risk for warm-cache
    speed during interactive development.
    """
    if not os.environ.get("TAME_JAX_CACHE"):
        return ""
    path = cache_dir()
    jax_module.config.update("jax_compilation_cache_dir", path)
    jax_module.config.update("jax_persistent_cache_min_compile_time_secs",
                             1.0)
    return path


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` where set, else the checkout's fixed
    ``.jax_cache/xla``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_ROOT, "xla"))


def enable_compile_cache() -> str:
    """Turn the persistent cache on for an entry point; returns the
    directory in use ("" where it stays off: the CPU backend without
    ``TAME_JAX_CACHE=1``)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return compile_cache_dir()      # JAX reads the variable itself
    if jax.default_backend() == "cpu":
        return enable_persistent_cache(jax)
    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
