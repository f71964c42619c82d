"""Process set-up shared by the entry points (CLI, bench.py, chip_smoke.py):
the persistent compile cache and the device check."""
from __future__ import annotations

import os

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixed, inside the checkout: the cache key includes the path, so a
# directory that moves between runs never hits
DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".jax_cache")


def init_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory:
    ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself; no
    directory is set here), else ``DEFAULT_CACHE_DIR``."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return env_dir or DEFAULT_CACHE_DIR


def cpu_requested() -> bool:
    """True when the user put JAX on the CPU on purpose (JAX_PLATFORMS=cpu),
    as the tests and CPU rehearsals do."""
    return os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"


def check_device() -> str:
    """Return the default backend's platform; raise SystemExit unless it is
    a GPU or the CPU was asked for explicitly. Nothing falls back to the
    CPU silently."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu" and not (platform == "cpu" and cpu_requested()):
        raise SystemExit(
            f"no GPU found (default backend: {platform}); set "
            "JAX_PLATFORMS=cpu to run on the CPU on purpose"
        )
    return platform
