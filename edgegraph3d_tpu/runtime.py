"""Process set-up shared by the command-line entry points.

`start()` is called by the CLI `main()`s, `bench.py` and
`chip_smoke.py` (never on package import).  It

  * refuses to run on the CPU unless the CPU was asked for: when the
    CUDA plugin fails to load, JAX quietly falls back to the CPU, and a
    reconstruction would then run hours on the wrong device without a
    word.  `JAX_PLATFORMS=cpu` is the explicit request;
  * places the persistent compilation cache.  When
    `JAX_COMPILATION_CACHE_DIR` is in the environment JAX already reads
    it (an empty value disables the cache) and nothing is set here.
    Otherwise the cache sits at a fixed path inside the checkout — the
    path is part of the cache key, so it must never move between runs —
    with XLA:CPU entries apart, because they encode the compiling
    host's ISA and loading one built on another host can crash.
"""

from __future__ import annotations

import os

#: the checkout root (the directory holding the package)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class NoAcceleratorError(RuntimeError):
    """JAX found no GPU and the CPU was not requested explicitly."""


def explicit_cpu_request() -> bool:
    """True when the user pinned JAX to the CPU (`JAX_PLATFORMS=cpu`)."""
    return os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"


def require_device() -> str:
    """The JAX platform to run on: "gpu", or "cpu" when asked for.

    Raises NoAcceleratorError on an implicit CPU fallback."""
    import jax

    platform = jax.default_backend()
    if platform == "gpu" or (platform == "cpu" and explicit_cpu_request()):
        return platform
    raise NoAcceleratorError(
        f"no GPU found: JAX's default backend is {platform!r}.  Check "
        "the CUDA plugin, or set JAX_PLATFORMS=cpu to run on the CPU "
        "on purpose.")


def compile_cache_dir(platform: str) -> str | None:
    """Where the persistent compile cache goes, or None when
    `JAX_COMPILATION_CACHE_DIR` already decides it."""
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return None
    name = ".jax_cache_cpu" if platform == "cpu" else ".jax_cache"
    return os.path.join(REPO_ROOT, name)


def start() -> str:
    """Check the device, place the compile cache; returns the platform.

    Call before the first compilation."""
    import jax

    platform = require_device()
    path = compile_cache_dir(platform)
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    return platform


def cli_start() -> str:
    """`start()` for `main()`s: exits with a message instead of a
    traceback when there is no GPU."""
    try:
        return start()
    except NoAcceleratorError as e:
        raise SystemExit(f"error: {e}") from None
