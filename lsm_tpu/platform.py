"""Where compiled programs are cached, and the check that a GPU is present.

The library itself runs on whatever device JAX picks. The scripts that measure
or smoke-test the device path (``chip_smoke.py``, ``bench.py``) call
:func:`require_gpu` first, so a run without a GPU fails instead of reporting
CPU numbers, and :func:`use_compile_cache` so repeated processes reuse
compilations.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["CACHE_DIR", "use_compile_cache", "require_gpu"]

#: fixed cache location inside the checkout (listed in ``.gitignore``); the
#: path is part of the cache key, so it must not vary between runs
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def use_compile_cache() -> None:
    """Keep JAX's persistent compilation cache in ``JAX_COMPILATION_CACHE_DIR``
    when that is set (JAX reads it itself), else in :data:`CACHE_DIR`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))


def require_gpu():
    """The first device, which must be a GPU; raises ``RuntimeError`` otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"a GPU is required, but JAX's first device is {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev
