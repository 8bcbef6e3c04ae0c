"""The one place that knows which machine the renderer runs on.

Four decisions live here, and nowhere else:

- the platform: ``"cpu"`` (the test suite) or ``"gpu"``; anything else is
  an error, not a silent fallback;
- interpret mode for the Pallas kernels: on the CPU only, where there is
  no compiler for them;
- the persistent compile cache: ``JAX_COMPILATION_CACHE_DIR`` when it is
  set, else a fixed directory inside the checkout;
- the accelerator a scene gets when its RIB asks for ``auto`` or ``bvh``.

``JAX_PLATFORMS`` is honoured by JAX itself.
"""

from __future__ import annotations

import os
from pathlib import Path

SUPPORTED_PLATFORMS = ("cpu", "gpu")

# In-checkout compile cache used when JAX_COMPILATION_CACHE_DIR is unset.
# A fixed path: the cache only hits when the directory stays put.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

# Triangle counts up to this use the dense kernels (every ray against
# every tile, tile-AABB culled); above it, the tile BVH.  Untuned on the
# card: the AO scene (~2k triangles) and the 130k heightfield are the
# cells on either side of it.
AUTO_DENSE_MAX_TRIS = 16384


def platform() -> str:
    """The default backend's platform; raises on anything but cpu/gpu."""
    import jax

    p = jax.default_backend()
    if p not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: lucille_tpu runs on "
            f"{' or '.join(SUPPORTED_PLATFORMS)}"
        )
    return p


def interpret() -> bool:
    """Pallas interpret mode: true on the CPU only.  On the GPU every
    kernel is compiled through Triton, never interpreted."""
    return platform() == "cpu"


def compile_cache_dir() -> str:
    """Where compiled executables persist between processes."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def enable_compile_cache() -> str | None:
    """Point JAX's persistent cache at compile_cache_dir() on the GPU.

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads it and nothing
    else is set here.  The CPU test suite keeps no cache.  Returns the
    directory in use, or None."""
    if platform() == "cpu":
        return None
    cache = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", cache)
    return cache


def choose_accel(accel_method: str, n_tris: int) -> str:
    """Map a RIB accel_method to the accelerator tag the scene compiles to.

    ``auto`` on the CPU keeps the XLA matmul path (the test mesh); on the
    GPU it takes the Triton kernels: dense up to AUTO_DENSE_MAX_TRIS,
    the tile-BVH packet walk above.  ``bvh`` always means the tile BVH
    ("pbvh"); ``grid`` the uniform grid."""
    if accel_method == "auto":
        if platform() == "cpu":
            return "mxu"
        return "pallas" if n_tris <= AUTO_DENSE_MAX_TRIS else "pbvh"
    if accel_method in ("bvh", "pbvh"):
        return "pbvh"
    if accel_method in ("grid", "ugrid"):
        return "ugrid"
    if accel_method in ("mxu", "pallas"):
        return accel_method
    return "bruteforce"
