"""PRNG key discipline: counter-based streams per (pixel, sample, bounce).

The reference uses per-thread MT19937 streams (src/base/random.c:211,
`randomMT2(thread_id)`) to avoid contention and false sharing.  The
device-side equivalent is JAX's counter-based threefry: a key folded over
logical coordinates gives every pixel/sample/bounce an independent,
reproducible stream with no cross-device coordination — the same property
the per-thread streams buy on CPU, but deterministic regardless of
device count or tile assignment.
"""

from __future__ import annotations

import jax


def pixel_key(base_key, x, y, frame: int = 0):
    """Derive a per-pixel key from integer raster coordinates."""
    k = jax.random.fold_in(base_key, frame)
    k = jax.random.fold_in(k, x)
    return jax.random.fold_in(k, y)


def fold_in_many(key, *data):
    """Fold several integers into a key (pixel, subsample, bounce, ...)."""
    for d in data:
        key = jax.random.fold_in(key, d)
    return key
