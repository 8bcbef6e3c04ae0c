"""Sampling: quasi-Monte-Carlo sequences and PRNG key discipline.

JAX replacement for lucille's sampling stack:

- src/render/qmc.c — Halton, Faure permutations, generalized scrambled
  Halton/Hammersley, Fibonacci lattice  → `lucille_tpu.sampling.qmc`
- src/render/render.c:830-917 — Keller sigma-permuted two-dimensional
  Hammersley subpixel sampling          → `lucille_tpu.sampling.hammersley`
- src/render/mc.c — Latin hypercube    → `lucille_tpu.sampling.mc`
- src/base/random.c — per-thread MT19937 streams → `lucille_tpu.sampling.rng`
  (threefry keys folded per (pixel, sample, bounce); parity is at the
  distribution level, not the bit level — SURVEY.md "Hard parts")
"""

from lucille_tpu.sampling.hammersley import SigmaTable, subpixel_samples
from lucille_tpu.sampling.qmc import (
    faure_permutations,
    fibonacci_lattice,
    generalized_hammersley,
    halton,
    radical_inverse,
)
from lucille_tpu.sampling.rng import fold_in_many, pixel_key

__all__ = [
    "SigmaTable",
    "subpixel_samples",
    "radical_inverse",
    "halton",
    "faure_permutations",
    "generalized_hammersley",
    "fibonacci_lattice",
    "pixel_key",
    "fold_in_many",
]
