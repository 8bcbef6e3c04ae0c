"""Acceleration structures and intersection kernels.

JAX replacement for lucille's accel layer (src/render/accel.c
vtable, src/render/bvh.c SAH-binned BVH, src/render/ugrid.c — SURVEY.md
section 2.4).  Interchangeable intersectors, mirroring the reference's
``ri_accel_bind(RI_ACCEL_UGRID | RI_ACCEL_BVH)`` (accel.c:70-107); the
scene's ``accel`` tag picks one (accel/dispatch.py lists them):

- ``bruteforce``: dense Moller-Trumbore over every (ray, triangle) pair in
  chunks — regular elementwise work with zero divergence; the correctness
  oracle for every other intersector.  (The reference's grid is a stub —
  ugrid.c:376-385.)
- ``pallas`` / ``pbvh``: Triton-route Pallas kernels — dense tile-culled
  tests for small scenes (accel/pallas_isect.py, pallas_ao.py), packet
  walks over a tile BVH for large ones (accel/pallas_bvh.py).
"""

from lucille_tpu.accel.bvh import BVH, build_bvh
from lucille_tpu.accel.bruteforce import brute_any_hit, brute_closest_hit
from lucille_tpu.accel.dispatch import any_hit, closest_hit

__all__ = [
    "BVH",
    "build_bvh",
    "brute_closest_hit",
    "brute_any_hit",
    "closest_hit",
    "any_hit",
]
