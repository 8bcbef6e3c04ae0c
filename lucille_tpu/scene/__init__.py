"""Scene compilation: host SceneDescription → padded device SoA arrays.

JAX replacement for lucille's scene layer (src/render/scene.c:
geom list + light list + accel build at ri_scene_setup, scene.c:85-98).
Instead of linked lists of ri_geom_t, the whole scene is flattened once
into statically-shaped float32 structure-of-arrays buffers (triangles,
per-corner shading attributes, material/light tables, BVH nodes) that
upload to HBM and feed Pallas/XLA kernels without host round-trips.
"""

from lucille_tpu.scene.compile import compile_scene
from lucille_tpu.scene.types import SceneArrays

__all__ = ["SceneArrays", "compile_scene"]
