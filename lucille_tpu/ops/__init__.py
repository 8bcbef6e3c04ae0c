"""Math ops: vectors, matrices, colorimetry, noise.

JAX replacement for lucille's math substrate (src/base/vector.h,
matrix.c, quaternion.c; src/render/spectrum.c, specrend.c, noise.c).

Device math is float32 SoA — arrays of shape (..., 3) — instead of the
reference's ``double[4]`` AoS vectors (vector.h:61); the precision loss is
handled with scene-relative epsilons rather than doubles (SURVEY.md "Hard
parts").  Host-side scene-graph math (4x4 matrix stacks) runs in float64
NumPy and is downcast at device upload.
"""

from lucille_tpu.ops.vecmat import (
    cross,
    dot,
    length,
    mat4_from_rib,
    mat4_identity,
    mat4_inverse,
    mat4_mul,
    mat4_rotate,
    mat4_scale,
    mat4_translate,
    normalize,
    transform_normal,
    transform_point,
    transform_vector,
)

__all__ = [
    "cross",
    "dot",
    "length",
    "normalize",
    "mat4_identity",
    "mat4_inverse",
    "mat4_mul",
    "mat4_translate",
    "mat4_scale",
    "mat4_rotate",
    "mat4_from_rib",
    "transform_point",
    "transform_vector",
    "transform_normal",
]
