"""RenderMan Interface layer: graphics-state machine and scene description.

JAX replacement for lucille's `src/ri` layer (SURVEY.md section 2.2):
the Ri* API state machine with transform/attribute stacks (context.c:20-53),
options (option.c), the RenderMan camera (camera.c:30-89), shader/material
binding (attribute.c), light sources (lightsource.c), and geometry
conversion drivers (polygon/quadric/subdivision) — everything becomes
world-space triangles, exactly as in the reference, but accumulated into a
host-side `SceneDescription` that the scene compiler flattens into padded
device arrays.
"""

from lucille_tpu.ri.api import RiState
from lucille_tpu.ri.camera import Camera
from lucille_tpu.ri.types import (
    AttributeState,
    DisplayDesc,
    GeomData,
    LightDesc,
    RenderOptions,
    SceneDescription,
)

__all__ = [
    "RiState",
    "Camera",
    "AttributeState",
    "DisplayDesc",
    "GeomData",
    "LightDesc",
    "RenderOptions",
    "SceneDescription",
]
