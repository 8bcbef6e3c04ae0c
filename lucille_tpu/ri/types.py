"""Host-side scene description data types.

These mirror the reference's core structs at the capability level:
``ri_option_t`` (src/ri/option.h:19-108), ``ri_display_t``
(src/ri/display.h), ``ri_attribute_t`` (src/ri/attribute.c),
``ri_geom_t`` flat vertex arrays (src/render/geom.h:28-65) and
``ri_light_t`` (src/render/light.h:34-62).  Everything is plain NumPy on
the host; `lucille_tpu.scene.compile` turns a SceneDescription into
padded float32 device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

# Accel methods (reference accel.h / option.c:116 — default BVH; the
# reference's "grid" intersect is a stub, ugrid.c:376-385, so our second
# method is the dense brute-force intersector, which doubles as the
# correctness oracle).
ACCEL_BVH = "bvh"
ACCEL_BRUTEFORCE = "bruteforce"
ACCEL_MXU = "mxu"  # dense matmul intersector (accel/mxu.py)
ACCEL_AUTO = "auto"  # base/backend.choose_accel decides
ACCEL_GRID = "grid"  # accepted for RIB compatibility; maps to bruteforce


@dataclass
class DisplayDesc:
    """One RIB Display line (multiple lines with "+name" append —
    reference src/ri/display.c:239, tests/ribparse/multiple_display_20081119.rib)."""

    name: str = "untitled.hdr"
    driver: str = "framebuffer"
    mode: str = "rgb"
    params: dict = field(default_factory=dict)
    # PixelSamples lives per-display in the reference (display.h sampling_rates)
    sampling_rates: tuple = (2.0, 2.0)


@dataclass
class RenderOptions:
    """Render options (reference ri_option_t, defaults option.c:80-150)."""

    # image
    width: int = 640
    height: int = 480
    frame_aspect_ratio: float = 4.0 / 3.0
    crop_window: tuple = (0.0, 1.0, 0.0, 1.0)
    displays: list = field(default_factory=list)

    # camera-ish options owned by the option block in the reference
    orientation: str = "lh"  # RI_LH default; RIB "Orientation" overrides
    # ray tracing
    max_ray_depth: int = 8
    gather_nsamples: int = 64  # AO/final-gather rays (option.c:148)
    narealight_rays: int = 16
    # default 'auto': base/backend.choose_accel picks per platform and
    # triangle count (dense kernels below a budget, the BVH above it).
    # RIB Option "raytrace" "accel_method" forces one
    # (reference default is BVH, option.c:116 — honored when requested).
    accel_method: str = ACCEL_AUTO
    # lighting switches (option.c:111-118)
    enable_direct_lighting: bool = True
    enable_indirect_lighting: bool = False
    enable_caustics_lighting: bool = False
    # sampler
    use_qmc: bool = False
    render_method: str = "mcraytrace"  # | "pathtrace" | "whitted" | "ao"
    # pixel filter (option.h:96-99)
    pixel_filter: str = "box"
    pixel_filter_width: tuple = (2.0, 2.0)
    # misc
    nthreads: int = 0  # unused (no host threads); kept for CLI compatibility
    bgcolor: tuple = (0.0, 0.0, 0.0)
    searchpaths: list = field(default_factory=lambda: ["."])
    # ad-hoc implementation-specific KV store (option.h:131-134)
    impl: dict = field(default_factory=dict)
    # frame-level imager shader (RiImager; executed as a film post-pass)
    imager: Optional[str] = None
    imager_params: dict = field(default_factory=dict)
    # additions over the reference
    tile_size: int = 64
    bucket_order: str = "spiral"  # spiral | scanline | zorder | hilbert

    def current_display(self) -> DisplayDesc:
        if not self.displays:
            self.displays.append(DisplayDesc())
        return self.displays[-1]


@dataclass
class MaterialDesc:
    """Fixed-pipeline material (reference ri_material_t): kd/ks + texture."""

    kd: float = 1.0
    ks: float = 0.0
    kt: float = 0.0
    ior: float = 1.0
    roughness: float = 0.1  # plastic.sl's default highlight roughness
    fresnel: bool = False
    texture: Optional[str] = None


@dataclass
class AttributeState:
    """One entry of the attribute stack (reference attribute.c:283-337)."""

    surface: Optional[str] = None
    surface_params: dict = field(default_factory=dict)
    displacement: Optional[str] = None
    displacement_params: dict = field(default_factory=dict)
    atmosphere: Optional[str] = None
    atmosphere_params: dict = field(default_factory=dict)
    material: MaterialDesc = field(default_factory=MaterialDesc)
    sides: int = 1
    color: tuple = (1.0, 1.0, 1.0)
    opacity: tuple = (1.0, 1.0, 1.0)
    shading_rate: float = 1.0
    shading_interpolation: str = "constant"
    area_light_index: int = -1  # bound AreaLightSource, if any

    def copy(self) -> "AttributeState":
        import copy as _c

        return _c.deepcopy(self)


@dataclass
class GeomData:
    """Triangulated geometry in WORLD space (reference ri_geom_t).

    positions: (V, 3) float64; indices: (F, 3) int32 (already fanned);
    optional per-vertex normals/st.  The attribute snapshot taken at
    creation time rides along, as the reference copies attr->shader /
    attr->material onto each geom.
    """

    positions: np.ndarray
    indices: np.ndarray
    normals: Optional[np.ndarray] = None
    st: Optional[np.ndarray] = None
    facevarying_st: Optional[np.ndarray] = None  # (F, 3, 2) per-corner st
    colors: Optional[np.ndarray] = None
    attrs: AttributeState = field(default_factory=AttributeState)
    kind: str = "polygon"  # polygon | sphere | subdiv

    @property
    def ntriangles(self) -> int:
        return int(self.indices.shape[0])


@dataclass
class LightDesc:
    """A light (reference ri_light_t, light.h:34-62)."""

    type: str = "dome"  # dome | distant | point | area | ibl | sunsky | sun
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, -1.0, 0.0]))
    color: np.ndarray = field(default_factory=lambda: np.ones(3))
    intensity: float = 1.0
    geom_index: int = -1  # area light geometry
    texture: Optional[str] = None  # IBL map path
    mapping: Optional[str] = None  # "angular" | "latlong" | None = by aspect
    ibl_sampler: str = "cosweight"
    sis_file: Optional[str] = None
    sunsky: Optional[Any] = None  # PreethamSunSky params


@dataclass
class SceneDescription:
    """Everything the RIB produced, ready for scene compilation."""

    geoms: list = field(default_factory=list)  # list[GeomData]
    lights: list = field(default_factory=list)  # list[LightDesc]
    options: RenderOptions = field(default_factory=RenderOptions)
    camera: Any = None  # lucille_tpu.ri.camera.Camera
    world_to_camera: np.ndarray = field(default_factory=lambda: np.eye(4))

    @property
    def ntriangles(self) -> int:
        return sum(g.ntriangles for g in self.geoms)
