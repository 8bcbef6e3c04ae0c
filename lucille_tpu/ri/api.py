"""The RenderMan Interface state machine.

JAX equivalent of lucille's `src/ri` graphics-state context
(context.c:20-53): transform and attribute stacks, options, camera state,
display lists, declares, light sources, geometry conversion — driven either
by the RIB parser (`lucille_tpu.rib.parser`) or programmatically as a
Python Ri API.

Differences from the reference, by design:
- ``WorldEnd`` does NOT fire the renderer directly (reference
  context.c:161-180 calls ri_render_frame there); it finalizes the
  SceneDescription and invokes an optional ``world_end_cb`` so callers
  (CLI, tests, notebooks) decide what to do with the scene.  The backdoor
  callback mechanism (backdoor.h:14-16) is preserved as plain callables.
- geometry is accumulated as host NumPy arrays, not linked lists; the
  scene compiler does the device upload.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from lucille_tpu.base.log import LOG_WARN, log
from lucille_tpu.ops import vecmat as vm
from lucille_tpu.ri import polygon as _polygon
from lucille_tpu.ri import quadric as _quadric
from lucille_tpu.ri import subdivision as _subdivision
from lucille_tpu.ri.camera import ORTHOGRAPHIC, PERSPECTIVE, Camera
from lucille_tpu.ri.types import (
    AttributeState,
    DisplayDesc,
    LightDesc,
    RenderOptions,
    SceneDescription,
)

MAX_UNKNOWN_COMMANDS = 30  # reference parserib.y:41-42


def _str1(val) -> str:
    """First element of a string-valued RIB parameter."""
    return str(val[0] if isinstance(val, (list, tuple, np.ndarray)) else val)


class TooManyUnknownCommands(RuntimeError):
    pass


@dataclass
class RiState:
    """Graphics-state context (reference ri_context_t, context.c:20-53)."""

    options: RenderOptions = field(default_factory=RenderOptions)
    camera: Camera = field(default_factory=Camera)
    scene: SceneDescription = field(default_factory=SceneDescription)

    trans_stack: list = field(default_factory=lambda: [vm.mat4_identity()])
    attr_stack: list = field(default_factory=lambda: [AttributeState()])
    world_to_camera: np.ndarray = field(default_factory=vm.mat4_identity)
    world_block: int = 0
    declares: dict = field(default_factory=dict)
    nunknown: int = 0

    # backdoor callbacks (reference backdoor.h:14-16, main.c:162,213-241)
    world_begin_cb: Optional[Callable] = None
    world_end_cb: Optional[Callable] = None
    render_end_cb: Optional[Callable] = None

    def __post_init__(self):
        self.scene.options = self.options
        self.scene.camera = self.camera

    # ------------------------------------------------------------------
    # transform stack
    # ------------------------------------------------------------------

    @property
    def ctm(self) -> np.ndarray:
        return self.trans_stack[-1]

    @ctm.setter
    def ctm(self, m: np.ndarray) -> None:
        self.trans_stack[-1] = m

    def Identity(self):
        self.ctm = vm.mat4_identity()

    def Transform(self, values):
        self.ctm = vm.mat4_from_rib(values)

    def ConcatTransform(self, values):
        # CTM = M @ CTM: new transform applies first (ri/transform.c:54-66)
        self.ctm = vm.mat4_mul(vm.mat4_from_rib(values), self.ctm)

    def Translate(self, dx, dy, dz):
        self.ctm = vm.mat4_mul(vm.mat4_translate(dx, dy, dz), self.ctm)

    def Rotate(self, angle, ax, ay, az):
        self.ctm = vm.mat4_mul(vm.mat4_rotate(angle, ax, ay, az), self.ctm)

    def Scale(self, sx, sy, sz):
        self.ctm = vm.mat4_mul(vm.mat4_scale(sx, sy, sz), self.ctm)

    def Perspective(self, fov):
        # rarely used; the reference routes fov via Projection
        self.camera.fov = float(fov)

    def TransformBegin(self):
        self.trans_stack.append(self.ctm.copy())

    def TransformEnd(self):
        if len(self.trans_stack) > 1:
            self.trans_stack.pop()
        else:
            log(LOG_WARN, "TransformEnd without TransformBegin")

    def CoordinateSystem(self, name):
        self.declares.setdefault("__coordsys__", {})[name] = self.ctm.copy()

    # ------------------------------------------------------------------
    # attribute stack
    # ------------------------------------------------------------------

    @property
    def attrs(self) -> AttributeState:
        return self.attr_stack[-1]

    def AttributeBegin(self):
        self.attr_stack.append(self.attrs.copy())
        self.TransformBegin()  # RI spec: AttributeBegin saves the CTM too

    def AttributeEnd(self):
        if len(self.attr_stack) > 1:
            self.attr_stack.pop()
            self.TransformEnd()
        else:
            log(LOG_WARN, "AttributeEnd without AttributeBegin")

    def Attribute(self, name, params):
        self.declares.setdefault("__attributes__", {}).setdefault(name, {}).update(
            params
        )

    def Color(self, rgb):
        self.attrs.color = tuple(float(c) for c in np.asarray(rgb).reshape(-1)[:3])

    def Opacity(self, rgb):
        self.attrs.opacity = tuple(float(c) for c in np.asarray(rgb).reshape(-1)[:3])

    def Sides(self, n):
        self.attrs.sides = int(n)

    def ShadingRate(self, rate):
        self.attrs.shading_rate = float(rate)

    def ShadingInterpolation(self, mode):
        self.attrs.shading_interpolation = str(mode)

    def Surface(self, name, params):
        """Bind a surface shader (reference ri_api_surface, attribute.c:283).

        The reference dlopens ``name.so``; we record the shader name and its
        parameter overrides — shading resolves them to JAX shader functions
        at scene-compile time (the jit *is* the shader JIT).
        """
        a = self.attrs
        a.surface = str(name)
        a.surface_params = dict(params)
        # fixed-pipeline material hints (attribute.c fallback w/ texture)
        m = a.material
        for key, val in params.items():
            base = key.split()[-1]  # strip inline declarations
            arr = np.asarray(val).reshape(-1)
            if base == "Kd" and arr.size:
                m.kd = float(arr[0])
            elif base == "Ks" and arr.size:
                m.ks = float(arr[0])
            elif base == "Kt" and arr.size:
                m.kt = float(arr[0])
            elif base == "roughness" and arr.size:
                m.roughness = float(arr[0])
            elif base in ("texturename", "texture") and arr.size:
                m.texture = str(arr[0]) if str(arr[0]) else None

    def Displacement(self, name, params):
        """Bind a displacement shader (render/shader.h ABI scope).

        Executed over the geometry's vertices at scene-compile time
        (shading/pipeline.py) — the ray tracer's analog of REYES
        dice-time displacement; normals are rebuilt from the displaced
        mesh."""
        self.attrs.displacement = str(name)
        self.attrs.displacement_params = dict(params)

    def Atmosphere(self, name, params):
        """Bind a volume/atmosphere shader, run per eye ray at shading
        (Ci fogged by ray length; shading/pipeline.py)."""
        self.attrs.atmosphere = str(name)
        self.attrs.atmosphere_params = dict(params)

    def Imager(self, name, params):
        """Bind the frame imager shader, run as a film post-pass over the
        assembled frame (shading/pipeline.py)."""
        self.options.imager = str(name)
        self.options.imager_params = dict(params)

    # ------------------------------------------------------------------
    # lights
    # ------------------------------------------------------------------

    def _orientation_is_rh(self) -> bool:
        return self.options.orientation == "rh"

    def LightSource(self, name, params) -> int:
        """ri_api_light_source (lightsource.c:30-104)."""
        light = LightDesc()
        if name == "domelight":
            light.type = "dome"
        elif name == "distantlight":
            light.type = "distant"
        elif name == "pointlight":
            light.type = "point"
        elif name == "ibl":
            light.type = "ibl"
        else:
            light.type = "dome"
        rh = self._orientation_is_rh()
        om = vm.mat4_mul(self.ctm, _ori(rh))
        c2w = vm.mat4_inverse(self.world_to_camera)
        o2c = vm.mat4_mul(c2w, om)  # sic: reference lightsource.c:75
        for key, val in params.items():
            base = key.split()[-1]
            try:
                arr = np.asarray(val, dtype=np.float64).reshape(-1)
            except (ValueError, TypeError):
                arr = None  # string-valued token
            if base == "from":
                light.position = vm.transform_point(arr[:3], o2c)
            elif base == "to":
                to = vm.transform_point(arr[:3], o2c)
                light.direction = vm.normalize(to - light.position)
            elif base == "intensity":
                light.intensity = float(arr[0])
            elif base == "lightcolor":
                light.color = arr[:3].copy()
            elif base in ("texturename", "texture", "filename"):
                light.texture = str(val[0] if isinstance(val, (list, tuple)) else val)
            elif base == "mapping":
                light.mapping = _str1(val)
            elif base == "sampling":
                # sampler-selection tokens (lightsource.c:127-142 ->
                # IBL_SAMPLING_* enum, light.h:19-23)
                light.ibl_sampler = _str1(val)
            elif base == "sisfile":
                light.sis_file = _str1(val)
        self.scene.lights.append(light)
        return len(self.scene.lights) - 1

    def AreaLightSource(self, name, params) -> int:
        """ri_api_area_light_source (lightsource.c:106-163): 'sunsky' builds
        a Preetham sky + sun directional light; other names bind the NEXT
        geometry in this attribute block as an area-light emitter."""
        if name == "sunsky":
            from lucille_tpu.lights.sunsky import PreethamSunSky

            kw = {}
            for key, val in params.items():
                base = key.split()[-1]
                try:
                    arr = np.asarray(val, dtype=np.float64).reshape(-1)
                except (ValueError, TypeError):
                    continue
                if base in ("latitude", "longitude", "turbidity"):
                    kw[base] = float(arr[0])
                elif base in ("month", "day", "hour"):
                    kw[base] = float(arr[0])
                # the reference's own tokens (lightsource.c:304-317)
                elif base == "julian_day":
                    kw["julian_day"] = float(arr[0])
                elif base == "time_of_day":
                    kw["hour"] = float(arr[0])
                elif base == "standard_meridian":
                    # RIB value is a TIMEZONE; ri_sunsky_init scales by
                    # 15 to degrees (sunsky.c:207)
                    kw["standard_meridian"] = float(arr[0]) * 15.0
            sunsky = PreethamSunSky(**kw)
            light = LightDesc(type="sunsky", sunsky=sunsky)
            sampler = params.get("sampling")
            if sampler:
                light.ibl_sampler = str(
                    sampler[0] if isinstance(sampler, (list, tuple)) else sampler
                )
            self.scene.lights.append(light)
            # companion directional sun light (lightsource.c:150-163,
            # including the reference's y/z swap of sun_dir)
            sun = LightDesc(type="sun")
            d = sunsky.sun_direction()
            sun.direction = np.array([d[0], d[2], d[1]])
            sun.color = sunsky.sunlight_rgb()
            self.scene.lights.append(sun)
            return len(self.scene.lights) - 2

        light = LightDesc(type="area", intensity=1.0)
        for key, val in params.items():
            base = key.split()[-1]
            arr = np.asarray(val, dtype=np.float64).reshape(-1)
            if base == "intensity":
                light.intensity = float(arr[0])
            elif base == "lightcolor":
                light.color = arr[:3].copy()
        self.scene.lights.append(light)
        self.attrs.area_light_index = len(self.scene.lights) - 1
        return self.attrs.area_light_index

    def Illuminate(self, handle, onoff):
        pass  # all declared lights are on, as in the reference

    # ------------------------------------------------------------------
    # options / display / camera
    # ------------------------------------------------------------------

    def Format(self, xres, yres, pixel_aspect=1.0):
        self.options.width = int(xres)
        self.options.height = int(yres)
        self.camera.horizontal_resolution = int(xres)
        self.camera.vertical_resolution = int(yres)
        self.camera.pixel_aspect_ratio = float(pixel_aspect)

    def FrameAspectRatio(self, ratio):
        self.options.frame_aspect_ratio = float(ratio)

    def ScreenWindow(self, left, right, bottom, top):
        self.camera.screen_window = (
            float(left),
            float(right),
            float(bottom),
            float(top),
        )

    def Clipping(self, near, far):
        pass  # ray tracer: clipping is implicit

    def CropWindow(self, xmin, xmax, ymin, ymax):
        """RiCropWindow: fractional raster window to render
        (camera.c:401-409 stores it; the renderer clips tiles to it)."""
        self.camera.crop_window = (
            float(xmin),
            float(xmax),
            float(ymin),
            float(ymax),
        )

    def DepthOfField(self, fstop, focal_length, focal_distance):
        self.camera.fstop = float(fstop)
        self.camera.focal_length = float(focal_length)
        self.camera.focal_distance = float(focal_distance)

    def Shutter(self, open_t, close_t):
        self.camera.shutter_open = float(open_t)
        self.camera.shutter_close = float(close_t)

    def Projection(self, name, params=None):
        if name == "perspective":
            self.camera.camera_projection = PERSPECTIVE
        else:
            self.camera.camera_projection = ORTHOGRAPHIC
        if params:
            for key, val in params.items():
                if key.split()[-1] == "fov":
                    self.camera.fov = float(np.asarray(val).reshape(-1)[0])

    def Orientation(self, orient):
        self.options.orientation = str(orient)

    def Display(self, name, driver, mode, params=None):
        """Display list semantics (reference display.c:239): a leading '+'
        appends another display; otherwise the list is reset."""
        driver = str(driver).strip().lower()
        name = str(name)
        if name.startswith("+"):
            self.options.displays.append(
                DisplayDesc(name=name[1:], driver=driver, mode=mode,
                            params=dict(params or {}))
            )
        else:
            self.options.displays = [
                DisplayDesc(name=name, driver=driver, mode=mode,
                            params=dict(params or {}))
            ]

    def PixelSamples(self, xs, ys):
        disp = self.options.current_display()
        disp.sampling_rates = (max(1.0, float(xs)), max(1.0, float(ys)))

    def PixelFilter(self, name, xwidth, ywidth):
        self.options.pixel_filter = str(name)
        self.options.pixel_filter_width = (float(xwidth), float(ywidth))

    def Exposure(self, gain, gamma):
        self.options.impl["exposure_gain"] = float(gain)
        self.options.impl["exposure_gamma"] = float(gamma)

    def Quantize(self, type_, one, qmin, qmax, ampl):
        pass  # HDR pipeline: quantization is the display driver's business

    def Hider(self, name, params=None):
        pass

    def Declare(self, name, declaration):
        self.declares[str(name)] = str(declaration)

    def Option(self, name, params):
        """RIB Option sections (reference option.c:389-560)."""
        opt = self.options
        getf = lambda v: float(np.asarray(v, dtype=np.float64).reshape(-1)[0])
        gets = lambda v: str(v[0] if isinstance(v, (list, tuple)) else v)
        if name == "searchpath":
            for key, val in params.items():
                base = key.split()[-1]
                if base in ("archive", "shader", "texture", "path"):
                    path = gets(val)
                    for p in path.split(":"):
                        if p and p not in opt.searchpaths:
                            opt.searchpaths.append(p)
        elif name == "raytrace":
            for key, val in params.items():
                base = key.split()[-1]
                if base == "finalgather_rays":
                    opt.gather_nsamples = int(getf(val))
                elif base == "arealight_rays":
                    opt.narealight_rays = int(getf(val))
                elif base == "max_ray_depth":
                    opt.max_ray_depth = int(getf(val))
                elif base == "accel_method":
                    opt.accel_method = gets(val)
        elif name == "lighting":
            for key, val in params.items():
                base = key.split()[-1]
                flag = gets(val) not in ("off", "0", "false")
                if base == "direct":
                    opt.enable_direct_lighting = flag
                elif base == "indirect":
                    opt.enable_indirect_lighting = flag
                elif base == "caustics":
                    opt.enable_caustics_lighting = flag
        elif name == "limits":
            for key, val in params.items():
                base = key.split()[-1]
                if base == "bucketsize":
                    arr = np.asarray(val, dtype=np.float64).reshape(-1)
                    if arr.size:
                        # tiles are square; honor the first extent
                        opt.tile_size = max(8, int(arr[0]))
        elif name == "renderer":
            for key, val in params.items():
                base = key.split()[-1]
                if base == "nthreads":
                    opt.nthreads = int(getf(val))
                elif base == "qmc":
                    opt.use_qmc = gets(val) not in ("off", "0", "false")
                elif base == "method":
                    opt.render_method = gets(val)
                elif base == "multithread":
                    pass
                elif base == "adaptive_supersampling":
                    opt.impl["adaptive_supersampling"] = gets(val)
        else:
            opt.impl.setdefault(name, {}).update(params)

    # ------------------------------------------------------------------
    # frame / world blocks
    # ------------------------------------------------------------------

    def FrameBegin(self, n=0):
        pass

    def FrameEnd(self):
        pass

    def MotionBegin(self, times):
        log(LOG_WARN, "MotionBegin: motion blur unsupported; using first key")

    def MotionEnd(self):
        pass

    def WorldBegin(self):
        """context.c:134-158: capture world→camera, push identity CTM."""
        self.world_block += 1
        self.world_to_camera = self.ctm.copy()
        self.scene.world_to_camera = self.world_to_camera
        self.trans_stack.append(vm.mat4_identity())
        if self.world_begin_cb:
            self.world_begin_cb(self)

    def WorldEnd(self):
        """Finalize the scene (reference fires ri_render_frame here)."""
        self.camera.setup(self.world_to_camera, self.options.orientation)
        if len(self.trans_stack) > 1:
            self.trans_stack.pop()
        if self.world_end_cb:
            self.world_end_cb(self)

    # ------------------------------------------------------------------
    # geometry
    # ------------------------------------------------------------------

    def _add_geom(self, geom):
        if geom is not None and geom.ntriangles > 0:
            self.scene.geoms.append(geom)
            if geom.attrs.area_light_index >= 0:
                self.scene.lights[geom.attrs.area_light_index].geom_index = (
                    len(self.scene.geoms) - 1
                )

    def Polygon(self, params):
        self._add_geom(
            _polygon.build_polygon(
                params, self.ctm, self._orientation_is_rh(), self.attrs
            )
        )

    def PointsPolygons(self, nvertices, indices, params):
        self._add_geom(
            _polygon.build_points_polygons(
                params, nvertices, indices, self.ctm,
                self._orientation_is_rh(), self.attrs,
            )
        )

    def PointsGeneralPolygons(self, nloops, nvertices, indices, params):
        self._add_geom(
            _polygon.build_points_general_polygons(
                params, nloops, nvertices, indices, self.ctm,
                self._orientation_is_rh(), self.attrs,
            )
        )

    def Sphere(self, radius, zmin, zmax, thetamax, params=None):
        self._add_geom(
            _quadric.build_sphere(
                radius, zmin, zmax, thetamax, self.ctm,
                self._orientation_is_rh(), self.attrs,
            )
        )

    def SubdivisionMesh(self, scheme, nvertices, vertices, params):
        self._add_geom(
            _subdivision.build_subdivision_mesh(
                scheme, nvertices, vertices, params, self.ctm,
                self._orientation_is_rh(), self.attrs,
            )
        )

    def Curves(self, degree, nvertices, wrap, params):
        """RiCurves: hair/fur strands (the FurRender R&D renderer's
        primitive, rnd/FurRender/curve.h) tessellated to tube triangles
        that ride the standard tile kernels."""
        from lucille_tpu.ri import curves as _curves

        self._add_geom(
            _curves.build_curves(
                degree, nvertices, wrap, params, self.ctm,
                self._orientation_is_rh(), self.attrs,
            )
        )

    # ------------------------------------------------------------------
    # error tolerance
    # ------------------------------------------------------------------

    def unknown_command(self, name: str, line: int = 0):
        """parserib.y:866-875: warn, count, 30-strike abort."""
        print(f"Unknown RIB command: {name} at line {line}")
        self.nunknown += 1
        if self.nunknown > MAX_UNKNOWN_COMMANDS:
            print("[RIB parse] Too many unknown commands. Give up parsing.")
            raise TooManyUnknownCommands(name)


def _ori(rh: bool) -> np.ndarray:
    m = vm.mat4_identity()
    if rh:
        m[2, 2] = -1.0
    return m
