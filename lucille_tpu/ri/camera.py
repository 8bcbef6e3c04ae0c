"""RenderMan camera: setup and raster→ray mapping.

Faithful to the reference semantics (src/ri/camera.c):

- ``setup`` (camera.c:214-245): focal length ``1/tan(fov/2)``; an
  orientation matrix that flips z for right-handed scenes; and
  ``camera_to_world = inverse(world_to_camera) @ orientation`` in
  row-vector convention.
- ``get_pos_and_dir`` (camera.c:248-330): raster (x, y) maps to the view
  vector ``v = ((2x - w)/w, (2y - h)/h, sign * flength)`` with
  ``sign = -1`` for RH; perspective rays start at the transformed origin
  and point through the transformed v; orthographic rays start at (vx, vy)
  and share direction.

Ray *generation* happens on device: `generate_rays` is pure jnp over
float32 pixel-coordinate arrays and traces under jit, so a whole tile of
rays is produced in one fused elementwise pass instead of a per-pixel call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from lucille_tpu.ops import vecmat as vm

PERSPECTIVE = "perspective"
ORTHOGRAPHIC = "orthographic"


@dataclass
class Camera:
    """Camera state (reference ri_camera_t, camera.h:30-89)."""

    horizontal_resolution: int = 640
    vertical_resolution: int = 480
    pixel_aspect_ratio: float = 1.0
    crop_window: tuple = (0.0, 1.0, 0.0, 1.0)
    screen_window: tuple = (-4.0 / 3.0, 4.0 / 3.0, -1.0, 1.0)
    camera_projection: str = ORTHOGRAPHIC  # RI default; Projection overrides
    fov: float = 90.0
    # depth of field (camera.h: fstop/focal_length/focal_distance)
    fstop: float = math.inf
    focal_length: float = 0.0
    focal_distance: float = 0.0
    # shutter
    shutter_open: float = 0.0
    shutter_close: float = 0.0
    # derived at setup
    flength: float = 0.0
    is_rh: bool = False
    camera_to_world: np.ndarray = field(default_factory=vm.mat4_identity)

    def setup(self, world_to_camera: np.ndarray, orientation: str) -> None:
        """Compute camera_to_world (reference ri_camera_setup, camera.c:214)."""
        self.flength = 1.0 / math.tan((self.fov * math.pi / 180.0) * 0.5)
        ori = vm.mat4_identity()
        self.is_rh = orientation == "rh"
        if self.is_rh:
            ori[2, 2] = -ori[2, 2]
        m = vm.mat4_inverse(world_to_camera)
        self.camera_to_world = vm.mat4_mul(m, ori)

    # -- device-side ray generation --------------------------------------

    def ray_constants(self):
        """Precompute the float32 constants generate_rays needs.

        Returns (origin (3,), mat3 (3,3), zview scalar, sign) where a view
        vector v = (vx, vy, zview) maps to world dir = v @ mat3 (+ the
        camera position handling done in generate_rays).
        """
        c2w = self.camera_to_world
        sign = -1.0 if self.is_rh else 1.0
        origin = vm.transform_point(np.zeros(3), c2w)
        return (
            origin.astype(np.float32),
            c2w[:3, :3].astype(np.float32),
            c2w[3, :3].astype(np.float32),
            np.float32(sign * self.flength),
            np.float32(sign),
        )

    @property
    def dof_active(self) -> bool:
        """Thin-lens sampling fires only when RiDepthOfField gave a finite
        fstop and positive focal settings (camera.h:30-89 params; the
        reference's own dof() hook is parked under `#if 0` with a "TODO:
        fix this" at camera.c:284-312 — here it works)."""
        return (
            self.camera_projection == PERSPECTIVE
            and math.isfinite(self.fstop)
            and self.fstop > 0.0
            and self.focal_length > 0.0
            and self.focal_distance > 0.0
        )

    def generate_rays(self, px, py, lens_u=None):
        """Map raster coordinates to world-space rays, on device.

        px, py: float32 arrays (...,) of raster positions (pixel corner +
        subpixel jitter, as in render.c:770).  Returns (org, dir) with
        shape (..., 3); dir is normalized (render.c:779).

        lens_u: optional (..., 2) uniforms for thin-lens depth of field.
        When dof_active, each ray's origin moves to a sampled point on
        the lens disk (radius = focal_length / (2 * fstop), camera.c:72)
        and its direction pivots about the in-focus point at camera depth
        focal_distance, so geometry on the focus plane stays sharp and
        everything else blurs by the circle of confusion.
        """
        import jax.numpy as jnp

        origin, rot, trans, zview, sign = self.ray_constants()
        w = jnp.float32(self.horizontal_resolution)
        h = jnp.float32(self.vertical_resolution)
        vx = (2.0 * px - w) / w
        vy = (2.0 * py - h) / h

        if self.dof_active and lens_u is not None:
            aperture = jnp.float32(self.focal_length / (2.0 * self.fstop))
            # in-focus point: scale the view vector so its |z| reaches
            # focal_distance (v_z is sign*flength, so t = fdist/flength)
            t = jnp.float32(self.focal_distance / self.flength)
            fx_ = vx * t
            fy_ = vy * t
            fz_ = jnp.broadcast_to(
                jnp.float32(sign * self.focal_distance), vx.shape
            )
            # polar disk sample on the lens (area-uniform)
            r = aperture * jnp.sqrt(lens_u[..., 0])
            th = (2.0 * jnp.pi) * lens_u[..., 1]
            lx = r * jnp.cos(th)
            ly = r * jnp.sin(th)

            def xform_l(x, y, z, with_trans=True):
                ox = x * rot[0, 0] + y * rot[1, 0] + z * rot[2, 0]
                oy = x * rot[0, 1] + y * rot[1, 1] + z * rot[2, 1]
                oz = x * rot[0, 2] + y * rot[1, 2] + z * rot[2, 2]
                if with_trans:
                    ox, oy, oz = ox + trans[0], oy + trans[1], oz + trans[2]
                return jnp.stack([ox, oy, oz], axis=-1)

            org = xform_l(lx, ly, jnp.zeros_like(lx))
            d = xform_l(fx_, fy_, fz_) - org
            n = jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
            return org, d / jnp.maximum(n, 1e-20)

        # Row-vector transform spelled as explicit FMAs: a (..., 3) @ (3, 3)
        # matmul at default precision may run in reduced precision (bf16
        # passes or TF32), which costs ~1e-3 in ray direction.  Explicit
        # elementwise arithmetic keeps full f32 and fuses into ray setup.
        def xform(x, y, z, with_trans=True):
            ox = x * rot[0, 0] + y * rot[1, 0] + z * rot[2, 0]
            oy = x * rot[0, 1] + y * rot[1, 1] + z * rot[2, 1]
            oz = x * rot[0, 2] + y * rot[1, 2] + z * rot[2, 2]
            if with_trans:
                ox, oy, oz = ox + trans[0], oy + trans[1], oz + trans[2]
            return jnp.stack([ox, oy, oz], axis=-1)

        if self.camera_projection == PERSPECTIVE:
            org = jnp.broadcast_to(jnp.asarray(origin), vx.shape + (3,))
            d = xform(vx, vy, jnp.broadcast_to(zview, vx.shape)) - org
        else:
            # orthographic: pos = (vx, vy, 0), dir via (vx, vy, sign*1)
            org = xform(vx, vy, jnp.zeros_like(vx))
            d = xform(vx, vy, jnp.broadcast_to(sign, vx.shape)) - org
        n = jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
        return org, d / jnp.maximum(n, 1e-20)

    def generate_rays_host(self, px, py):
        """NumPy float64 twin of generate_rays for golden-path testing."""
        c2w = self.camera_to_world
        sign = -1.0 if self.is_rh else 1.0
        w = float(self.horizontal_resolution)
        h = float(self.vertical_resolution)
        px = np.asarray(px, dtype=np.float64)
        py = np.asarray(py, dtype=np.float64)
        vx = (2.0 * px - w) / w
        vy = (2.0 * py - h) / h
        vz = np.full_like(vx, sign * self.flength)
        v = np.stack([vx, vy, vz], axis=-1)
        if self.camera_projection == PERSPECTIVE:
            org = np.broadcast_to(vm.transform_point(np.zeros(3), c2w), v.shape)
            d = vm.transform_point(v, c2w) - org
        else:
            p = np.stack([vx, vy, np.zeros_like(vx)], axis=-1)
            org = vm.transform_point(p, c2w)
            p2 = np.stack([vx, vy, np.full_like(vx, sign)], axis=-1)
            d = vm.transform_point(p2, c2w) - org
        return org, vm.normalize(d)
