import numpy as np
import pytest

from lucille_tpu.ops import vecmat as vm
from lucille_tpu.ri.camera import PERSPECTIVE, Camera


def _simple_camera(fov=90.0, rh=True, w=640, h=480):
    cam = Camera(horizontal_resolution=w, vertical_resolution=h, fov=fov)
    cam.camera_projection = PERSPECTIVE
    cam.setup(vm.mat4_identity(), "rh" if rh else "lh")
    return cam


class TestCameraSetup:
    def test_flength_fov90(self):
        cam = _simple_camera(fov=90.0)
        assert cam.flength == pytest.approx(1.0)

    def test_flength_fov45(self):
        cam = _simple_camera(fov=45.0)
        assert cam.flength == pytest.approx(1.0 / np.tan(np.deg2rad(22.5)))


class TestRayGen:
    def test_center_ray_rh_internal_world(self):
        """RH scenes live in a z-flipped internal world (both camera and
        geometry get the orientation flip — camera.c:224-231 and
        polygon.c:87-94), so the RH camera's forward axis lands on +z."""
        cam = _simple_camera()
        o, d = cam.generate_rays_host(np.array([320.0]), np.array([240.0]))
        np.testing.assert_allclose(o[0], [0, 0, 0], atol=1e-12)
        np.testing.assert_allclose(d[0], [0, 0, 1], atol=1e-12)

    def test_corner_ray_direction(self):
        cam = _simple_camera(fov=90.0)
        # x=w -> vx=+1; y=h -> vy=+1; RH: vz=-flength=-1, then the
        # orientation flip in camera_to_world negates z again.
        o, d = cam.generate_rays_host(np.array([640.0]), np.array([480.0]))
        np.testing.assert_allclose(d[0], vm.normalize(np.array([[1.0, 1.0, 1.0]]))[0])

    def test_device_matches_host(self):
        import jax.numpy as jnp

        cam = _simple_camera(fov=45.0)
        # non-trivial camera-to-world
        cam.camera_to_world = vm.mat4_mul(
            vm.mat4_rotate(30.0, 0, 1, 0), vm.mat4_translate(1, 2, 3)
        )
        px = np.linspace(0, 640, 13)
        py = np.linspace(0, 480, 13)
        o_h, d_h = cam.generate_rays_host(px, py)
        o_d, d_d = cam.generate_rays(
            jnp.asarray(px, dtype=jnp.float32), jnp.asarray(py, dtype=jnp.float32)
        )
        np.testing.assert_allclose(np.asarray(o_d), o_h, atol=1e-5)
        np.testing.assert_allclose(np.asarray(d_d), d_h, atol=1e-5)

    def test_orthographic_rays_parallel(self):
        cam = Camera(horizontal_resolution=64, vertical_resolution=64)
        cam.setup(vm.mat4_identity(), "lh")
        o, d = cam.generate_rays_host(np.array([0.0, 32.0, 64.0]), np.array([32.0] * 3))
        # all directions identical, origins differ
        np.testing.assert_allclose(d[0], d[1], atol=1e-12)
        np.testing.assert_allclose(d[1], d[2], atol=1e-12)
        assert not np.allclose(o[0], o[1])

    def test_ao_scene_camera_faces_geometry(self):
        """Integration: the in-repo AO scene's camera looks at its bbox."""
        import os

        rib = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scenes", "ao_objects.rib",
        )
        from lucille_tpu.rib.parser import parse_rib_file
        from lucille_tpu.ri.api import RiState

        s = RiState()
        parse_rib_file(rib, s)
        allp = np.concatenate([g.positions for g in s.scene.geoms])
        center = (allp.min(0) + allp.max(0)) / 2
        o, d = s.camera.generate_rays_host(np.array([320.0]), np.array([240.0]))
        to_center = vm.normalize((center - o[0])[None])[0]
        assert float(np.dot(d[0], to_center)) > 0.95


class TestDepthOfField:
    def _cam(self, fstop=2.0):
        import math

        cam = Camera(
            horizontal_resolution=64,
            vertical_resolution=64,
            camera_projection="perspective",
            fov=45.0,
            fstop=fstop,
            focal_length=0.5,
            focal_distance=5.0,
        )
        cam.setup(vm.mat4_identity(), "lh")
        return cam

    def test_inactive_without_depthoffield(self):
        import math

        cam = Camera(camera_projection="perspective", fov=45.0)
        cam.setup(vm.mat4_identity(), "lh")
        assert not cam.dof_active
        # lens uniforms are ignored when DoF is off
        import jax.numpy as jnp

        px = jnp.asarray([10.0, 40.0])
        py = jnp.asarray([20.0, 20.0])
        u = jnp.asarray([[0.3, 0.7], [0.9, 0.1]])
        o1, d1 = cam.generate_rays(px, py)
        o2, d2 = cam.generate_rays(px, py, u)
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2))
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d2))

    def test_lens_rays_converge_at_focus_plane(self):
        """All lens samples of one pixel pass through the same point on
        the focal plane (sharp), and spread elsewhere (blurred)."""
        import jax.numpy as jnp

        cam = self._cam()
        assert cam.dof_active
        B = 64
        px = jnp.full((B,), 22.0)
        py = jnp.full((B,), 41.0)
        rng = np.random.default_rng(7)
        u = jnp.asarray(rng.random((B, 2)), jnp.float32)
        o, d = cam.generate_rays(px, py, u)
        o, d = np.asarray(o), np.asarray(d)
        # origins are spread across the lens disk
        aperture = cam.focal_length / (2.0 * cam.fstop)
        assert o.std(axis=0).max() > 0.01 * aperture
        assert np.abs(o).max() <= aperture + 1e-5
        # march each ray to camera depth z = focal_distance (lh: +z)
        t = (cam.focal_distance - o[:, 2]) / d[:, 2]
        p_focus = o + t[:, None] * d
        assert p_focus.std(axis=0).max() < 1e-4  # converged: in focus
        t2 = (2.0 * cam.focal_distance - o[:, 2]) / d[:, 2]
        p_far = o + t2[:, None] * d
        assert p_far.std(axis=0).max() > 1e-3  # defocused: blurred

    def test_pinhole_limit_matches_no_dof(self):
        """fstop -> huge aperture ~ 0: DoF rays equal pinhole rays."""
        import jax.numpy as jnp

        cam = self._cam(fstop=1e9)
        px = jnp.asarray([10.0, 40.0, 63.0])
        py = jnp.asarray([5.0, 30.0, 60.0])
        u = jnp.asarray([[0.5, 0.5]] * 3)
        o_dof, d_dof = cam.generate_rays(px, py, u)
        cam2 = self._cam()
        cam2.fstop = float("inf")  # disables dof_active
        o_pin, d_pin = cam2.generate_rays(px, py)
        np.testing.assert_allclose(np.asarray(o_dof), np.asarray(o_pin), atol=1e-6)
        np.testing.assert_allclose(np.asarray(d_dof), np.asarray(d_pin), atol=1e-4)
