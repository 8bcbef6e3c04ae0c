"""Integrator tests: Whitted, path tracer, dirtmap, dispatch."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _plane_scene(extra_rib="", lights_rib=""):
    from lucille_tpu.lights.tables import build_light_tables
    from lucille_tpu.ri.api import RiState
    from lucille_tpu.rib.parser import parse_rib
    from lucille_tpu.scene.compile import compile_scene

    s = RiState()
    # index order [0 3 2 1] makes the ground plane face +y with the fixed
    # PointsPolygons winding (see ri/polygon.py module docstring)
    parse_rib(
        "WorldBegin\n"
        + lights_rib
        + 'PointsPolygons [4] [0 3 2 1] "P" [-50 0 -50  50 0 -50  50 0 50  -50 0 50]\n'
        + extra_rib
        + "WorldEnd\n",
        s,
    )
    scene = compile_scene(s.scene).device_put()
    lights = build_light_tables(s.scene)
    return s, scene, lights


def _down_rays(B=64, height=5.0):
    org = jnp.stack(
        [
            jnp.linspace(-3, 3, B),
            jnp.full((B,), height),
            jnp.linspace(-3, 3, B),
        ],
        axis=-1,
    )
    dirn = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (B, 3))
    return org, dirn


class TestPathTracer:
    @pytest.mark.slow  # 8-frame convergence study, ~60 s
    def test_furnace_closed_environment(self):
        """White lambertian plane under a unit dome light: the surface
        radiance converges to the dome radiance (furnace-like check)."""
        from lucille_tpu.transport.pathtrace import path_radiance

        _, scene, lights = _plane_scene(
            lights_rib='LightSource "domelight" 1 "intensity" [1.0]\n'
        )
        org, dirn = _down_rays(256)
        out = []
        for i in range(8):
            r, aux = path_radiance(
                scene, lights, org, dirn, jax.random.key(i), max_depth=6
            )
            out.append(np.asarray(r))
        mean = np.concatenate(out).mean()
        # kd defaults to 1 (perfect white): radiance -> 1.0
        assert mean == pytest.approx(1.0, abs=0.08)

    @pytest.mark.slow  # semantic zero check, deep unroll; ~12 s
    def test_black_without_lights_or_background(self):
        from lucille_tpu.lights.tables import LightTables
        from lucille_tpu.transport.pathtrace import path_radiance

        _, scene, _ = _plane_scene()
        org, dirn = _down_rays(32)
        r, _ = path_radiance(scene, LightTables([]), org, dirn, jax.random.key(0))
        np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-6)

    @pytest.mark.slow  # escape path also covered by furnace/background tests; ~11 s
    def test_escaped_rays_see_background(self):
        from lucille_tpu.lights.tables import LightTables
        from lucille_tpu.transport.pathtrace import path_radiance

        _, scene, _ = _plane_scene()
        B = 16
        org = jnp.zeros((B, 3)) + jnp.asarray([0.0, 1.0, 0.0])
        dirn = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (B, 3))  # up
        r, _ = path_radiance(
            scene, LightTables([]), org, dirn, jax.random.key(0),
            bgcolor=(0.25, 0.5, 0.75),
        )
        np.testing.assert_allclose(
            np.asarray(r), np.broadcast_to([0.25, 0.5, 0.75], (B, 3)), atol=1e-6
        )

    @pytest.mark.slow  # area-light estimator also covered by sampling tests; ~19 s
    def test_area_light_illuminates(self):
        from lucille_tpu.transport.pathtrace import path_radiance

        # emissive quad 3 units above the plane
        _, scene, lights = _plane_scene(
            extra_rib=(
                "AttributeBegin\n"
                'AreaLightSource "arealight" 2 "intensity" [5.0]\n'
                'PointsPolygons [4] [0 1 2 3] "P" '
                '[-1 3 -1  1 3 -1  1 3 1  -1 3 1]\n'
                "AttributeEnd\n"
            )
        )
        assert lights.nlights == 1
        assert lights.lights[0].tris is not None
        org, dirn = _down_rays(128, height=2.0)
        r, _ = path_radiance(scene, lights, org, dirn, jax.random.key(0))
        assert float(np.asarray(r).mean()) > 0.01


class TestWhitted:
    def test_direct_lighting_from_distant(self):
        from lucille_tpu.transport.whitted import whitted_radiance

        _, scene, lights = _plane_scene(
            lights_rib=(
                'LightSource "distantlight" 1 "intensity" [2.0] '
                '"from" [0 10 0] "to" [0 0 0]\n'
            )
        )
        org, dirn = _down_rays(64)
        r, aux = whitted_radiance(scene, lights, org, dirn, jax.random.key(0))
        vals = np.asarray(r)
        assert (vals > 0.0).all()
        assert np.isfinite(vals).all()

    def test_material_roughness_changes_highlight_width(self):
        """Surface "plastic" "roughness" reaches direct_specular: a rough
        material spreads its highlight over more of the plane than a
        polished one (whitted.c's specular path; plumbing fixed r4 — the
        roughness was hardcoded 0.1 in whitted.py)."""
        from lucille_tpu.transport.whitted import whitted_radiance

        def highlight(rough):
            from lucille_tpu.lights.tables import build_light_tables
            from lucille_tpu.ri.api import RiState
            from lucille_tpu.rib.parser import parse_rib
            from lucille_tpu.scene.compile import compile_scene

            s = RiState()
            parse_rib(
                "WorldBegin\n"
                'LightSource "distantlight" 1 "intensity" [1.0] '
                '"from" [2 10 0] "to" [0 0 0]\n'
                f'Surface "plastic" "Kd" [0.0] "Ks" [1.0] '
                f'"roughness" [{rough}]\n'
                'PointsPolygons [4] [0 3 2 1] "P" '
                '[-50 0 -50  50 0 -50  50 0 50  -50 0 50]\n'
                "WorldEnd\n",
                s,
            )
            scene = compile_scene(s.scene).device_put()
            assert abs(float(scene.mat_roughness[0]) - rough) < 1e-6
            lights = build_light_tables(s.scene)
            # perspective fan from one eye point: V varies per lane, so
            # ndoth sweeps through the highlight across the wavefront
            B = 256
            eye = jnp.asarray([0.0, 5.0, 0.0])
            targets = jnp.stack(
                [jnp.linspace(-20, 20, B), jnp.zeros((B,)), jnp.zeros((B,))],
                axis=-1,
            )
            dirn = targets - eye
            dirn = dirn / jnp.linalg.norm(dirn, axis=-1, keepdims=True)
            org = jnp.broadcast_to(eye, (B, 3))
            r, _ = whitted_radiance(
                scene, lights, org, dirn, jax.random.key(0), max_depth=1
            )
            return np.asarray(r)[:, 0]

        tight = highlight(0.02)
        wide = highlight(0.4)
        thresh = 0.05 * max(tight.max(), wide.max())
        assert (wide > thresh).sum() > 2 * (tight > thresh).sum()

    @pytest.mark.slow  # mirror bounce also covered by the sl trace() tests; ~15 s
    def test_mirror_sees_plane(self):
        """A specular quad above a lit plane reflects the plane's color."""
        from lucille_tpu.transport.whitted import whitted_radiance

        s, scene, lights = _plane_scene(
            lights_rib='LightSource "domelight" 1 "intensity" [1.0]\n',
            extra_rib=(
                "AttributeBegin\n"
                'Surface "mirror" "Ks" [1.0]\n'
                'PointsPolygons [4] [0 1 2 3] "P" '
                '[-2 4 -2  2 4 -2  2 4 2  -2 4 2]\n'
                "AttributeEnd\n"
            ),
        )
        B = 32
        # rays hitting the mirror from below at an angle
        org = jnp.stack(
            [jnp.linspace(-1, 1, B), jnp.full((B,), 0.5), jnp.zeros((B,))],
            axis=-1,
        )
        up = jnp.broadcast_to(jnp.asarray([0.1, 1.0, 0.0]), (B, 3))
        dirn = up / jnp.linalg.norm(up, axis=-1, keepdims=True)
        r, _ = whitted_radiance(scene, lights, org, dirn, jax.random.key(1))
        assert np.isfinite(np.asarray(r)).all()


class TestDirtmap:
    def test_open_plane_is_clean(self):
        from lucille_tpu.transport.dirtmap import dirtmap_radiance

        _, scene, _ = _plane_scene()
        org, dirn = _down_rays(64)
        r, aux = dirtmap_radiance(scene, org, dirn, jax.random.key(0), 4, 4)
        hits = np.asarray(aux["hit"])
        vals = np.asarray(r)[hits]
        np.testing.assert_allclose(vals, 1.0, atol=1e-5)

    def test_corner_is_dirty(self):
        # a wall right next to the shading points adds dirt
        from lucille_tpu.transport.dirtmap import dirtmap_radiance

        _, scene, _ = _plane_scene(
            extra_rib=(
                'PointsPolygons [4] [0 1 2 3] "P" '
                '[-0.2 0 -50  -0.2 0 50  -0.2 50 50  -0.2 50 -50]\n'
            )
        )
        org, dirn = _down_rays(64)
        r, aux = dirtmap_radiance(scene, org, dirn, jax.random.key(0), 4, 4)
        hits = np.asarray(aux["hit"])
        assert np.asarray(r)[hits].min() < 0.9


class TestDispatch:
    @pytest.mark.parametrize("method", ["ao", "whitted", "pathtrace", "dirtmap"])
    def test_all_methods_run_through_renderer(self, method):
        from lucille_tpu.render.renderer import Renderer
        from lucille_tpu.ri.api import RiState
        from lucille_tpu.rib.parser import parse_rib

        s = RiState()
        parse_rib(
            'Display "t.hdr" "file" "rgb"\nPixelSamples 1 1\n'
            'Projection "perspective" "fov" [45]\nOrientation "rh"\n'
            "ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 -1 -8 1]\n"
            "WorldBegin\n"
            'LightSource "domelight" 1\n'
            'PointsPolygons [4] [0 1 2 3] "P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]\n'
            "WorldEnd\n",
            s,
        )
        s.Format(32, 32)
        s.options.render_method = method
        s.options.gather_nsamples = 4
        s.options.max_ray_depth = 3
        img = Renderer(s.scene, tile_size=32).render_frame()
        assert img.shape == (32, 32, 3)
        assert np.isfinite(img).all()
        assert img.mean() > 0.0


class TestShadedIntegrator:
    def test_rsl_shader_from_searchpath_drives_render(self, tmp_path):
        """A NON-builtin .sl shader compiled from disk colors the pixels
        (the dlopen-replacement path, attribute.c:372-428)."""
        from lucille_tpu.render.renderer import Renderer
        from lucille_tpu.ri.api import RiState
        from lucille_tpu.rib.parser import parse_rib

        (tmp_path / "flatred.sl").write_text(
            "surface flatred(float K = 1) { Ci = K * (1, 0.25, 0.1); }"
        )
        s = RiState()
        parse_rib(
            'Projection "perspective" "fov" [45]\n'
            f'Option "searchpath" "shader" ["{tmp_path}"]\n'
            'Option "renderer" "method" ["shader"]\n'
            "WorldBegin\n"
            'Surface "flatred" "K" [0.5]\n'
            'Polygon "P" [ 2 2 4  2 -2 4  -2 -2 4  -2 2 4 ]\n'
            "WorldEnd\n",
            s,
        )
        s.Format(32, 24)
        img = Renderer(s.scene, tile_size=32).render_frame()
        # hit pixels are K * (1, .25, .1) = (0.5, 0.125, 0.05)
        hits = img[..., 0] > 0.4
        assert hits.mean() > 0.3
        want = np.broadcast_to([0.5, 0.125, 0.05], img[hits].shape)
        np.testing.assert_allclose(img[hits], want, atol=1e-5)

    def test_two_shaders_masked_dispatch(self):
        from lucille_tpu.render.renderer import Renderer
        from lucille_tpu.ri.api import RiState
        from lucille_tpu.rib.parser import parse_rib

        s = RiState()
        parse_rib(
            'Projection "perspective" "fov" [60]\n'
            'Option "renderer" "method" ["shader"]\n'
            "WorldBegin\n"
            "AttributeBegin\n"
            'Surface "constant"\nColor [1 0 0]\n'
            'Polygon "P" [ -0.2 2 4  -0.2 -2 4  -2.4 -2 4  -2.4 2 4 ]\n'
            "AttributeEnd\n"
            "AttributeBegin\n"
            'Surface "constant"\nColor [0 0 1]\n'
            'Polygon "P" [ 2.4 2 4  2.4 -2 4  0.2 -2 4  0.2 2 4 ]\n'
            "AttributeEnd\n"
            "WorldEnd\n",
            s,
        )
        s.Format(48, 32)
        img = Renderer(s.scene, tile_size=48).render_frame()
        h, w = img.shape[:2]
        # probe solidly inside each panel (the gap shows the dome env)
        left_px = img[h // 2, w // 4]
        right_px = img[h // 2, 3 * w // 4]
        np.testing.assert_allclose(left_px, [1, 0, 0], atol=1e-5)
        np.testing.assert_allclose(right_px, [0, 0, 1], atol=1e-5)

    def test_trace_builtin_mirror_reflects_plane(self):
        """Surface "mirror" through the SHADER method renders non-black:
        ctx.trace() recursively shades the reflected wavefront
        (shader.c:895-925 parity)."""
        from lucille_tpu.transport.shaded import (
            build_shader_table,
            shaded_radiance,
        )

        # a SMALL tilted-view mirror: the reflected rays land on ground
        # OUTSIDE the mirror's dome-shadow footprint (a big overhead
        # mirror correctly reflects its own pitch-black shadow)
        s, scene, lights = _plane_scene(
            lights_rib='LightSource "domelight" 1 "intensity" [1.0]\n',
            extra_rib=(
                "AttributeBegin\n"
                'Surface "mirror" "Kr" [1.0]\n'
                'PointsPolygons [4] [0 1 2 3] "P" '
                '[-4 4 -4  2 4 -4  2 4 4  -4 4 4]\n'
                "AttributeEnd\n"
            ),
        )
        table = build_shader_table(s.scene)
        B = 32
        # rays angled up at the mirror: hit near x in [0.5, 1.5], the
        # reflection continues to ground x in [2.5, 3.5] — outside the
        # mirror's x-extent, where the dome still lights the plane
        org = jnp.stack(
            [jnp.linspace(-0.5, 0.5, B), jnp.full((B,), 2.0), jnp.zeros((B,))],
            axis=-1,
        )
        up = jnp.broadcast_to(jnp.asarray([0.5, 1.0, 0.0]), (B, 3))
        dirn = up / jnp.linalg.norm(up, axis=-1, keepdims=True)
        r, aux = shaded_radiance(
            scene, lights, org, dirn, jax.random.key(3), shader_table=table
        )
        vals = np.asarray(r)
        hits = np.asarray(aux["hit"])
        assert hits.all()
        # mirror lanes reflect the dome-lit plane: clearly non-black
        assert np.isfinite(vals).all()
        assert vals[hits].mean() > 0.05

    def test_trace_depth_terminates(self):
        """Two parallel mirrors: recursion is bounded (shader.c:911) and
        the result stays finite instead of diverging."""
        from lucille_tpu.transport.shaded import (
            build_shader_table,
            shaded_radiance,
        )

        s, scene, lights = _plane_scene(
            lights_rib='LightSource "domelight" 1 "intensity" [1.0]\n',
            extra_rib=(
                "AttributeBegin\n"
                'Surface "mirror" "Kr" [1.0]\n'
                'PointsPolygons [4] [0 1 2 3] "P" '
                '[-20 4 -20  20 4 -20  20 4 20  -20 4 20]\n'
                'PointsPolygons [4] [0 3 2 1] "P" '
                '[-20 1 -20  20 1 -20  20 1 20  -20 1 20]\n'
                "AttributeEnd\n"
            ),
        )
        table = build_shader_table(s.scene)
        org, dirn = _down_rays(16, height=3.0)
        r, _ = shaded_radiance(
            scene, lights, org, dirn, jax.random.key(4), shader_table=table
        )
        assert np.isfinite(np.asarray(r)).all()

    def test_whitted_sl_from_corpus_renders_nonblack(self, tmp_path):
        """The bundled whitted.sl-equivalent RSL source (trace through the
        SL compiler) produces non-black pixels via --method shader."""
        from lucille_tpu.render.renderer import Renderer
        from lucille_tpu.ri.api import RiState
        from lucille_tpu.rib.parser import parse_rib

        # whitted.sl's structure (reference shaders/whitted.sl): ambient +
        # illuminance + trace(P, reflect(I, Nn)) + refraction trace
        (tmp_path / "whitted.sl").write_text(
            "surface whitted(float eta = 1.5; float Kd = .8; float Kr = .8;"
            "  float Kt = .2; float Ks = .2; float Kss = 2) {\n"
            "  normal Nn = faceforward(normalize(N), I);\n"
            "  Ci = Kd * ambient();\n"
            "  illuminance(P, Nn, PI/2) { Ci += Kd * Cl * (L . Nn); }\n"
            "  Ci += Ks * trace(P, reflect(I, Nn));\n"
            "  vector T = refract(I, Nn, (N.I) < 0 ? eta : 1/eta);\n"
            "  if (length(T) != 0.0) Ci += Kt * trace(P, T);\n"
            "}\n"
        )
        s = RiState()
        parse_rib(
            'Projection "perspective" "fov" [45]\n'
            f'Option "searchpath" "shader" ["{tmp_path}"]\n'
            'Option "renderer" "method" ["shader"]\n'
            "WorldBegin\n"
            'LightSource "domelight" 1 "intensity" [1.0]\n'
            'Surface "whitted"\n'
            'Polygon "P" [ 2 2 4  2 -2 4  -2 -2 4  -2 2 4 ]\n'
            "WorldEnd\n",
            s,
        )
        s.Format(32, 24)
        img = Renderer(s.scene, tile_size=32).render_frame()
        assert np.isfinite(img).all()
        assert img.mean() > 0.01
