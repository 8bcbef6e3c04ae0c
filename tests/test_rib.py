"""RIB front-end tests, incl. ports of the reference ribparse regression
suite semantics (tests/ribparse/test_runner.py: scenes must parse without
crashing; named bug-repro scenes behave as the oracle expects)."""

import numpy as np
import pytest

from lucille_tpu.rib.lexer import TokenKind, tokenize
from lucille_tpu.rib.parser import parse_rib
from lucille_tpu.ri.api import RiState, TooManyUnknownCommands

REF = "/root/reference/tests/ribparse"


def _parse(text: str) -> RiState:
    s = RiState()
    parse_rib(text, s)
    return s


class TestLexer:
    def test_tokens(self):
        toks = list(tokenize('WorldBegin # comment\nColor [1 0.5 0] "P"'))
        kinds = [t.kind for t in toks]
        assert kinds == [
            TokenKind.ID,
            TokenKind.ID,
            TokenKind.LBRACKET,
            TokenKind.NUMBER,
            TokenKind.NUMBER,
            TokenKind.NUMBER,
            TokenKind.RBRACKET,
            TokenKind.STRING,
        ]
        assert toks[3].value == 1.0

    def test_negative_exponent_numbers(self):
        toks = list(tokenize("Translate -1.5e-3 .5 2"))
        assert toks[1].value == pytest.approx(-0.0015)
        assert toks[2].value == 0.5

    def test_line_numbers(self):
        toks = list(tokenize("WorldBegin\n\nWorldEnd"))
        assert toks[0].line == 1
        assert toks[1].line == 3


class TestStateMachine:
    def test_empty_scene(self):
        # empty_scene_20081119.rib
        s = _parse('Display "0001.tif" "file" "rgb"\nWorldBegin\n\nWorldEnd\n')
        assert s.scene.ntriangles == 0
        assert s.options.displays[0].name == "0001.tif"

    def test_multiple_display_appends(self):
        # multiple_display_20081119.rib: "+name" appends
        s = _parse(
            'Display "0001.tif" "file" "rgb"\n'
            'Display "+0002.tif" "file" "rgba"\n'
            "WorldBegin\nWorldEnd\n"
        )
        assert [d.name for d in s.options.displays] == ["0001.tif", "0002.tif"]
        assert s.options.displays[1].mode == "rgba"

    def test_zero_poly_is_tolerated(self):
        # zero_poly_20081209.rib
        s = _parse("WorldBegin\nPointsPolygons [ ] [ ] \"P\" [ ]\nWorldEnd\n")
        assert s.scene.ntriangles == 0

    def test_indices_shortage_is_tolerated(self):
        # indices_shortage_20081221.rib
        s = _parse('PointsPolygons [4 4] [1] "P" [1.0]')
        assert s.scene.ntriangles == 0

    def test_zero_string_param(self):
        # zero_string_param_20090212.rib (Issue #322)
        s = _parse(
            'Surface "MOSAICsurface"\n'
            '  "uniform float SSSTexBlur" [ 0.0 ]\n'
            '  "uniform string ColMap" [ "" ]\n'
        )
        assert s.attrs.surface == "MOSAICsurface"
        assert s.attrs.surface_params["uniform string ColMap"] == [""]

    def test_unknown_command_tolerance(self, capsys):
        # unknown_protocol_20081119.rib: warn on stdout, keep going
        s = _parse("TheWorld\nWorldBegin\nWorldEnd\n")
        out = capsys.readouterr().out
        assert "Unknown RIB command: TheWorld" in out
        assert s.world_block == 1

    def test_unknown_command_30_strike_abort(self):
        text = "\n".join(f"Bogus{i}" for i in range(32))
        with pytest.raises(TooManyUnknownCommands):
            _parse(text)

    def test_transform_stacks(self):
        s = _parse(
            "Translate 1 2 3\n"
            "TransformBegin\nTranslate 10 0 0\nTransformEnd\n"
        )
        np.testing.assert_allclose(s.ctm[3, :3], [1, 2, 3])

    def test_attribute_stack_restores_transform_and_attrs(self):
        s = _parse(
            "Color [1 0 0]\nAttributeBegin\nColor [0 1 0]\nTranslate 5 0 0\n"
            "AttributeEnd\n"
        )
        assert s.attrs.color == (1.0, 0.0, 0.0)
        np.testing.assert_allclose(s.ctm[3, :3], [0, 0, 0])

    def test_concat_transform_order(self):
        # ConcatTransform applies the new matrix FIRST (row-vector M @ CTM)
        s = _parse("Translate 0 0 5\nScale 2 2 2\n")
        # point p transformed by CTM: scale first, then translate
        p = np.array([1.0, 0.0, 0.0])
        from lucille_tpu.ops import transform_point

        np.testing.assert_allclose(transform_point(p, s.ctm), [2, 0, 5])

    def test_sphere_tessellation(self):
        s = _parse("WorldBegin\nSphere 1 -1 1 360\nWorldEnd\n")
        g = s.scene.geoms[0]
        assert g.kind == "sphere"
        # all vertices on the unit sphere
        r = np.linalg.norm(g.positions, axis=-1)
        np.testing.assert_allclose(r, 1.0, atol=1e-6)
        # 16-div tessellation: ndiv*(ndiv-1)+2 vertices (quadric.c:60)
        assert len(g.positions) == 16 * 15 + 2

    def test_two_sided_doubles_triangles(self):
        one = _parse('WorldBegin\nPolygon "P" [0 0 0  1 0 0  0 1 0]\nWorldEnd\n')
        two = _parse(
            'WorldBegin\nSides 2\nPolygon "P" [0 0 0  1 0 0  0 1 0]\nWorldEnd\n'
        )
        assert two.scene.ntriangles == 2 * one.scene.ntriangles

    def test_subdivision_mesh_refines(self):
        cube = (
            "WorldBegin\n"
            'SubdivisionMesh "catmull-clark" '
            "[4 4 4 4 4 4] "
            "[0 1 2 3  4 5 6 7  0 1 5 4  1 2 6 5  2 3 7 6  3 0 4 7] "
            '"P" [ -1 -1 -1  1 -1 -1  1 1 -1  -1 1 -1  -1 -1 1  1 -1 1  1 1 1  -1 1 1 ]\n'
            "WorldEnd\n"
        )
        s = _parse(cube)
        g = s.scene.geoms[0]
        assert g.kind == "subdiv"
        # 3 subdivision steps on a cube: 6*4^3 = 384 quads = 768 triangles
        assert g.ntriangles == 768
        # subdivision pulls the surface inside the cube
        assert np.abs(g.positions).max() < 1.0


class TestReferenceScenes:
    """Run the actual reference ribparse scenes through our parser."""

    @pytest.mark.parametrize(
        "rib",
        [
            "empty_scene_20081119.rib",
            "multiple_display_20081119.rib",
            "zero_poly_20081209.rib",
            "indices_shortage_20081221.rib",
            "zero_string_param_20090212.rib",
        ],
    )
    def test_parses_cleanly(self, rib):
        import os

        path = os.path.join(REF, rib)
        if not os.path.exists(path):
            pytest.skip("reference scenes unavailable")
        s = RiState()
        from lucille_tpu.rib.parser import parse_rib_file

        parse_rib_file(path, s)

    def test_unknown_protocol_oracle(self, capsys):
        """#| ./expected.py "Unknown RIB command: TheWorld" oracle."""
        import os
        import re

        path = os.path.join(REF, "unknown_protocol_20081119.rib")
        if not os.path.exists(path):
            pytest.skip("reference scenes unavailable")
        s = RiState()
        from lucille_tpu.rib.parser import parse_rib_file

        parse_rib_file(path, s)
        out = capsys.readouterr().out
        assert re.search("Unknown RIB command: TheWorld", out)

    def test_ambient_occlusion_scene(self):
        """The in-repo AO scene: ground + two spheres + three boxes at
        lucille's default 640x480, 3x3 samples, 64 gather rays."""
        import os

        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scenes", "ao_objects.rib",
        )
        s = RiState()
        from lucille_tpu.rib.parser import parse_rib_file

        parse_rib_file(path, s)
        sc = s.scene
        assert len(sc.geoms) == 6
        assert sc.ntriangles == 1796
        assert s.camera.camera_projection == "perspective"
        assert s.camera.fov == 45.0
        assert s.camera.is_rh
        assert (sc.options.width, sc.options.height) == (640, 480)
        assert sc.options.gather_nsamples == 64
        d = sc.options.current_display()
        assert d.sampling_rates == (3.0, 3.0)
        assert d.name == "ao_objects.hdr"
