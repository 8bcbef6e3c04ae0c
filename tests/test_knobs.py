"""Parity coverage for the surviving LUCILLE_* render knob: flipping it
must change HOW a frame is assembled, never its pixels."""

import os

import numpy as np


class TestFrameAccumKnob:
    def test_frame_accum_image_is_identical(self):
        """LUCILLE_FRAME_ACCUM=1 assembles the frame on-device and pulls
        once; the pixels must match the per-tile path exactly."""
        from lucille_tpu.render.renderer import Renderer
        from lucille_tpu.ri.api import RiState
        from lucille_tpu.rib.parser import parse_rib

        def render(accum):
            s = RiState()
            parse_rib(
                'Display "t.hdr" "file" "rgb"\n'
                "PixelSamples 1 1\n"
                'Projection "perspective" "fov" [45]\n'
                'Orientation "rh"\n'
                "ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 -1 -8 1]\n"
                "WorldBegin\n"
                'PointsPolygons [4] [0 3 2 1] "P" '
                "[-5 0 -5  5 0 -5  5 0 5  -5 0 5]\n"
                'PointsPolygons [3] [0 1 2] "P" [-1 0 -1  1 0 -1  0 2 0]\n'
                "WorldEnd\n",
                s,
            )
            s.Format(64, 32)
            s.options.gather_nsamples = 4
            saved = os.environ.get("LUCILLE_FRAME_ACCUM")
            os.environ["LUCILLE_FRAME_ACCUM"] = accum
            try:
                r = Renderer(s.scene, tile_size=16)
                return np.asarray(r.render_frame())
            finally:
                if saved is None:
                    os.environ.pop("LUCILLE_FRAME_ACCUM", None)
                else:
                    os.environ["LUCILLE_FRAME_ACCUM"] = saved

        tiled = render("0")
        accum = render("1")
        np.testing.assert_array_equal(accum, tiled)
