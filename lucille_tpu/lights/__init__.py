"""Light sources: dome/distant/point/area/IBL/sunsky.

JAX replacement for lucille's light stack (src/render/light.{c,h},
src/render/ibl.c, src/render/sunsky.c — SURVEY.md section 2.4).
"""

from lucille_tpu.lights.sunsky import PreethamSunSky

__all__ = ["PreethamSunSky"]
