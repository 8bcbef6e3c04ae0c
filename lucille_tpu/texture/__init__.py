"""Texture system: atlas-resident fp32 textures with filtered fetch.

JAX replacement for lucille's texture stack (src/render/texture.c,
texture_loader.c — SURVEY.md section 2.4).
"""

from lucille_tpu.texture.texture import (
    TextureAtlas,
    ibl_fetch_angular,
    ibl_fetch_latlong,
    summed_area_table,
)

__all__ = [
    "TextureAtlas",
    "ibl_fetch_latlong",
    "ibl_fetch_angular",
    "summed_area_table",
]
