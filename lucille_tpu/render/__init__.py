"""Render manager: tiles, film, tonemap, frame orchestration.

JAX replacement for lucille's render core orchestration
(src/render/render.c): the bucket queue + worker threads
(render.c:1043-1207) become a statically-shaped, jit-compiled tile kernel
invoked over a host-side tile list (spiral/scanline/Z/Hilbert order for
progressive display), or sharded across devices via shard_map
(lucille_tpu.parallel).
"""

from lucille_tpu.render.renderer import Renderer, render_frame
from lucille_tpu.render.tiles import tile_list

__all__ = ["Renderer", "render_frame", "tile_list"]
