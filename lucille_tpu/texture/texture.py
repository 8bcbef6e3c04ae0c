"""Textures on device: bilinear fetch, IBL projections, mipmaps, SAT.

Capability map to the reference:

- fp32 texel storage + bilinear ``ri_texture_fetch`` (texture.c:86)
  -> `TextureAtlas.fetch` (vectorized gather + lerp);
- IBL angular-map / lat-long fetch (texture.c:238, texture.h:100-105)
  -> `ibl_fetch_angular` / `ibl_fetch_latlong`;
- mipmap generation (texture_loader.c:368-403) -> `build_mipmaps`
  (successive 2x box reductions — one reduce_window each); the
  reference's *blocked mipmap disk format* (texture_loader.c:8-24) is a
  CPU cache-locality trick with no device analog: device textures are kept
  dense and fetched with vectorized gathers instead;
- Summed-Area Table (texture.h:45-60) -> `summed_area_table`
  (two cumsums), used by structured importance sampling (tools sisgen).

Atlas design: all scene textures are padded to a common (H, W) and
stacked into one (T, H, W, 3) array so any wavefront can fetch from any
texture with a single gather — no per-texture kernels, no rebinds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


def build_mipmaps(img: np.ndarray, max_levels: int = 12):
    """Box-filtered mip chain (texture_loader.c:368-403 capability)."""
    levels = [np.asarray(img, dtype=np.float32)]
    cur = levels[0]
    while min(cur.shape[0], cur.shape[1]) > 1 and len(levels) < max_levels:
        h2 = max(1, cur.shape[0] // 2)
        w2 = max(1, cur.shape[1] // 2)
        cur = cur[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))
        levels.append(cur.astype(np.float32))
    return levels


def summed_area_table(img: np.ndarray) -> np.ndarray:
    """SAT over luminance (texture.h:45-60): sat[y, x] = sum img[:y, :x]."""
    lum = np.asarray(img, dtype=np.float64)
    if lum.ndim == 3:
        lum = lum.mean(axis=-1)
    return lum.cumsum(axis=0).cumsum(axis=1)


@dataclass
class TextureAtlas:
    """All scene textures in one stacked device array."""

    data: Any = None  # (T, H, W, 3) jnp f32
    sizes: Any = None  # (T, 2) i32 true (h, w) per texture before padding
    names: dict = field(default_factory=dict)  # name -> id

    @staticmethod
    def build(images: dict) -> "TextureAtlas":
        """images: {name: (h, w, 3) float array} -> atlas."""
        import jax.numpy as jnp

        if not images:
            return TextureAtlas()
        H = max(im.shape[0] for im in images.values())
        W = max(im.shape[1] for im in images.values())
        stack = np.zeros((len(images), H, W, 3), dtype=np.float32)
        sizes = np.zeros((len(images), 2), dtype=np.int32)
        names = {}
        for i, (name, im) in enumerate(sorted(images.items())):
            h, w = im.shape[:2]
            stack[i, :h, :w] = np.asarray(im, dtype=np.float32)[..., :3]
            sizes[i] = (h, w)
            names[name] = i
        return TextureAtlas(
            data=jnp.asarray(stack), sizes=jnp.asarray(sizes), names=names
        )

    def id_of(self, name: str) -> int:
        return self.names.get(name, -1)

    def fetch(self, tex_id, s, t):
        """Bilinear texel fetch (ri_texture_fetch, texture.c:86).

        tex_id: int or (B,) i32; s, t: (B,) in [0, 1] (clamped, matching
        the reference's clamp addressing).  Returns (B, 3).
        """
        import jax.numpy as jnp

        if self.data is None:
            return jnp.ones(s.shape + (3,), jnp.float32)
        tid = jnp.broadcast_to(jnp.asarray(tex_id, jnp.int32), s.shape)
        tid = jnp.clip(tid, 0, self.data.shape[0] - 1)
        h = self.sizes[tid, 0].astype(jnp.float32)
        w = self.sizes[tid, 1].astype(jnp.float32)
        x = jnp.clip(s, 0.0, 1.0) * (w - 1.0)
        y = jnp.clip(t, 0.0, 1.0) * (h - 1.0)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        x1 = jnp.minimum(x0 + 1, (w - 1.0).astype(jnp.int32))
        y1 = jnp.minimum(y0 + 1, (h - 1.0).astype(jnp.int32))
        fx = (x - x0.astype(jnp.float32))[..., None]
        fy = (y - y0.astype(jnp.float32))[..., None]
        c00 = self.data[tid, y0, x0]
        c10 = self.data[tid, y0, x1]
        c01 = self.data[tid, y1, x0]
        c11 = self.data[tid, y1, x1]
        return (
            c00 * (1 - fx) * (1 - fy)
            + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy
            + c11 * fx * fy
        )


def ibl_fetch_latlong(atlas: TextureAtlas, tex_id, dirn):
    """Environment fetch, lat-long projection (texture.c:238 capability).

    dirn: (B, 3) unit directions, y-up.  theta in [0, pi] downward from
    +y, phi wraps around y.
    """
    import jax.numpy as jnp

    d = dirn
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 2], d[..., 0])
    s = (phi + jnp.pi) / (2.0 * jnp.pi)
    t = theta / jnp.pi
    return atlas.fetch(tex_id, s, t)


def ibl_fetch_angular(atlas: TextureAtlas, tex_id, dirn):
    """Environment fetch, Debevec angular-map projection
    (texture.h:100-105 angular->latlong capability)."""
    import jax.numpy as jnp

    d = dirn
    # angular map: r = acos(-dz) / (pi * sqrt(dx^2 + dy^2))
    denom = jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    r = jnp.where(
        denom > 1e-9,
        jnp.arccos(jnp.clip(-d[..., 2], -1.0, 1.0)) / (jnp.pi * jnp.maximum(denom, 1e-9)),
        0.0,
    )
    s = 0.5 + 0.5 * d[..., 0] * r
    t = 0.5 - 0.5 * d[..., 1] * r
    return atlas.fetch(tex_id, s, t)
