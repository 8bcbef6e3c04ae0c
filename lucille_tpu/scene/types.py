"""Device scene representation: a pytree of padded SoA arrays.

Replaces the reference's pointer-based scene graph (ri_geom_t lists,
ri_triangle_t with geom back-pointers — src/render/triangle.h:23-30,
geom.h:28-65) with flat arrays indexed by triangle id.  Per-corner shading
attributes (normals, st, colors) are pre-gathered per triangle so device
kernels never chase vertex indices — one gather by triangle id yields
everything interpolation needs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import jax
import numpy as np


@dataclass(frozen=True)
class SceneArrays:
    """All device-resident scene data.  Registered as a JAX pytree; the
    `n_*` metadata fields are static (hashable aux data) so jit treats
    shape-determining values as compile-time constants."""

    # triangles (padded to n_pad; pad entries are degenerate => never hit)
    tri_v0: Any  # (N, 3) f32
    tri_e1: Any  # (N, 3) f32  v1 - v0
    tri_e2: Any  # (N, 3) f32  v2 - v0
    geom_id: Any  # (N,) i32  -> material table row

    # per-corner shading attributes (already per-triangle, no indices)
    n0: Any  # (N, 3) f32 vertex normal at corner 0 (geometric if absent)
    n1: Any
    n2: Any
    st0: Any  # (N, 2) f32
    st1: Any
    st2: Any
    c0: Any  # (N, 3) f32 vertex color (Cs), default 1
    c1: Any
    c2: Any

    # material table, row per geom
    mat_kd: Any  # (G,) f32
    mat_ks: Any  # (G,) f32
    mat_kt: Any  # (G,) f32 transmission
    mat_ior: Any  # (G,) f32 index of refraction
    mat_color: Any  # (G, 3) f32 (attribute Color)
    mat_texture: Any  # (G,) i32 texture id, -1 = none
    mat_emission: Any  # (G, 3) f32 area-light emission (0 if not a light)
    mat_roughness: Any  # (G,) f32 specular roughness (plastic.sl default 0.1)

    # BVH (flattened skip-link layout; absent => brute force only)
    node_bbmin: Any  # (M, 3) f32
    node_bbmax: Any  # (M, 3) f32
    node_skip: Any  # (M,) i32  next DFS node when this subtree is skipped
    node_first: Any  # (M,) i32  first triangle (leaves)
    node_count: Any  # (M,) i32  0 for inner nodes

    # scene bounds / epsilons
    bbox_min: Any  # (3,) f32
    bbox_max: Any  # (3,) f32
    eps: Any  # () f32 scene-relative ray offset (fixes the reference's
    #           absolute 1e-6, ambientocclusion.c:70 FIXME)

    # uniform grid (CSR cell lists; grid_res 0 => not built) — the
    # working realization of the reference's ugrid.c (whose intersect is
    # a stub, ugrid.c:376-385)
    grid_cell_start: Any = None  # (res^3 + 1,) i32
    grid_tri_idx: Any = None  # (M,) i32
    grid_bbmin: Any = None  # (3,) f32
    grid_bbmax: Any = None  # (3,) f32

    # static metadata (aux_data under jit)
    n_tris: int = 0  # real triangle count (pre-padding)
    n_pad: int = 0  # padded triangle count
    n_geoms: int = 0
    n_nodes: int = 0
    leaf_size: int = 8
    accel: str = "bvh"
    grid_res: int = 0  # cells per axis (cubic)

    _ARRAY_FIELDS = (
        "tri_v0", "tri_e1", "tri_e2", "geom_id",
        "n0", "n1", "n2", "st0", "st1", "st2", "c0", "c1", "c2",
        "mat_kd", "mat_ks", "mat_kt", "mat_ior", "mat_color", "mat_texture",
        "mat_emission", "mat_roughness",
        "node_bbmin", "node_bbmax", "node_skip", "node_first", "node_count",
        "bbox_min", "bbox_max", "eps",
        "grid_cell_start", "grid_tri_idx", "grid_bbmin", "grid_bbmax",
    )
    _STATIC_FIELDS = (
        "n_tris", "n_pad", "n_geoms", "n_nodes", "leaf_size", "accel",
        "grid_res",
    )

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._ARRAY_FIELDS)
        aux = tuple(getattr(self, f) for f in self._STATIC_FIELDS)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        kwargs = dict(zip(cls._ARRAY_FIELDS, children))
        kwargs.update(dict(zip(cls._STATIC_FIELDS, aux)))
        return cls(**kwargs)

    def device_put(self) -> "SceneArrays":
        """Upload all arrays (float32/int32) to the default device."""
        import jax.numpy as jnp

        updates = {}
        for f in self._ARRAY_FIELDS:
            a = getattr(self, f)
            if a is None:
                continue
            a = np.asarray(a)
            if a.dtype in (np.float64, np.float32):
                a = a.astype(np.float32)
            elif a.dtype in (np.int64, np.int32):
                a = a.astype(np.int32)
            updates[f] = jnp.asarray(a)
        return dataclasses.replace(self, **updates)


jax.tree_util.register_pytree_node(
    SceneArrays, SceneArrays.tree_flatten, SceneArrays.tree_unflatten
)
