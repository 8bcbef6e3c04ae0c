"""Scene compiler: SceneDescription → SceneArrays.

The device-side equivalent of ri_scene_setup + ri_bvh_build's
create_triangle_list (src/render/scene.c:85-98, bvh.c:1737): flattens all
geometry into triangle SoA, pre-gathers per-corner shading attributes,
builds the material table, computes the scene bbox and a scene-relative
epsilon, and builds the accelerator that base/backend.py chooses.

Padding: triangle count is padded to a multiple of PAD_MULTIPLE with
degenerate (all-zero) triangles whose Moller-Trumbore determinant is 0 —
they can never be hit, so no masking is needed in the intersector.
"""

from __future__ import annotations

import numpy as np

from lucille_tpu.base import backend
from lucille_tpu.base.log import LOG_INFO, log
from lucille_tpu.base.timer import get_timer
from lucille_tpu.ri.types import SceneDescription
from lucille_tpu.scene.types import SceneArrays

PAD_MULTIPLE = 256  # keeps brute-force chunks and BVH leaves lane-aligned
EPS_SCALE = 1.0e-4  # scene-relative ray-offset epsilon (f32-safe)

def _morton_order(v0, v1, v2, bbmin, bbmax):
    """Stable sort order of triangles along the Morton (Z-order) curve of
    their centroids — the spatial-locality trick the reference applies to
    grid cells (zorder2d.c:106, ugrid.c:745-760), applied to the dense
    kernel's triangle tiles."""
    c = ((v0 + v1 + v2) / 3.0).astype(np.float64)
    ext = np.maximum(np.asarray(bbmax) - np.asarray(bbmin), 1e-12)
    q = np.clip((c - bbmin) / ext * 1024.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) << np.uint64(2)) | (
        spread(q[:, 1]) << np.uint64(1)
    ) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def compile_scene(
    desc: SceneDescription,
    build_bvh: bool | None = None,
    leaf_size: int = 8,
    texture_ids: dict | None = None,
) -> SceneArrays:
    """texture_ids: {texture file name: atlas id} — assigned by the
    renderer after loading the atlas (lucille_tpu.texture)."""
    geoms = [g for g in desc.geoms if g.ntriangles > 0]
    n_geoms = max(1, len(geoms))

    v0s, v1s, v2s = [], [], []
    n0s, n1s, n2s = [], [], []
    st0s, st1s, st2s = [], [], []
    c0s, c1s, c2s = [], [], []
    gids = []

    for gi, g in enumerate(geoms):
        idx = g.indices  # (F, 3)
        # cast to f32 BEFORE the per-triangle gathers: device arrays are
        # f32 anyway, and gathering/crossing 1M-triangle scenes in f64
        # tripled scene-compile time (measured 18.3 -> 6.5 s at 1M tris)
        P = np.asarray(g.positions, dtype=np.float32)
        a, b, c = P[idx[:, 0]], P[idx[:, 1]], P[idx[:, 2]]
        v0s.append(a)
        v1s.append(b)
        v2s.append(c)
        gids.append(np.full(len(idx), gi, dtype=np.int32))

        if g.normals is not None:
            Nv = np.asarray(g.normals, dtype=np.float32)
            n0s.append(Nv[idx[:, 0]])
            n1s.append(Nv[idx[:, 1]])
            n2s.append(Nv[idx[:, 2]])
        else:
            # geometric normal (ri_normal_of_triangle, geometric.c:21-33)
            ng = np.cross(b - a, c - a)
            nrm = np.linalg.norm(ng, axis=-1, keepdims=True)
            ng = ng / np.maximum(nrm, 1e-20)
            n0s.append(ng)
            n1s.append(ng)
            n2s.append(ng)

        if g.facevarying_st is not None:
            fst = np.asarray(g.facevarying_st, dtype=np.float32)
            st0s.append(fst[:, 0])
            st1s.append(fst[:, 1])
            st2s.append(fst[:, 2])
        elif g.st is not None:
            st = np.asarray(g.st, dtype=np.float32)
            st0s.append(st[idx[:, 0]])
            st1s.append(st[idx[:, 1]])
            st2s.append(st[idx[:, 2]])
        else:
            z = np.zeros((len(idx), 2), dtype=np.float32)
            st0s.append(z)
            st1s.append(z)
            st2s.append(z)

        if g.colors is not None:
            C = np.asarray(g.colors, dtype=np.float32)
            c0s.append(C[idx[:, 0]])
            c1s.append(C[idx[:, 1]])
            c2s.append(C[idx[:, 2]])
        else:
            o = np.ones((len(idx), 3), dtype=np.float32)
            c0s.append(o)
            c1s.append(o)
            c2s.append(o)

    if v0s:
        v0 = np.concatenate(v0s)
        v1 = np.concatenate(v1s)
        v2 = np.concatenate(v2s)
        geom_id = np.concatenate(gids)
        n0 = np.concatenate(n0s)
        n1 = np.concatenate(n1s)
        n2 = np.concatenate(n2s)
        st0 = np.concatenate(st0s)
        st1 = np.concatenate(st1s)
        st2 = np.concatenate(st2s)
        c0 = np.concatenate(c0s)
        c1 = np.concatenate(c1s)
        c2 = np.concatenate(c2s)
    else:
        v0 = v1 = v2 = np.zeros((0, 3))
        geom_id = np.zeros(0, dtype=np.int32)
        n0 = n1 = n2 = np.zeros((0, 3))
        st0 = st1 = st2 = np.zeros((0, 2))
        c0 = c1 = c2 = np.zeros((0, 3))

    n_tris = len(v0)

    # scene bbox (calc_scene_bbox, scene.c:182) + margin (bvh.c:1698)
    if n_tris:
        allv = np.concatenate([v0, v1, v2])
        bbmin = allv.min(axis=0)
        bbmax = allv.max(axis=0)
    else:
        bbmin = np.zeros(3)
        bbmax = np.ones(3)
    diag = float(np.linalg.norm(bbmax - bbmin))
    eps = max(diag, 1.0) * EPS_SCALE

    # ---------------- BVH ------------------------------------------------
    accel_method = desc.options.accel_method
    if build_bvh:
        # callers that need node arrays regardless of the accel choice
        # (the BVH visualizer's diagnostics path, tools_tpu/bvh_viz.py)
        accel_method = "pbvh"
    accel_method = backend.choose_accel(accel_method, n_tris)
    if accel_method == "pbvh" and n_tris > 0:
        from lucille_tpu.accel.pallas_bvh import build_tile_bvh

        timer = get_timer()
        timer.start("BVH Construction")
        src, nbox, nmeta, n_nodes = build_tile_bvh(v0, v1, v2)
        dt = timer.end("BVH Construction")
        log(
            LOG_INFO,
            "tile BVH built: %d tris -> %d padded, %d nodes, %.3f sec",
            n_tris,
            len(src),
            n_nodes,
            dt,
        )
        # scatter per-triangle arrays into the tile-aligned leaf layout;
        # pad slots (src < 0) become degenerate all-zero triangles that
        # no intersector can hit
        take = np.maximum(src, 0)
        holes = src < 0

        def scat(a):
            out = np.ascontiguousarray(a[take])
            out[holes] = 0
            return out

        v0, v1, v2 = scat(v0), scat(v1), scat(v2)
        geom_id = scat(geom_id)
        n0, n1, n2 = scat(n0), scat(n1), scat(n2)
        st0, st1, st2 = scat(st0), scat(st1), scat(st2)
        c0, c1, c2 = scat(c0), scat(c1), scat(c2)
        node_bbmin = nbox[0:3].T
        node_bbmax = nbox[3:6].T
        node_skip = nmeta[0]
        node_first = nmeta[1]
        node_count = nmeta[2]
        accel = "pbvh"
    else:
        node_bbmin = np.zeros((1, 3))
        node_bbmax = np.zeros((1, 3))
        node_skip = np.ones(1, dtype=np.int32)
        node_first = np.zeros(1, dtype=np.int32)
        node_count = np.zeros(1, dtype=np.int32)
        n_nodes = 0
        accel = "bruteforce" if accel_method == "pbvh" else accel_method
        if accel == "pallas" and n_tris > 1:
            # Morton-sort triangles by centroid so the dense kernels'
            # triangle tiles are spatially tight — that is what makes the
            # per-(ray block, tile) AABB culling effective
            order = _morton_order(v0, v1, v2, bbmin, bbmax)
            v0, v1, v2 = v0[order], v1[order], v2[order]
            geom_id = geom_id[order]
            n0, n1, n2 = n0[order], n1[order], n2[order]
            st0, st1, st2 = st0[order], st1[order], st2[order]
            c0, c1, c2 = c0[order], c1[order], c2[order]

    # ---------------- uniform grid ---------------------------------------
    # RIB Option "raytrace" "accel_method" ["grid"] (option.c:506 token);
    # the reference's ugrid never traced (intersect stub, ugrid.c:376) —
    # this one does (accel/ugrid.py).
    grid_cell_start = np.zeros(1, dtype=np.int32)
    grid_tri_idx = np.zeros(1, dtype=np.int32)
    grid_bbmin = bbmin
    grid_bbmax = bbmax
    grid_res = 0
    if accel == "ugrid" and n_tris > 0:
        from lucille_tpu.accel.ugrid import build_ugrid

        timer = get_timer()
        timer.start("Grid Construction")
        g = build_ugrid(v0, v1, v2)
        dt = timer.end("Grid Construction")
        log(
            LOG_INFO,
            "uniform grid built: %d tris, %d^3 cells, %d refs, %.3f sec",
            n_tris,
            g.res,
            len(g.tri_idx),
            dt,
        )
        grid_cell_start = g.cell_start
        grid_tri_idx = g.tri_idx
        grid_bbmin = g.bbmin
        grid_bbmax = g.bbmax
        grid_res = g.res

    # ---------------- padding -------------------------------------------
    # pbvh arrays are already tile-padded (len(v0) = n_leafpad >= n_tris);
    # pad from the CURRENT array length either way
    n_base = max(len(v0), 1)
    n_pad = max(PAD_MULTIPLE, -(-n_base // PAD_MULTIPLE) * PAD_MULTIPLE)
    pad = n_pad - len(v0)

    def _pad(a, width):
        if pad == 0 and len(a) == n_pad:
            return a
        shape = (pad,) + a.shape[1:] if a.ndim > 1 else (pad,)
        filler = np.zeros(shape, dtype=a.dtype)
        return np.concatenate([a, filler])

    e1 = v1 - v0
    e2 = v2 - v0

    # ---------------- materials ------------------------------------------
    mat_kd = np.ones(n_geoms)
    mat_ks = np.zeros(n_geoms)
    mat_kt = np.zeros(n_geoms)
    mat_ior = np.ones(n_geoms)
    mat_roughness = np.full(n_geoms, 0.1)
    mat_color = np.ones((n_geoms, 3))
    mat_texture = np.full(n_geoms, -1, dtype=np.int32)
    mat_emission = np.zeros((n_geoms, 3))
    for gi, g in enumerate(geoms):
        a = g.attrs
        mat_kd[gi] = a.material.kd
        mat_ks[gi] = a.material.ks
        mat_kt[gi] = a.material.kt
        mat_ior[gi] = a.material.ior
        mat_roughness[gi] = a.material.roughness
        mat_color[gi] = np.asarray(a.color)
        if texture_ids and a.material.texture:
            mat_texture[gi] = texture_ids.get(a.material.texture, -1)
        if a.area_light_index >= 0 and a.area_light_index < len(desc.lights):
            li = desc.lights[a.area_light_index]
            mat_emission[gi] = np.asarray(li.color) * li.intensity

    return SceneArrays(
        tri_v0=_pad(v0, 3),
        tri_e1=_pad(e1, 3),
        tri_e2=_pad(e2, 3),
        geom_id=_pad(geom_id, 1),
        n0=_pad(n0, 3),
        n1=_pad(n1, 3),
        n2=_pad(n2, 3),
        st0=_pad(st0, 2),
        st1=_pad(st1, 2),
        st2=_pad(st2, 2),
        c0=_pad(c0, 3),
        c1=_pad(c1, 3),
        c2=_pad(c2, 3),
        mat_kd=mat_kd,
        mat_ks=mat_ks,
        mat_kt=mat_kt,
        mat_ior=mat_ior,
        mat_color=mat_color,
        mat_texture=mat_texture,
        mat_emission=mat_emission,
        mat_roughness=mat_roughness,
        node_bbmin=node_bbmin,
        node_bbmax=node_bbmax,
        node_skip=node_skip,
        node_first=node_first,
        node_count=node_count,
        bbox_min=bbmin,
        bbox_max=bbmax,
        eps=np.float32(eps),
        grid_cell_start=grid_cell_start,
        grid_tri_idx=grid_tri_idx,
        grid_bbmin=grid_bbmin,
        grid_bbmax=grid_bbmax,
        grid_res=grid_res,
        n_tris=n_tris,
        n_pad=n_pad,
        n_geoms=n_geoms,
        n_nodes=n_nodes,
        leaf_size=leaf_size,
        accel=accel,
    )
