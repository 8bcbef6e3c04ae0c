"""Pallas kernels (Triton route): dense ray-triangle intersection.

The fused alternative to the XLA paths (accel/bruteforce.py,
accel/mxu.py) for small scenes: one program owns RAY_BLOCK rays and
streams the triangle matrix from device memory in tiles of TC triangles
inside a loop.  The (TC, RAY_BLOCK) Moller-Trumbore chain, the window
tests and the closest-hit selection stay in registers; XLA's versions
write each (ray, triangle-chunk) product to device memory before they
reduce it.

Tiles carry AABBs: a tile that no ray of the program can reach (the slab
test also uses the program's running best t) is skipped whole.  With the
triangles in Morton order (scene/compile.py) that is the wavefront form
of the reference's beam culling (bvh.c:545-668).

Memory plan:
- triangles: (16, Npad) f32 rows [v0 | e1 | e2 | pad], Npad a multiple
  of TC; a program loads 9 rows of TC contiguous floats per tile;
- tile boxes: (8, n_tiles) f32 rows [min xyz | max xyz | pad];
- rays: (8, B) f32 rows [ox oy oz dx dy dz tmax tmin], B a multiple of
  RAY_BLOCK (the wrapper pads with inert rays: zero direction, tmax 0).

Active-lane compaction: bounce wavefronts whose lanes mostly terminated
stable-partition live lanes to the front; programs wholly past the live
count skip all tile work.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from lucille_tpu.accel.bruteforce import DET_EPS
from lucille_tpu.base import backend

# Block shapes chosen on an H100 (80GB HBM3, 400 W limit) over the AO
# scene's 2.76M-ray eye wavefront and one 240x240x9 AO tile, among
# (rays, triangles, warps) in {64,128,256} x {8,16,32} x {4,8}: 64 rays x
# 32-triangle tiles x 4 warps was best or within 13% of best for every
# dense kernel (PERF.md, PR 1).
RAY_BLOCK = 64  # rays per program
TC = 32  # triangles per tile (the tile-BVH leaf tile is pallas_bvh.TC)
NUM_WARPS = 4
NUM_STAGES = 1  # untuned

# active-mask compaction pays only when skipped programs carry real tile
# work; below this tile count the partition + scatter costs more (untuned)
COMPACT_MIN_TILES = 8


def compiler_params():
    return pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES)


def triton_call(kernel, *, grid, in_specs, out_specs, out_shape, name):
    """pallas_call on the Triton route; interpret mode on the CPU only."""
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=compiler_params(),
        interpret=backend.interpret(),
        name=name,
    )


def any_lane(mask):
    """Block-wide OR of a bool vector (Triton has no reduce_or)."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def live_block(nact_ref, rb):
    """1 when some lane of this program is below the live count (lanes
    compacted by an active mask), else 0 (int32)."""
    return (pl.program_id(0) * rb < nact_ref[0]).astype(jnp.int32)


def bounded_inv(d):
    """1/d with |d| floored at 1e-20: no inf*0 NaNs in the slab test."""
    return 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)


def slab(box_ref, i, ox, oy, oz, ivx, ivy, ivz):
    """Rays-vs-AABB slab test against column i of a (8, n) box matrix
    (test_ray_aabb, bvh.c:870, vectorized over the program's rays)."""
    t0x = (box_ref[0, i] - ox) * ivx
    t1x = (box_ref[3, i] - ox) * ivx
    t0y = (box_ref[1, i] - oy) * ivy
    t1y = (box_ref[4, i] - oy) * ivy
    t0z = (box_ref[2, i] - oz) * ivz
    t1z = (box_ref[5, i] - oz) * ivz
    tn = jnp.maximum(
        jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
        jnp.minimum(t0z, t1z),
    )
    tf = jnp.minimum(
        jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
        jnp.maximum(t0z, t1z),
    )
    return tn, tf


def tile_cols(tris_ref, base, tc, rows):
    """(tc, 1) columns of the rows of a (16, N) triangle matrix."""
    return [tris_ref[r, pl.ds(base, tc)][:, None] for r in rows]


def mt_closest(cols, base, rays, t_best, u_best, v_best, tri_best):
    """Closest-hit update of (t, u, v, tri) against one tile.

    cols: 9 (TC, 1) columns [v0 | e1 | e2]; rays: (ox, oy, oz, dx, dy,
    dz, tmin) rows.  Moller-Trumbore with the reference's window
    (bvh.c:731-791): |det| > eps, u, v in [0, 1], u + v <= 1,
    tmin < t < t_best.  Ties go to the lowest triangle index."""
    (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z) = cols
    ox, oy, oz, dx, dy, dz, tmin = rays
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    a = e1x * px + e1y * py + e1z * pz
    valid = jnp.abs(a) > DET_EPS
    inva = jnp.where(valid, 1.0 / jnp.where(valid, a, 1.0), 0.0)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    u = (sx * px + sy * py + sz * pz) * inva
    v = (qx * dx + qy * dy + qz * dz) * inva
    t = (e2x * qx + e2y * qy + e2z * qz) * inva
    hit = (
        valid
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < t_best)
    )
    t_m = jnp.where(hit, t, jnp.inf)
    # gather-free selection: min t over the triangle axis, the lowest row
    # holding it by a masked iota min, u/v by a masked sum
    tc = jnp.min(t_m, axis=0)
    row = jax.lax.broadcasted_iota(jnp.int32, t_m.shape, 0)
    j = jnp.min(jnp.where(t_m <= tc[None, :], row, t_m.shape[0]), axis=0)
    sel = row == j[None, :]
    u_sel = jnp.sum(jnp.where(sel, u, 0.0), axis=0)
    v_sel = jnp.sum(jnp.where(sel, v, 0.0), axis=0)
    better = tc < t_best
    return (
        jnp.where(better, tc, t_best),
        jnp.where(better, u_sel, u_best),
        jnp.where(better, v_sel, v_best),
        jnp.where(better, base + j, tri_best),
    )


def mt_any(cols, rays, tmax):
    """Division-free any-hit of one tile: (TC, RB) bool.

    The raw Moller-Trumbore triple products u' = s.p, v' = q.d, t' = e2.q
    satisfy u' + v' + w' = a (the determinant), so "inside" is a
    same-sign test and the t window becomes tmin a^2 < t'a < tmax a^2.
    An occlusion query (bvh.c:731-791 semantics) never needs (u, v, t)."""
    (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z) = cols
    ox, oy, oz, dx, dy, dz, tmin = rays
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    a = e1x * px + e1y * py + e1z * pz
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    u = sx * px + sy * py + sz * pz
    v = qx * dx + qy * dy + qz * dz
    w = a - u - v
    t = e2x * qx + e2y * qy + e2z * qz
    inside = (jnp.minimum(jnp.minimum(u, v), w) >= 0.0) | (
        jnp.maximum(jnp.maximum(u, v), w) <= 0.0
    )
    ta = t * a
    aa = a * a
    return (
        inside
        & (ta > tmin * aa)
        & (ta < tmax * aa)
        & (jnp.abs(a) > DET_EPS)
    )


def load_rays(rays_ref):
    """(ox, oy, oz, dx, dy, dz, tmin) rows, tmax row, inverse directions."""
    r = [rays_ref[k, :] for k in range(8)]
    rays = (r[0], r[1], r[2], r[3], r[4], r[5], r[7])
    return rays, r[6], (bounded_inv(r[3]), bounded_inv(r[4]), bounded_inv(r[5]))


def _closest_kernel(nact_ref, rays_ref, boxes_ref, tris_ref,
                    t_ref, u_ref, v_ref, tri_ref, ntile_ref, *, n_tiles):
    rb = t_ref.shape[0]
    rays, tmax, (ivx, ivy, ivz) = load_rays(rays_ref)
    ox, oy, oz = rays[0], rays[1], rays[2]
    init = (
        tmax,
        jnp.zeros((rb,), jnp.float32),
        jnp.zeros((rb,), jnp.float32),
        jnp.full((rb,), -1, jnp.int32),
        jnp.int32(0),
    )

    def body(i, c):
        t_best = c[0]
        tn, tf = slab(boxes_ref, i, ox, oy, oz, ivx, ivy, ivz)
        live = any_lane((tn <= tf) & (tf > 0.0) & (tn < t_best))

        def test():
            cols = tile_cols(tris_ref, i * TC, TC, range(9))
            return (*mt_closest(cols, i * TC, rays, *c[:4]), c[4] + 1)

        return jax.lax.cond(live, test, lambda: c)

    # programs wholly past the live count (compaction) test no tile
    live_tiles = live_block(nact_ref, rb) * n_tiles
    t, u, v, tri, ntested = jax.lax.fori_loop(0, live_tiles, body, init)
    t_ref[:] = t
    u_ref[:] = u
    v_ref[:] = v
    tri_ref[:] = tri
    ntile_ref[:] = jnp.full((rb,), ntested, jnp.int32)


def _anyhit_kernel(nact_ref, rays_ref, boxes_ref, tris_ref, occ_ref,
                   ntile_ref, *, n_tiles):
    """Occlusion: the tile loop stops once every ray is occluded; an
    occluded ray also drops out of the tile culls."""
    rb = occ_ref.shape[0]
    rays, tmax, (ivx, ivy, ivz) = load_rays(rays_ref)
    ox, oy, oz = rays[0], rays[1], rays[2]
    wants = tmax > rays[6]  # pad lanes carry an empty window

    live_tiles = live_block(nact_ref, rb) * n_tiles

    def cond(c):
        i, occ, _ = c
        return (i < live_tiles) & any_lane(wants & (occ == 0))

    def body(c):
        i, occ, n = c
        tn, tf = slab(boxes_ref, i, ox, oy, oz, ivx, ivy, ivz)
        reach = (tn <= tf) & (tf > 0.0) & (tn < tmax) & (occ == 0)

        def test():
            cols = tile_cols(tris_ref, i * TC, TC, range(9))
            hit = mt_any(cols, rays, tmax)
            return occ | jnp.max(hit.astype(jnp.int32), axis=0), n + 1

        occ, n = jax.lax.cond(any_lane(reach), test, lambda: (occ, n))
        return i + 1, occ, n

    init = (jnp.int32(0), jnp.zeros((rb,), jnp.int32), jnp.int32(0))
    _, occ, ntested = jax.lax.while_loop(cond, body, init)
    occ_ref[:] = occ
    ntile_ref[:] = jnp.full((rb,), ntested, jnp.int32)


def pack_tris(scene, tc: int):
    """Scene SoA -> (16, Npad) f32 rows [v0 | e1 | e2 | pad], Npad a
    multiple of tc.  Pad columns are zero triangles (det 0, never hit)."""
    n = scene.tri_v0.shape[0]
    npad = -(-n // tc) * tc
    tris = jnp.zeros((16, npad), jnp.float32)
    tris = tris.at[0:3, :n].set(scene.tri_v0.T)
    tris = tris.at[3:6, :n].set(scene.tri_e1.T)
    tris = tris.at[6:9, :n].set(scene.tri_e2.T)
    return tris, npad


def pack_boxes(scene, npad, tc: int):
    """Per-tile AABBs -> (8, n_tiles) f32, rows [min xyz | max xyz | pad].

    Boxes grow by a relative 1e-6 so rounding in the slab test never
    culls a tile that a triangle test would hit (flat tiles have zero
    thickness).  Pad triangles (beyond scene.n_tris) contribute
    +inf/-inf, so an all-pad tile has an inverted box and is culled."""
    nreal = scene.n_tris
    npad_scene = scene.tri_v0.shape[0]
    v0 = scene.tri_v0
    v1 = v0 + scene.tri_e1
    v2 = v0 + scene.tri_e2
    mins = jnp.minimum(jnp.minimum(v0, v1), v2)
    maxs = jnp.maximum(jnp.maximum(v0, v1), v2)
    mins = mins - 1e-6 * (1.0 + jnp.abs(mins))
    maxs = maxs + 1e-6 * (1.0 + jnp.abs(maxs))
    real = (jnp.arange(npad_scene) < nreal)[:, None]
    mins = jnp.where(real, mins, jnp.inf)
    maxs = jnp.where(real, maxs, -jnp.inf)
    if npad > npad_scene:
        pad = npad - npad_scene
        mins = jnp.concatenate([mins, jnp.full((pad, 3), jnp.inf)])
        maxs = jnp.concatenate([maxs, jnp.full((pad, 3), -jnp.inf)])
    n_tiles = npad // tc
    tmin = mins.reshape(n_tiles, tc, 3).min(axis=1)
    tmax = maxs.reshape(n_tiles, tc, 3).max(axis=1)
    boxes = jnp.zeros((8, n_tiles), jnp.float32)
    boxes = boxes.at[0:3].set(tmin.T)
    boxes = boxes.at[3:6].set(tmax.T)
    return boxes


def pack_rays(org, dirn, tmax, tmin, block: int):
    """(8, Bpad) rows [ox oy oz dx dy dz tmax tmin], Bpad a multiple of
    block.  Pad lanes have zero direction and an empty window (tmax 0),
    so they never hit and never keep a tile alive."""
    B = org.shape[0]
    Bpad = max(block, -(-B // block) * block)
    rays = jnp.zeros((8, Bpad), jnp.float32)
    rays = rays.at[0:3, :B].set(org.T)
    rays = rays.at[3:6, :B].set(dirn.T)
    trow = (
        jnp.full((B,), jnp.inf, jnp.float32)
        if tmax is None
        else jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (B,))
    )
    rays = rays.at[6, :B].set(trow)
    rays = rays.at[7].set(jnp.float32(tmin))
    return rays, Bpad


def partition_order(live):
    """Stable partition of lane indices: live lanes first, order kept
    within each class.  Returns (order, nlive): lane ``order[j]`` of the
    input occupies compacted slot ``j``."""
    B = live.shape[0]
    live_i = live.astype(jnp.int32)
    nlive = jnp.sum(live_i)
    pos = jnp.where(
        live, jnp.cumsum(live_i) - 1, nlive + jnp.cumsum(1 - live_i) - 1
    )
    order = (
        jnp.zeros((B,), jnp.int32)
        .at[pos]
        .set(jnp.arange(B, dtype=jnp.int32))
    )
    return order, nlive


def _compact_rays(org, dirn, tmax, tmin, active):
    """Pad + optional live-lane compaction shared by both wrappers.
    Returns (rays (8, Bpad), Bpad, nact (1,), order or None)."""
    B = org.shape[0]
    if active is None:
        rays, Bpad = pack_rays(org, dirn, tmax, tmin, RAY_BLOCK)
        return rays, Bpad, jnp.full((1,), B, jnp.int32), None
    order, nact = partition_order(active)
    trow = None if tmax is None else jnp.broadcast_to(
        jnp.asarray(tmax, jnp.float32), (B,)
    )[order]
    rays, Bpad = pack_rays(org[order], dirn[order], trow, tmin, RAY_BLOCK)
    return rays, Bpad, nact.astype(jnp.int32).reshape((1,)), order


def _wants_compaction(scene, active):
    n_tiles = -(-scene.tri_v0.shape[0] // TC)
    return active is not None and n_tiles >= COMPACT_MIN_TILES


def pallas_closest_hit(scene, org, dirn, tmax=None, tmin: float = 0.0,
                       active=None):
    """Closest hit via the fused kernel; same contract as
    brute_closest_hit.  active: optional (B,) live mask; live lanes are
    compacted to the front so programs holding only dead lanes skip all
    tile work (dead lanes' results are unspecified)."""
    if not _wants_compaction(scene, active):
        active = None
    return _pallas_closest_hit(scene, org, dirn, tmax, float(tmin), active)


@partial(jax.jit, static_argnames=("tmin",))
def _pallas_closest_hit(scene, org, dirn, tmax=None, tmin=0.0, active=None):
    B = org.shape[0]
    tris, npad = pack_tris(scene, TC)
    boxes = pack_boxes(scene, npad, TC)
    n_tiles = npad // TC
    rays, Bpad, nact, order = _compact_rays(org, dirn, tmax, tmin, active)

    row = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    t, u, v, tri, ntile = triton_call(
        partial(_closest_kernel, n_tiles=n_tiles),
        grid=(Bpad // RAY_BLOCK,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),
            pl.BlockSpec((8, RAY_BLOCK), lambda i: (0, i)),
            pl.BlockSpec(boxes.shape, lambda i: (0, 0)),
            pl.BlockSpec(tris.shape, lambda i: (0, 0)),
        ],
        out_specs=[row] * 5,
        out_shape=[
            jax.ShapeDtypeStruct((Bpad,), jnp.float32),
            jax.ShapeDtypeStruct((Bpad,), jnp.float32),
            jax.ShapeDtypeStruct((Bpad,), jnp.float32),
            jax.ShapeDtypeStruct((Bpad,), jnp.int32),
            jax.ShapeDtypeStruct((Bpad,), jnp.int32),
        ],
        name="lucille_dense_closest",
    )(nact, rays, boxes, tris)
    tiles = jnp.sum(ntile[::RAY_BLOCK].astype(jnp.float32))
    t, u, v, tri = t[:B], u[:B], v[:B], tri[:B]
    if order is not None:
        # back to caller order; compacted-away lanes report a miss
        unsort = lambda a, fill: jnp.full_like(a, fill).at[order].set(a)
        t = unsort(t, jnp.inf)
        u = unsort(u, 0.0)
        v = unsort(v, 0.0)
        tri = unsort(tri, -1)
    return {
        "t": t,
        "u": u,
        "v": v,
        "tri": jnp.minimum(tri, scene.tri_v0.shape[0] - 1),
        "hit": tri >= 0,
        # tests actually run: surviving tiles x TC triangles x block rays
        "ntests": tiles * (TC * RAY_BLOCK),
        "ntrav": tiles,
    }


def pallas_any_hit(scene, org, dirn, tmax=None, tmin: float = 0.0,
                   active=None):
    """Occlusion via the fused kernel; returns bool (B,).  active: see
    pallas_closest_hit (dead lanes report unoccluded)."""
    if not _wants_compaction(scene, active):
        active = None
    return _pallas_any_hit(scene, org, dirn, tmax, float(tmin), active)


@partial(jax.jit, static_argnames=("tmin",))
def _pallas_any_hit(scene, org, dirn, tmax=None, tmin=0.0, active=None):
    B = org.shape[0]
    tris, npad = pack_tris(scene, TC)
    boxes = pack_boxes(scene, npad, TC)
    rays, Bpad, nact, order = _compact_rays(org, dirn, tmax, tmin, active)
    row = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    occ, _ntile = triton_call(
        partial(_anyhit_kernel, n_tiles=npad // TC),
        grid=(Bpad // RAY_BLOCK,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),
            pl.BlockSpec((8, RAY_BLOCK), lambda i: (0, i)),
            pl.BlockSpec(boxes.shape, lambda i: (0, 0)),
            pl.BlockSpec(tris.shape, lambda i: (0, 0)),
        ],
        out_specs=[row, row],
        out_shape=[
            jax.ShapeDtypeStruct((Bpad,), jnp.int32),
            jax.ShapeDtypeStruct((Bpad,), jnp.int32),
        ],
        name="lucille_dense_anyhit",
    )(nact, rays, boxes, tris)
    occ = occ[:B] > 0
    if order is not None:
        occ = jnp.zeros_like(occ).at[order].set(occ)
    return occ
