"""Pallas kernels (Triton route): packet walks over a tile BVH.

The accelerator for large scenes, the counterpart of the reference's
per-ray BVH walk (bvh.c:1093-1190) shaped for a wide machine:

- **Hierarchy over tiles, not triangles.**  The host SAH build
  (accel/bvh.py, the binned algorithm of bvh.c:1329) stops at leaves of
  at most TC triangles, each padded to one TC-triangle tile, so a leaf
  visit is one dense (TC, RAY_BLOCK) test — the same test the dense
  kernels run (pallas_isect.py).
- **One walk per program.**  A program owns RAY_BLOCK rays and walks the
  skip-link layout once for all of them: node bounds are read from
  device memory, the slab test runs over every ray of the program, and
  "any ray reaches" decides descend-or-skip.  No stack: on reach go to
  node + 1, else to skip[node] (DFS order, accel/bvh.py).  Node arrays
  live in device memory with no size budget.
- **Coherent programs.**  The AO gather sorts its rays into blocks of
  Morton-adjacent origins times cone-adjacent strata, so a program's rays
  agree about what to visit — the beam-tracing amortization
  (bvh.c:545-668) as sorted wavefronts.  The any-hit walk ends when
  every ray of the program is occluded.

Interpret mode runs the same kernels on the CPU for the test suite.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from lucille_tpu.accel.pallas_isect import (
    any_lane,
    load_rays,
    mt_any,
    mt_closest,
    pack_rays,
    pack_tris,
    slab,
    tile_cols,
    triton_call,
)

# Shapes chosen on an H100 (80GB HBM3, 400 W limit) on the 1M-triangle
# heightfield's AO step, among leaf tiles {16, 32} x rays per program
# {32, 64, 128} x warps {2, 4}: 16-triangle leaves and 32-ray packets
# were fastest for both walks (PERF.md, PR 1).
TC = 16  # triangles per leaf tile
RAY_BLOCK = 32  # rays per program (packet width)

# strata per cone-tiled AO block: RAY_BLOCK / CONE_K Morton-adjacent
# origins share a program with CONE_K cone-adjacent strata (untuned)
CONE_K = 4


# ---------------------------------------------------------------------------
# host build: triangle BVH -> tile-aligned leaves + node arrays
# ---------------------------------------------------------------------------


def build_tile_bvh(v0, v1, v2):
    """SAH BVH whose leaves each fill one TC-triangle tile.

    Returns (src, nbox, nmeta, n_nodes):
      src   : (n_leafpad,) int64 — source triangle id per padded slot, or
              -1 for leaf-padding slots (callers scatter their per-tri
              arrays through it; pads become degenerate zero triangles);
      nbox  : (6, M) f32 — node bbox rows [min xyz | max xyz];
      nmeta : (3, M) i32 — rows [skip, first_tile, n_tiles] (n_tiles = 0
              marks an inner node);
      n_nodes: M.
    """
    from lucille_tpu.accel.bvh import build_bvh

    bvh = build_bvh(v0, v1, v2, leaf_size=TC)
    m = len(bvh.skip)
    is_leaf = bvh.count > 0
    leaf_ids = np.flatnonzero(is_leaf)
    counts = bvh.count[leaf_ids].astype(np.int64)
    tiles_per_leaf = -(-counts // TC)
    first_tile = np.zeros(len(leaf_ids), dtype=np.int64)
    np.cumsum(tiles_per_leaf[:-1], out=first_tile[1:])
    n_tiles = int(tiles_per_leaf.sum()) if len(leaf_ids) else 1
    n_leafpad = n_tiles * TC

    # scatter each leaf's (contiguous, DFS-ordered) triangle range into
    # its padded tile slots
    src = np.full(n_leafpad, -1, dtype=np.int64)
    for li, nid in enumerate(leaf_ids):
        f = bvh.first[nid]
        c = counts[li]
        dst = first_tile[li] * TC
        src[dst : dst + c] = bvh.order[f : f + c]

    nbox = np.zeros((6, m), dtype=np.float32)
    nbox[0:3] = bvh.bbmin.T
    nbox[3:6] = bvh.bbmax.T
    nmeta = np.zeros((3, m), dtype=np.int32)
    nmeta[0] = bvh.skip
    fmap = np.zeros(m, dtype=np.int32)
    cmap = np.zeros(m, dtype=np.int32)
    fmap[leaf_ids] = first_tile
    cmap[leaf_ids] = tiles_per_leaf
    nmeta[1] = fmap
    nmeta[2] = cmap
    return src, nbox, nmeta, m


def _node_arrays(scene):
    """(8, M) f32 bbox rows [min | max | pad] with a relative 1e-6 margin
    (rounding never culls a node a triangle test would hit), and (4, M)
    i32 meta rows [skip, first_tile, n_tiles, pad]."""
    bmin = scene.node_bbmin.astype(jnp.float32)
    bmax = scene.node_bbmax.astype(jnp.float32)
    bmin = bmin - 1e-6 * (1.0 + jnp.abs(bmin))
    bmax = bmax + 1e-6 * (1.0 + jnp.abs(bmax))
    m = bmin.shape[0]
    nbox = jnp.zeros((8, m), jnp.float32)
    nbox = nbox.at[0:3].set(bmin.T).at[3:6].set(bmax.T)
    nmeta = jnp.zeros((4, m), jnp.int32)
    nmeta = nmeta.at[0].set(scene.node_skip.astype(jnp.int32))
    nmeta = nmeta.at[1].set(scene.node_first.astype(jnp.int32))
    nmeta = nmeta.at[2].set(scene.node_count.astype(jnp.int32))
    return nbox, nmeta


def _next_node(nmeta_ref, node, reach, is_leaf):
    """Skip-link step: descend (node + 1) into a reached inner node, else
    jump to skip[node].  Integer arithmetic, not a scalar select."""
    d = (reach & jnp.logical_not(is_leaf)).astype(jnp.int32)
    return d * (node + 1) + (1 - d) * nmeta_ref[0, node]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _bvh_closest_kernel(rays_ref, nbox_ref, nmeta_ref, tris_ref,
                        t_ref, u_ref, v_ref, tri_ref, stat_ref, *, n_nodes):
    rb = t_ref.shape[0]
    rays, tmax, (ivx, ivy, ivz) = load_rays(rays_ref)
    ox, oy, oz = rays[0], rays[1], rays[2]

    def cond(c):
        return c[0] < n_nodes

    def body(c):
        node, t, u, v, tri, nvis, ntile = c
        tn, tf = slab(nbox_ref, node, ox, oy, oz, ivx, ivy, ivz)
        reach = any_lane((tn <= tf) & (tf > 0.0) & (tn < t))
        ltiles = nmeta_ref[2, node]
        first = nmeta_ref[1, node]
        is_leaf = ltiles > 0
        n_test = ltiles * (reach & is_leaf).astype(jnp.int32)

        def tile(k, hit):
            base = (first + k) * TC
            return mt_closest(
                tile_cols(tris_ref, base, TC, range(9)), base, rays, *hit
            )

        t, u, v, tri = jax.lax.fori_loop(0, n_test, tile, (t, u, v, tri))
        nxt = _next_node(nmeta_ref, node, reach, is_leaf)
        return nxt, t, u, v, tri, nvis + 1, ntile + n_test

    init = (
        jnp.int32(0),
        tmax,
        jnp.zeros((rb,), jnp.float32),
        jnp.zeros((rb,), jnp.float32),
        jnp.full((rb,), -1, jnp.int32),
        jnp.int32(0),
        jnp.int32(0),
    )
    _, t, u, v, tri, nvis, ntile = jax.lax.while_loop(cond, body, init)
    t_ref[:] = t
    u_ref[:] = u
    v_ref[:] = v
    tri_ref[:] = tri
    stat_ref[0, :] = jnp.full((rb,), nvis, jnp.int32)
    stat_ref[1, :] = jnp.full((rb,), ntile, jnp.int32)


def _bvh_anyhit_kernel(rays_ref, nbox_ref, nmeta_ref, tris_ref, occ_ref,
                       stat_ref, *, n_nodes):
    rb = occ_ref.shape[0]
    rays, tmax, (ivx, ivy, ivz) = load_rays(rays_ref)
    ox, oy, oz = rays[0], rays[1], rays[2]
    wants = tmax > rays[6]  # pad and dead lanes carry an empty window

    def cond(c):
        node, occ = c[0], c[1]
        return (node < n_nodes) & any_lane(wants & (occ == 0))

    def body(c):
        node, occ, nvis, ntile = c
        tn, tf = slab(nbox_ref, node, ox, oy, oz, ivx, ivy, ivz)
        reach = any_lane(
            (tn <= tf) & (tf > 0.0) & (tn < tmax) & wants & (occ == 0)
        )
        ltiles = nmeta_ref[2, node]
        first = nmeta_ref[1, node]
        is_leaf = ltiles > 0
        n_test = ltiles * (reach & is_leaf).astype(jnp.int32)

        def tile(k, o):
            cols = tile_cols(tris_ref, (first + k) * TC, TC, range(9))
            return o | jnp.max(mt_any(cols, rays, tmax).astype(jnp.int32),
                               axis=0)

        occ = jax.lax.fori_loop(0, n_test, tile, occ)
        nxt = _next_node(nmeta_ref, node, reach, is_leaf)
        return nxt, occ, nvis + 1, ntile + n_test

    init = (jnp.int32(0), jnp.zeros((rb,), jnp.int32), jnp.int32(0),
            jnp.int32(0))
    _, occ, nvis, ntile = jax.lax.while_loop(cond, body, init)
    occ_ref[:] = occ
    stat_ref[0, :] = jnp.full((rb,), nvis, jnp.int32)
    stat_ref[1, :] = jnp.full((rb,), ntile, jnp.int32)


def _walk_specs(nbox, nmeta, tris):
    return [
        pl.BlockSpec((8, RAY_BLOCK), lambda i: (0, i)),
        pl.BlockSpec(nbox.shape, lambda i: (0, 0)),
        pl.BlockSpec(nmeta.shape, lambda i: (0, 0)),
        pl.BlockSpec(tris.shape, lambda i: (0, 0)),
    ]


def _walk_stats(stat):
    """Per-program (node visits, leaf tiles tested) summed over programs
    -> the renderer's traversal and triangle-test counters."""
    s = stat[:, ::RAY_BLOCK].astype(jnp.float32).sum(axis=1)
    return {"ntrav": s[0], "ntests": s[1] * (TC * RAY_BLOCK)}


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def pallas_bvh_closest_hit(scene, org, dirn, tmax=None, tmin: float = 0.0):
    """Closest hit through the packet walk; same contract as
    brute_closest_hit."""
    return _pallas_bvh_closest_hit(scene, org, dirn, tmax, float(tmin))


@partial(jax.jit, static_argnames=("tmin",))
def _pallas_bvh_closest_hit(scene, org, dirn, tmax=None, tmin=0.0):
    B = org.shape[0]
    tris, _ = pack_tris(scene, TC)
    nbox, nmeta = _node_arrays(scene)
    rays, Bpad = pack_rays(org, dirn, tmax, tmin, RAY_BLOCK)
    row = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    t, u, v, tri, stat = triton_call(
        partial(_bvh_closest_kernel, n_nodes=scene.n_nodes),
        grid=(Bpad // RAY_BLOCK,),
        in_specs=_walk_specs(nbox, nmeta, tris),
        out_specs=[row] * 4 + [pl.BlockSpec((2, RAY_BLOCK), lambda i: (0, i))],
        out_shape=[
            jax.ShapeDtypeStruct((Bpad,), jnp.float32),
            jax.ShapeDtypeStruct((Bpad,), jnp.float32),
            jax.ShapeDtypeStruct((Bpad,), jnp.float32),
            jax.ShapeDtypeStruct((Bpad,), jnp.int32),
            jax.ShapeDtypeStruct((2, Bpad), jnp.int32),
        ],
        name="lucille_bvh_closest",
    )(rays, nbox, nmeta, tris)
    tri = tri[:B]
    return {
        "t": t[:B],
        "u": u[:B],
        "v": v[:B],
        "tri": jnp.minimum(tri, scene.tri_v0.shape[0] - 1),
        "hit": tri >= 0,
        **_walk_stats(stat),
    }


def pallas_bvh_any_hit(scene, org, dirn, tmax=None, tmin: float = 0.0):
    """Occlusion through the packet walk; returns bool (B,)."""
    occ, _stats = _pallas_bvh_any_hit(scene, org, dirn, tmax, float(tmin))
    return occ


@partial(jax.jit, static_argnames=("tmin",))
def _pallas_bvh_any_hit(scene, org, dirn, tmax=None, tmin=0.0):
    """(occ (B,) bool, {"ntrav", "ntests"})."""
    B = org.shape[0]
    tris, _ = pack_tris(scene, TC)
    nbox, nmeta = _node_arrays(scene)
    rays, Bpad = pack_rays(org, dirn, tmax, tmin, RAY_BLOCK)
    occ, stat = triton_call(
        partial(_bvh_anyhit_kernel, n_nodes=scene.n_nodes),
        grid=(Bpad // RAY_BLOCK,),
        in_specs=_walk_specs(nbox, nmeta, tris),
        out_specs=[
            pl.BlockSpec((RAY_BLOCK,), lambda i: (i,)),
            pl.BlockSpec((2, RAY_BLOCK), lambda i: (0, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((Bpad,), jnp.int32),
            jax.ShapeDtypeStruct((2, Bpad), jnp.int32),
        ],
        name="lucille_bvh_anyhit",
    )(rays, nbox, nmeta, tris)
    return occ[:B] > 0, _walk_stats(stat)


# ---------------------------------------------------------------------------
# AO gather: cone-tiled blocks through the any-hit walk
# ---------------------------------------------------------------------------


def _stratified_dirs(b0, b1, b2, key, ntheta: int, nphi: int,
                     nreal: int | None = None):
    """All ntheta*nphi stratified hemisphere directions for every lane:
    (S, B, 3), with the fused AO kernel's arithmetic
    (pallas_ao.stratum_direction) on two per-lane uniforms drawn per
    raster lane.

    nreal bounds the uniform draw so the stream does not depend on the
    block padding (pad lanes are dead and never consume samples)."""
    from lucille_tpu.accel.pallas_ao import stratum_direction

    B = b0.shape[0]
    u = jax.random.uniform(key, (2, nreal or B), dtype=jnp.float32)
    if nreal and nreal != B:
        u = jnp.zeros((2, B), jnp.float32).at[:, :nreal].set(u)
    basis = tuple(tuple(b[:, k] for k in range(3)) for b in (b0, b1, b2))
    dirs = jax.vmap(
        lambda s: jnp.stack(
            stratum_direction(s, u[0], u[1], *basis, ntheta, nphi), axis=-1
        )
    )(jnp.arange(ntheta * nphi, dtype=jnp.int32))
    return dirs


def _stratum_tile_perm(ntheta: int, nphi: int, K: int) -> np.ndarray:
    """Permutation of the S=ntheta*nphi strata grouping cone-adjacent
    (theta, phi) cells of the stratified grid into runs of K, so each
    block spans a compact direction cone (not the whole hemisphere).
    Natural order when the grid does not tile evenly."""
    S = ntheta * nphi
    kt = max(1, int(np.sqrt(K)))
    while kt > 1 and (ntheta % kt or K % kt or nphi % (K // kt)):
        kt -= 1
    kp = K // kt
    if ntheta % kt or nphi % kp:
        return np.arange(S, dtype=np.int32)
    perm = []
    for jt in range(nphi // kp):
        for it in range(ntheta // kt):
            for jj in range(kp):
                for ii in range(kt):
                    perm.append((it * kt + ii) + ntheta * (jt * kp + jj))
    return np.asarray(perm, dtype=np.int32)


def _conetile_rays(scene, P_off, b0, b1, b2, hit, key, ntheta, nphi):
    """Gather rays in cone-tiled block order: returns (origins (S*Bpad,
    3), dirs (S*Bpad, 3), origin sort order, layout (NG, G, S, Bpad, B)).
    Lane layout is (origin group NG, stratum tile, k, g): each RAY_BLOCK
    block holds G Morton-adjacent origins times K cone-adjacent strata."""
    from lucille_tpu.accel.pallas_ao import compaction_order

    B = P_off.shape[0]
    S = ntheta * nphi
    K = CONE_K
    while K > 1 and (S % K or RAY_BLOCK % K):
        K //= 2
    G = RAY_BLOCK // K
    Bpad = -(-B // RAY_BLOCK) * RAY_BLOCK

    if Bpad != B:
        hit_w = jnp.zeros((Bpad,), hit.dtype).at[:B].set(hit)
        pad3 = lambda a: jnp.zeros((Bpad, 3), a.dtype).at[:B].set(a)
        P_off, b0, b1, b2 = pad3(P_off), pad3(b0), pad3(b1), pad3(b2)
    else:
        hit_w = hit
    order, _nhit = compaction_order(scene, P_off, b2, hit_w, 1 << 20)

    d_all = _stratified_dirs(b0, b1, b2, key, ntheta, nphi, B)  # (S,Bpad,3)
    # park dead lanes outside the scene, pointing away, so blocks of them
    # fail the root slab test at once
    diag = scene.bbox_max - scene.bbox_min
    o = jnp.where(hit_w[:, None], P_off, (scene.bbox_min - diag - 1.0)[None])
    d_all = jnp.where(
        hit_w[None, :, None], d_all, jnp.asarray([0.0, 0.0, -1.0])
    )

    o_s = o[order]
    d_s = d_all[:, order]
    d_s = d_s[jnp.asarray(_stratum_tile_perm(ntheta, nphi, K))]

    NG = Bpad // G
    ST = S // K
    dd = (
        d_s.reshape(ST, K, NG, G, 3)
        .transpose(2, 0, 1, 3, 4)
        .reshape(S * Bpad, 3)
    )
    oo = jnp.broadcast_to(
        o_s.reshape(NG, 1, 1, G, 3), (NG, ST, K, G, 3)
    ).reshape(S * Bpad, 3)
    return oo, dd, order, (NG, G, S, Bpad, B)


@partial(jax.jit, static_argnames=("ntheta", "nphi"))
def pallas_bvh_ao_occlusion(scene, P_off, b0, b1, b2, hit, key,
                            ntheta: int, nphi: int):
    """Occlusion counts of ntheta*nphi stratified hemisphere rays per
    primary hit, through the any-hit walk on cone-tiled blocks.  Returns
    ((B,) f32 counts, {"ntrav", "ntests"}).

    A block of Morton-adjacent origins times cone-adjacent strata is
    compact in position and direction, so one walk serves RAY_BLOCK
    gather rays with a tight leaf union."""
    oo, dd, order, (NG, G, S, Bpad, B) = _conetile_rays(
        scene, P_off, b0, b1, b2, hit, key, ntheta, nphi
    )
    occ_flat, stats = _pallas_bvh_any_hit(scene, oo, dd, None, 0.0)
    occ_g = (
        occ_flat.astype(jnp.float32).reshape(NG, S, G).sum(axis=1).reshape(-1)
    )
    occ = jnp.zeros((Bpad,), jnp.float32).at[order].set(occ_g)
    return occ[:B] * hit.astype(jnp.float32), stats


def pallas_bvh_ao_sky(scene, P_off, b0, b1, b2, hit, key, ntheta: int,
                      nphi: int, sky):
    """Sunsky-AO gather on the cone-tiled walk: every unoccluded stratum
    adds the Preetham sky radiance along its direction
    (ambientocclusion.c:154-332's gather_sunsky).  Returns (B, 3) summed
    sky radiance."""
    oo, dd, order, (NG, G, S, Bpad, B) = _conetile_rays(
        scene, P_off, b0, b1, b2, hit, key, ntheta, nphi
    )
    occ_flat, _stats = _pallas_bvh_any_hit(scene, oo, dd, None, 0.0)
    vis = jnp.logical_not(occ_flat).astype(jnp.float32)
    # world (y-up) -> sky model (z-up): lightsource.c:152-155's y/z swap
    d_sky = jnp.stack([dd[:, 0], dd[:, 2], dd[:, 1]], axis=-1)
    col_g = (vis[:, None] * sky.sky_rgb(d_sky)).reshape(NG, S, G, 3).sum(axis=1)
    col = jnp.zeros((Bpad, 3), jnp.float32).at[order].set(col_g.reshape(-1, 3))
    return col[:B] * hit.astype(jnp.float32)[:, None]
