"""Uniform-grid accelerator: host CSR build + wavefront 3D-DDA traversal.

Completes the reference's `src/render/ugrid.c` row of the component
inventory — and goes further: the reference's `ri_ugrid_intersect` is a
stub (`return 0`, ugrid.c:376-385), so only its BVH ever traced; this
grid actually intersects.

Design notes vs the reference:
- Build (host NumPy, like the SAH BVH builder): triangles are rasterized
  into the cells their bounding boxes overlap, then flattened into a CSR
  layout (`cell_start` offsets into `tri_idx`) — the device-side stand-in
  for ugrid.c's per-cell pointer lists.  The reference uses a fixed 64^3
  grid with a blocked/Z-order cell layout for CPU cache locality
  (ugrid.c:745-760); HBM has no such small-block cache, so cells are
  indexed linearly and the resolution follows the usual lambda-density
  heuristic (res ~ cbrt(2N), capped at 64).
- Traversal (JAX, jit-compatible): the whole wavefront advances in
  lock-step inside one `lax.while_loop`, each ray running the
  Amanatides-Woo 3D-DDA.  Per step a ray either tests a chunk of K=4
  triangles from its current cell (the vector analog of the reference's
  4-wide SIMD triangle packets, ugrid.c:657-700) or steps to the next
  cell along the smallest boundary distance.  Closest-hit rays terminate
  early once the best hit precedes the next cell boundary
  (t_best <= min(tmax_xyz)); occlusion rays terminate on first hit.
- Statistics: triangle tests and cell traversals are counted like
  ri_statistic_t's ntesttris/ngridtravs (render.h:40-47).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from lucille_tpu.accel.bruteforce import DET_EPS, _tcap

K = 4  # triangles tested per wavefront step (4-wide packets, ugrid.c:657)
MAX_RES = 64  # the reference's grid resolution (ugrid.c GRIDSIZE)
_BIG = 1.0e30


@dataclass
class UGridData:
    cell_start: np.ndarray  # (res^3 + 1,) i32 CSR offsets
    tri_idx: np.ndarray  # (M,) i32 triangle ids, cell-major
    bbmin: np.ndarray  # (3,) f32 grid bounds (scene bbox + margin)
    bbmax: np.ndarray  # (3,) f32
    res: int  # cells per axis (cubic, like the reference)


def build_ugrid(v0, v1, v2, density: float = 2.0, max_res: int = MAX_RES) -> UGridData:
    """Host-side grid build: triangle-bbox rasterization into a CSR table."""
    n = len(v0)
    allv = np.concatenate([v0, v1, v2]) if n else np.zeros((1, 3))
    bbmin = allv.min(axis=0).astype(np.float64)
    bbmax = allv.max(axis=0).astype(np.float64)
    diag = float(np.linalg.norm(bbmax - bbmin))
    margin = max(diag, 1.0) * 1.0e-4
    bbmin -= margin
    bbmax += margin
    res = int(np.clip(round((density * max(n, 1)) ** (1.0 / 3.0)), 2, max_res))
    w = (bbmax - bbmin) / res

    if n == 0:
        return UGridData(
            cell_start=np.zeros(res**3 + 1, np.int32),
            tri_idx=np.zeros(1, np.int32),
            bbmin=bbmin.astype(np.float32),
            bbmax=bbmax.astype(np.float32),
            res=res,
        )

    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    lo = np.clip(((tmin - bbmin) / w).astype(np.int64), 0, res - 1)
    hi = np.clip(((tmax - bbmin) / w).astype(np.int64), 0, res - 1)

    cell_ids = []
    tri_ids = []
    for i in range(n):
        xs = np.arange(lo[i, 0], hi[i, 0] + 1)
        ys = np.arange(lo[i, 1], hi[i, 1] + 1)
        zs = np.arange(lo[i, 2], hi[i, 2] + 1)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        ids = (gx + res * (gy + res * gz)).ravel()
        cell_ids.append(ids)
        tri_ids.append(np.full(len(ids), i, dtype=np.int64))
    cell_ids = np.concatenate(cell_ids)
    tri_ids = np.concatenate(tri_ids)
    order = np.argsort(cell_ids, kind="stable")
    cell_ids = cell_ids[order]
    tri_ids = tri_ids[order]
    cell_start = np.searchsorted(
        cell_ids, np.arange(res**3 + 1, dtype=np.int64)
    ).astype(np.int32)
    return UGridData(
        cell_start=cell_start,
        tri_idx=tri_ids.astype(np.int32),
        bbmin=bbmin.astype(np.float32),
        bbmax=bbmax.astype(np.float32),
        res=res,
    )


def _mt_single(org, dirn, v0, e1, e2):
    """Moller-Trumbore, one gathered triangle per ray; all (B, 3)."""
    p = jnp.cross(dirn, e2)
    a = jnp.sum(e1 * p, axis=-1)
    valid = jnp.abs(a) > DET_EPS
    inva = jnp.where(valid, 1.0 / jnp.where(valid, a, 1.0), 0.0)
    s = org - v0
    q = jnp.cross(s, e1)
    u = jnp.sum(s * p, axis=-1) * inva
    v = jnp.sum(q * dirn, axis=-1) * inva
    t = jnp.sum(e2 * q, axis=-1) * inva
    hit = (
        valid
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
    )
    return t, u, v, hit


def _dda_init(scene, org, dirn):
    """Ray-vs-grid entry: returns (alive, cell (B,3) i32, tmaxv (B,3),
    tdelta (B,3), step (B,3) i32)."""
    gmin = scene.grid_bbmin
    gmax = scene.grid_bbmax
    res = scene.grid_res
    w = (gmax - gmin) / res

    safe = jnp.abs(dirn) > 1.0e-20
    invd = jnp.where(safe, 1.0 / jnp.where(safe, dirn, 1.0), _BIG)

    t0 = (gmin - org) * invd
    t1 = (gmax - org) * invd
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    alive = (tnear <= tfar) & (tfar > 0.0)

    t_enter = jnp.maximum(tnear, 0.0)
    p = org + (t_enter + 1.0e-6)[:, None] * dirn
    cell = jnp.clip(
        jnp.floor((p - gmin) / w).astype(jnp.int32), 0, res - 1
    )

    step = jnp.where(dirn > 0, 1, jnp.where(dirn < 0, -1, 0)).astype(jnp.int32)
    next_b = gmin + (cell + (step > 0)).astype(jnp.float32) * w
    tmaxv = jnp.where(step != 0, (next_b - org) * invd, _BIG)
    tdelta = jnp.where(step != 0, w * jnp.abs(invd), _BIG)
    return alive, cell, tmaxv, tdelta, step


def _cell_range(scene, cell):
    res = scene.grid_res
    cid = cell[:, 0] + res * (cell[:, 1] + res * cell[:, 2])
    start = scene.grid_cell_start[cid]
    end = scene.grid_cell_start[cid + 1]
    return start, end


def _traverse(scene, org, dirn, tmax, tmin, any_hit: bool):
    B = org.shape[0]
    t_cap = _tcap(B, tmax)
    alive, cell, tmaxv, tdelta, step = _dda_init(scene, org, dirn)
    cursor, cend = _cell_range(scene, cell)
    cursor = jnp.where(alive, cursor, 0)
    cend = jnp.where(alive, cend, 0)
    M = scene.grid_tri_idx.shape[0]

    state = dict(
        alive=alive,
        cell=cell,
        tmaxv=tmaxv,
        cursor=cursor,
        cend=cend,
        t=jnp.full((B,), jnp.inf, jnp.float32),
        u=jnp.zeros((B,), jnp.float32),
        v=jnp.zeros((B,), jnp.float32),
        tri=jnp.full((B,), -1, jnp.int32),
        ntests=jnp.zeros((), jnp.int32),
        ntrav=jnp.zeros((), jnp.int32),
    )

    def cond(st):
        return jnp.any(st["alive"])

    def body(st):
        alive = st["alive"]
        testing = alive & (st["cursor"] < st["cend"])

        t_best = st["t"]
        u_b, v_b, tri_b = st["u"], st["v"], st["tri"]
        found = jnp.zeros((B,), jnp.bool_)
        # --- triangle phase: K packed tests from the current cell
        for k in range(K):
            j = st["cursor"] + k
            m = testing & (j < st["cend"])
            ti = scene.grid_tri_idx[jnp.clip(j, 0, M - 1)]
            tt, uu, vv, hh = _mt_single(
                org, dirn, scene.tri_v0[ti], scene.tri_e1[ti], scene.tri_e2[ti]
            )
            ok = m & hh & (tt > tmin) & (tt < t_best) & (tt < t_cap)
            t_best = jnp.where(ok, tt, t_best)
            u_b = jnp.where(ok, uu, u_b)
            v_b = jnp.where(ok, vv, v_b)
            tri_b = jnp.where(ok, ti, tri_b)
            found = found | ok
        ntests = st["ntests"] + jnp.sum(
            jnp.minimum(
                jnp.maximum(st["cend"] - st["cursor"], 0), K
            ) * testing.astype(jnp.int32)
        )
        cursor = jnp.where(testing, st["cursor"] + K, st["cursor"])

        # --- DDA phase for rays whose cell is exhausted
        adv = alive & ~testing
        tmin3 = jnp.min(st["tmaxv"], axis=-1)
        # closest hit: the best hit precedes the next cell => final;
        # also final once the next cell starts beyond the t window
        settled = adv & ((t_best <= tmin3) | (tmin3 > t_cap))
        axis = jnp.argmin(st["tmaxv"], axis=-1)
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        cell = st["cell"] + jnp.where(adv[:, None], step * onehot, 0)
        tmaxv = st["tmaxv"] + jnp.where(
            adv[:, None], tdelta * onehot.astype(jnp.float32), 0.0
        )
        out = jnp.any((cell < 0) | (cell >= scene.grid_res), axis=-1)
        alive_n = alive & ~(adv & (settled | out))
        if any_hit:
            alive_n = alive_n & ~found
        # new cell's triangle range for rays that stepped and survived
        moved = adv & alive_n
        cc = jnp.clip(cell, 0, scene.grid_res - 1)
        s2, e2_ = _cell_range(scene, cc)
        cursor = jnp.where(moved, s2, cursor)
        cend = jnp.where(moved, e2_, st["cend"])
        ntrav = st["ntrav"] + jnp.sum(adv.astype(jnp.int32))

        return dict(
            alive=alive_n,
            cell=cell,
            tmaxv=tmaxv,
            cursor=cursor,
            cend=cend,
            t=t_best,
            u=u_b,
            v=v_b,
            tri=tri_b,
            ntests=ntests,
            ntrav=ntrav,
        )

    st = jax.lax.while_loop(cond, body, state)
    hit = st["tri"] >= 0
    return {
        "t": st["t"],
        "u": st["u"],
        "v": st["v"],
        "tri": jnp.maximum(st["tri"], 0),
        "hit": hit,
        "ntests": st["ntests"],
        "ntrav": st["ntrav"],
    }


def ugrid_closest_hit(scene, org, dirn, tmax=None, tmin: float = 0.0):
    """Closest hit via 3D-DDA; matches the dispatch contract."""
    return _traverse(scene, org, dirn, tmax, tmin, any_hit=False)


def ugrid_any_hit(scene, org, dirn, tmax=None, tmin: float = 0.0):
    """Occlusion query via 3D-DDA with first-hit early out."""
    res = _traverse(scene, org, dirn, tmax, tmin, any_hit=True)
    return res["hit"]
