"""Dense Moller-Trumbore intersection: every ray against every triangle.

The plain intersector for small scenes and the correctness oracle for
every other one (SURVEY.md section 7 step 3).  The (B rays x N tris)
test grid is perfectly regular elementwise work — no divergence, no gathers — so
XLA fuses the whole Moller-Trumbore chain (bvh.c:731-791 semantics:
non-culling, |det| > eps, u,v in [0,1], u+v <= 1, 0 < t < t_best) into a
streamed scan over triangle chunks.

Chunking bounds peak memory: state carries the running best hit per ray;
each scan step materializes only (B, CHUNK) intermediates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DET_EPS = 1.0e-14  # reference triangle_isect eps (bvh.c:746)
CHUNK = 256  # triangles per scan step; must divide the padded count


def _tcap(B, tmax):
    """Per-ray t ceiling: scalar, (B,) array, or None (= +inf)."""
    if tmax is None:
        return jnp.full((B,), jnp.inf, dtype=jnp.float32)
    return jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (B,))


def _mt_chunk(org, dirn, v0, e1, e2, t_best):
    """Moller-Trumbore for a (B, C) grid.

    org, dirn: (B, 3); v0/e1/e2: (C, 3); t_best: (B,).
    Returns (t, u, v, hit) each (B, C); non-hits have t = +inf.
    """
    # pvec = dir x e2 : (B, C, 3)
    d = dirn[:, None, :]
    p = jnp.cross(d, e2[None, :, :])
    a = jnp.sum(e1[None] * p, axis=-1)  # (B, C) determinant
    valid = jnp.abs(a) > DET_EPS
    inva = jnp.where(valid, 1.0 / jnp.where(valid, a, 1.0), 0.0)
    s = org[:, None, :] - v0[None]  # (B, C, 3)
    q = jnp.cross(s, e1[None, :, :])
    u = jnp.sum(s * p, axis=-1) * inva
    v = jnp.sum(q * d, axis=-1) * inva
    t = jnp.sum(e2[None] * q, axis=-1) * inva
    hit = (
        valid
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
        & (t < t_best[:, None])
    )
    t = jnp.where(hit, t, jnp.inf)
    return t, u, v, hit


def brute_closest_hit(scene, org, dirn, tmax=None, tmin: float = 0.0):
    """Closest hit of rays (B, 3) against the whole padded triangle array.

    Returns dict with t (B,), u, v (B,), tri (B,) i32 (-1 = miss),
    hit (B,) bool.  `tmin` shifts the acceptance window (ray-offset
    epsilon is usually applied to the origin instead, as the reference
    does at ambientocclusion.c:70).
    """
    B = org.shape[0]
    n_pad = scene.tri_v0.shape[0]
    nchunks = n_pad // CHUNK
    v0 = scene.tri_v0.reshape(nchunks, CHUNK, 3)
    e1 = scene.tri_e1.reshape(nchunks, CHUNK, 3)
    e2 = scene.tri_e2.reshape(nchunks, CHUNK, 3)

    t0 = _tcap(B, tmax)
    init = (
        t0,
        jnp.zeros((B,), jnp.float32),  # u
        jnp.zeros((B,), jnp.float32),  # v
        jnp.full((B,), -1, jnp.int32),  # tri
    )

    def step(carry, chunk):
        t_best, u_best, v_best, tri_best = carry
        cv0, ce1, ce2, base = chunk
        t, u, v, hit = _mt_chunk(org, dirn, cv0, ce1, ce2, t_best)
        t = jnp.where(t > tmin, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)  # (B,) best in chunk
        rows = jnp.arange(B)
        tc = t[rows, j]
        better = tc < t_best
        t_best = jnp.where(better, tc, t_best)
        u_best = jnp.where(better, u[rows, j], u_best)
        v_best = jnp.where(better, v[rows, j], v_best)
        tri_best = jnp.where(better, base + j.astype(jnp.int32), tri_best)
        return (t_best, u_best, v_best, tri_best), None

    bases = (jnp.arange(nchunks, dtype=jnp.int32) * CHUNK)
    (t, u, v, tri), _ = jax.lax.scan(step, init, (v0, e1, e2, bases))
    hit = tri >= 0
    return {
        "t": t,
        "u": u,
        "v": v,
        "tri": tri,
        "hit": hit,
        # static: dense grid, host-side count (float: B x N overflows
        # int32 on large scenes)
        "ntests": float(B) * scene.n_tris,
        "ntrav": 0,
    }


def brute_any_hit(scene, org, dirn, tmax=None, tmin: float = 0.0):
    """Occlusion query: True where any triangle blocks the ray in
    (tmin, tmax).  Same scan as closest-hit minus the bookkeeping; XLA
    drops the unused u/v math."""
    B = org.shape[0]
    n_pad = scene.tri_v0.shape[0]
    nchunks = n_pad // CHUNK
    v0 = scene.tri_v0.reshape(nchunks, CHUNK, 3)
    e1 = scene.tri_e1.reshape(nchunks, CHUNK, 3)
    e2 = scene.tri_e2.reshape(nchunks, CHUNK, 3)

    tcap = _tcap(B, tmax)

    def step(occluded, chunk):
        cv0, ce1, ce2 = chunk
        t, _, _, hit = _mt_chunk(org, dirn, cv0, ce1, ce2, tcap)
        hit = hit & (t > tmin)
        return occluded | jnp.any(hit, axis=-1), None

    occ0 = jnp.zeros((B,), dtype=bool)
    occluded, _ = jax.lax.scan(step, occ0, (v0, e1, e2))
    return occluded
