"""Moller-Trumbore as a matmul: ray-triangle intersection through
dot_general (the accel tag and module name "mxu" are historical).

The CPU test mesh's default intersector, and one of the plain XLA
versions the Triton kernels are measured against (PERF.md).

Derivation: for ray (o, d) and triangle (v0, e1, e2) with ng = e1 x e2,
Moller-Trumbore's quantities are scalar triple products, each TRILINEAR
in (ray terms) x (triangle terms):

    a  = d . (e2 x e1)              = -d . ng            (determinant)
    u' = det(s, d, e2), s = o - v0  = (o x d) . e2  -  d . (e2 x v0)
    v' = det(d, s, e1)              = -(o x d) . e1 +  d . (e1 x v0)
    t' = s . ng                     =  o . ng  -  v0 . ng

with u = u'/a, v = v'/a, t = t'/a.  Every term is a dot product of a
per-RAY feature with a per-TRIANGLE constant.  Stacking the ray features

    F = [ d, o x d, o, 1 ]                      (B, 10)

and the per-triangle coefficient columns

    W = [ [-ng, 0, 0, 0], [-(e2 x v0), e2, 0, 0],
          [(e1 x v0), -e1, 0, 0], [0, 0, ng, -v0.ng] ]   (10, 4C)

gives ALL FOUR quantities for a whole triangle chunk as ONE matmul
F @ W -> (B, 4C) at f32 accumulation, followed by a small elementwise
epilogue (divide, window tests, argmin reduction).  The (B, 4C) product
goes through device memory before the epilogue reads it.

The chunk loop is a lax.scan (bounded memory); W is precomputed once per
scene on device ("compile" step) and cached on the SceneArrays via the
renderer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lucille_tpu.accel.bruteforce import DET_EPS, _tcap

CHUNK = 512  # triangles per matmul; (B, 4*512) f32 epilogue tiles


def _center(scene):
    """Conditioning: triple products like o.ng - v0.ng cancel
    catastrophically in f32 when coordinates are large; re-centering the
    scene at its bbox midpoint keeps magnitudes small.  The math is
    translation-invariant, so both W and the ray features subtract it."""
    return 0.5 * (scene.bbox_min + scene.bbox_max)


def build_tri_matrix(scene):
    """Precompute W (nchunks, 10, 4*CHUNK) from the padded triangle SoA."""
    v0 = scene.tri_v0 - _center(scene)[None, :]
    e1 = scene.tri_e1
    e2 = scene.tri_e2
    ng = jnp.cross(e1, e2)  # (N, 3)
    n = v0.shape[0]
    pad = (-n) % CHUNK
    if pad:
        zeros = jnp.zeros((pad, 3), v0.dtype)
        v0 = jnp.concatenate([v0, zeros])
        e1 = jnp.concatenate([e1, zeros])
        e2 = jnp.concatenate([e2, zeros])
        ng = jnp.concatenate([ng, zeros])
    N = v0.shape[0]

    z3 = jnp.zeros_like(v0)
    z1 = jnp.zeros((N, 1), v0.dtype)
    one = jnp.ones((N, 1), v0.dtype)
    del one

    def col(wd, woxd, wo, wc):
        # per-triangle column of 10 coefficients: [d(3), oxd(3), o(3), 1]
        return jnp.concatenate([wd, woxd, wo, wc], axis=-1)  # (N, 10)

    W_a = col(-ng, z3, z3, z1)
    W_u = col(-jnp.cross(e2, v0), e2, z3, z1)
    W_v = col(jnp.cross(e1, v0), -e1, z3, z1)
    W_t = col(z3, z3, ng, -jnp.sum(v0 * ng, axis=-1, keepdims=True))

    # (N, 4, 10) -> (nchunks, 10, 4*CHUNK): quantities interleaved per
    # chunk as [a-block | u-block | v-block | t-block] along the minor dim
    W = jnp.stack([W_a, W_u, W_v, W_t], axis=1)  # (N, 4, 10)
    nchunks = N // CHUNK
    W = W.reshape(nchunks, CHUNK, 4, 10)
    W = W.transpose(0, 3, 2, 1).reshape(nchunks, 10, 4 * CHUNK)
    return W


def _ray_features(scene, org, dirn):
    B = org.shape[0]
    o = org - _center(scene)[None, :]
    return jnp.concatenate(
        [dirn, jnp.cross(o, dirn), o, jnp.ones((B, 1), org.dtype)],
        axis=-1,
    )  # (B, 10)


def mxu_closest_hit(scene, org, dirn, tmax=None, tmin: float = 0.0, W=None):
    """Closest hit via the matmul formulation.  Same contract as
    brute_closest_hit."""
    B = org.shape[0]
    if W is None:
        W = build_tri_matrix(scene)
    F = _ray_features(scene, org, dirn)

    t0 = _tcap(B, tmax)
    init = (
        t0,
        jnp.zeros((B,), jnp.float32),
        jnp.zeros((B,), jnp.float32),
        jnp.full((B,), -1, jnp.int32),
    )
    bases = jnp.arange(W.shape[0], dtype=jnp.int32) * CHUNK

    def step(carry, chunk):
        t_best, u_best, v_best, tri_best = carry
        Wc, base = chunk
        # THE matmul: (B, 10) @ (10, 4C), f32 accumulation.  HIGHEST
        # precision: a reduced-precision f32 matmul (bf16 passes, or TF32
        # on a GPU) visibly distorts hit geometry — triple products of
        # scene coordinates cancel catastrophically.
        quad = jax.lax.dot_general(
            F,
            Wc,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(B, 4, CHUNK)
        a = quad[:, 0]
        up = quad[:, 1]
        vp = quad[:, 2]
        tp = quad[:, 3]
        valid = jnp.abs(a) > DET_EPS
        inva = jnp.where(valid, 1.0 / jnp.where(valid, a, 1.0), 0.0)
        u = up * inva
        v = vp * inva
        t = tp * inva
        hit = (
            valid
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > tmin)
            & (t < t_best[:, None])
        )
        t = jnp.where(hit, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        rows = jnp.arange(B)
        tc = t[rows, j]
        better = tc < t_best
        t_best = jnp.where(better, tc, t_best)
        u_best = jnp.where(better, u[rows, j], u_best)
        v_best = jnp.where(better, v[rows, j], v_best)
        tri_best = jnp.where(better, base + j.astype(jnp.int32), tri_best)
        return (t_best, u_best, v_best, tri_best), None

    (t, u, v, tri), _ = jax.lax.scan(step, init, (W, bases))
    # clamp pad-range indices (pad tris have ng = 0 => can never hit)
    return {
        "t": t,
        "u": u,
        "v": v,
        "tri": jnp.minimum(tri, scene.tri_v0.shape[0] - 1),
        "hit": tri >= 0,
        "ntests": jnp.float32(float(B) * scene.n_tris),
        "ntrav": 0,
    }


def mxu_any_hit(scene, org, dirn, tmax=None, tmin: float = 0.0, W=None):
    """Occlusion query via the matmul formulation."""
    B = org.shape[0]
    if W is None:
        W = build_tri_matrix(scene)
    F = _ray_features(scene, org, dirn)
    tcap = _tcap(B, tmax)

    def step(occluded, Wc):
        # HIGHEST precision: see mxu_closest_hit.
        quad = jax.lax.dot_general(
            F,
            Wc,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(B, 4, CHUNK)
        a = quad[:, 0]
        up = quad[:, 1]
        vp = quad[:, 2]
        tp = quad[:, 3]
        valid = jnp.abs(a) > DET_EPS
        inva = jnp.where(valid, 1.0 / jnp.where(valid, a, 1.0), 0.0)
        u = up * inva
        v = vp * inva
        t = tp * inva
        hit = (
            valid
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > tmin)
            & (t < tcap[:, None])
        )
        return occluded | jnp.any(hit, axis=-1), None

    occ0 = jnp.zeros((B,), bool)
    occluded, _ = jax.lax.scan(step, occ0, W)
    return occluded
