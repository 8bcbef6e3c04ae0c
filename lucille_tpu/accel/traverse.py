"""Per-ray BVH walks in plain JAX over the tile-BVH arrays.

Two uses:

- ``walk_closest_hit`` / ``walk_any_hit``: the plain XLA version of the
  packet-walk kernels (accel/pallas_bvh.py) — every ray runs its own
  skip-link walk inside one ``lax.while_loop`` over the wavefront, one
  node step or one triangle test per iteration.  It is what the kernels
  are measured against on the card (chip_smoke.py);
- ``bvh_diag``: the reference's opt-in traversal diagnostics
  (ri_bvh_diag_t, bvh.h:95-104) for the BVH visualizer
  (tools_tpu/bvh_viz.py): node visits / leaf visits / triangle tests for
  EACH ray, which the block-level kernels cannot report.

Node layout: skip-link DFS arrays over tile-aligned leaves
(accel/pallas_bvh.build_tile_bvh): node_first/node_count are in TILE
units; a leaf's triangles occupy [first*TC, (first+count)*TC) with
degenerate zero-triangle padding that can never hit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lucille_tpu.accel.bruteforce import DET_EPS, _tcap
from lucille_tpu.accel.pallas_bvh import TC

SLAB_EPS = 1.0e-6


def _gather3(arr, idx):
    return arr[idx]  # (B, 3) gather by node/tri index


def _slab_test(bbmin, bbmax, org, inv_dir, t_best):
    """Ray-AABB slab test (test_ray_aabb, bvh.c:870). Returns bool (B,)."""
    t0 = (bbmin - org) * inv_dir
    t1 = (bbmax - org) * inv_dir
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tnear <= tfar + SLAB_EPS) & (tfar > 0.0) & (tnear < t_best)


def _mt_single(org, dirn, v0, e1, e2):
    """Moller-Trumbore for one gathered triangle per ray: all (B, 3)."""
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
        & (t > 0.0)
    )
    return t, u, v, hit


def _walk(scene, org, dirn, tmax, tmin, occlusion: bool):
    """Per-ray skip-link walk; one node step or one leaf-triangle test
    per ray per iteration (k >= 0: testing triangle k of the leaf)."""
    B = org.shape[0]
    DONE = scene.n_nodes
    ntri = scene.tri_v0.shape[0]
    inv_dir = 1.0 / jnp.where(jnp.abs(dirn) > 1e-20, dirn, 1e-20)
    tcap = _tcap(B, tmax)
    zi = jnp.zeros((B,), jnp.int32)
    state = dict(
        node=zi, k=zi - 1, t=tcap, u=tcap * 0.0, v=tcap * 0.0, tri=zi - 1,
        occ=jnp.zeros((B,), bool),
    )

    def live(s):
        a = s["node"] < DONE
        return a & ~s["occ"] if occlusion else a

    def body(s):
        node, k = s["node"], s["k"]
        active = live(s)
        idx = jnp.minimum(node, DONE - 1)
        count = scene.node_count[idx] * TC  # leaf triangle slots
        skip = scene.node_skip[idx]
        in_leaf = k >= 0

        tri = jnp.clip(scene.node_first[idx] * TC + k, 0, ntri - 1)
        t, u, v, hit = _mt_single(
            org, dirn, scene.tri_v0[tri], scene.tri_e1[tri],
            scene.tri_e2[tri],
        )
        hit = active & in_leaf & hit & (t > tmin) & (t < s["t"])
        if occlusion:
            occ = s["occ"] | hit
            t_best, u_best, v_best, tri_best = s["t"], s["u"], s["v"], s["tri"]
        else:
            occ = s["occ"]
            t_best = jnp.where(hit, t, s["t"])
            u_best = jnp.where(hit, u, s["u"])
            v_best = jnp.where(hit, v, s["v"])
            tri_best = jnp.where(hit, tri, s["tri"])

        box = _slab_test(
            _gather3(scene.node_bbmin, idx), _gather3(scene.node_bbmax, idx),
            org, inv_dir, s["t"],
        )
        is_leaf = count > 0
        leaf_done = k + 1 >= count
        enter = ~in_leaf & box & is_leaf
        descend = ~in_leaf & box & ~is_leaf
        nxt = jnp.where(
            in_leaf,
            jnp.where(leaf_done, skip, node),
            jnp.where(enter, node, jnp.where(descend, node + 1, skip)),
        )
        k_next = jnp.where(
            in_leaf, jnp.where(leaf_done, -1, k + 1), jnp.where(enter, 0, -1)
        )
        return dict(
            node=jnp.where(active, nxt, DONE), k=k_next, t=t_best,
            u=u_best, v=v_best, tri=tri_best, occ=occ,
        )

    return jax.lax.while_loop(lambda s: jnp.any(live(s)), body, state)


def walk_closest_hit(scene, org, dirn, tmax=None, tmin: float = 0.0):
    """Closest hit by per-ray walks; same contract as brute_closest_hit."""
    s = _walk(scene, org, dirn, tmax, tmin, occlusion=False)
    return {
        "t": s["t"],
        "u": s["u"],
        "v": s["v"],
        "tri": s["tri"],
        "hit": s["tri"] >= 0,
        "ntests": 0,
        "ntrav": 0,
    }


def walk_any_hit(scene, org, dirn, tmax=None, tmin: float = 0.0):
    """Occlusion by per-ray walks; returns bool (B,)."""
    return _walk(scene, org, dirn, tmax, tmin, occlusion=True)["occ"]


def bvh_diag(scene, org, dirn):
    """Per-ray traversal diagnostics (ri_bvh_diag_t, bvh.h:95-104): node
    visits, leaf visits and triangle tests per query, feeding the BVH
    visualizer.  Returns the closest-hit dict plus per-ray counters
    'nvisits', 'nleafs', 'ntris' (B,) i32."""
    B = org.shape[0]
    n_nodes = scene.n_nodes
    DONE = n_nodes

    inv_dir = 1.0 / jnp.where(jnp.abs(dirn) > 1e-20, dirn, 1e-20)
    z = org[..., 0] * 0.0
    zi = z.astype(jnp.int32)
    state = dict(
        node=zi,
        t=_tcap(B, None) + z,
        tri=zi - 1,
        nvisits=zi,
        nleafs=zi,
        ntris=zi,
    )

    def cond(s):
        return jnp.any(s["node"] < DONE)

    def body(s):
        node = s["node"]
        active = node < DONE
        idx = jnp.minimum(node, DONE - 1)
        bbmin = _gather3(scene.node_bbmin, idx)
        bbmax = _gather3(scene.node_bbmax, idx)
        skip = scene.node_skip[idx]
        first = scene.node_first[idx]  # tile units (pallas_bvh layout)
        count = scene.node_count[idx]
        box_hit = active & _slab_test(bbmin, bbmax, org, inv_dir, s["t"])
        is_leaf = count > 0
        test_leaf = box_hit & is_leaf

        ntri_max = jnp.max(jnp.where(test_leaf, count, 0)) * TC

        def leaf_k(k, carry):
            t_best, tri_best, ntris = carry
            m = test_leaf & (k < count * TC)
            tri = jnp.minimum(first * TC + k, scene.tri_v0.shape[0] - 1)
            t, _, _, hit = _mt_single(
                org,
                dirn,
                _gather3(scene.tri_v0, tri),
                _gather3(scene.tri_e1, tri),
                _gather3(scene.tri_e2, tri),
            )
            better = m & hit & (t > 0.0) & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            tri_best = jnp.where(better, tri, tri_best)
            ntris = ntris + m.astype(jnp.int32)
            return t_best, tri_best, ntris

        t_best, tri_best, ntris = jax.lax.fori_loop(
            0, ntri_max, leaf_k, (s["t"], s["tri"], s["ntris"])
        )

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, idx + 1, skip)
        return dict(
            node=jnp.where(active, nxt, DONE),
            t=t_best,
            tri=tri_best,
            nvisits=s["nvisits"] + active.astype(jnp.int32),
            nleafs=s["nleafs"] + test_leaf.astype(jnp.int32),
            ntris=ntris,
        )

    s = jax.lax.while_loop(cond, body, state)
    return {
        "t": s["t"],
        "tri": s["tri"],
        "hit": s["tri"] >= 0,
        "nvisits": s["nvisits"],
        "nleafs": s["nleafs"],
        "ntris": s["ntris"],
    }
