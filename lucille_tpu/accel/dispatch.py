"""Accel dispatch: route intersection queries to the bound structure.

Equivalent of the reference's ri_accel_t vtable + ri_raytrace
(accel.h:43-89, raytrace.c:31-69): the scene's `accel` tag (static
metadata, so jit specializes on it) picks the intersector.  The tag is
chosen once, by base/backend.choose_accel at scene compile time:

- ``pallas``: the dense Triton kernels (accel/pallas_isect.py) and the
  fused AO gather (accel/pallas_ao.py);
- ``pbvh``: the tile-BVH packet walks (accel/pallas_bvh.py);
- ``walk``: per-ray walks in plain JAX over the same tile BVH
  (accel/traverse.py), the XLA baseline the packet walks are timed
  against;
- ``mxu``, ``bruteforce``, ``ugrid``: plain XLA intersectors.

The hemisphere gathers (AO, sunsky-AO, the light sampler's occlusion
count) ask `hemisphere_occlusion` / `hemisphere_sky`, which return None
where the scene's accelerator has no fused gather; the caller then runs
its plain per-stratum loop over `any_hit`.
"""

from __future__ import annotations

from lucille_tpu.accel import bruteforce, mxu


def closest_hit(scene, org, dirn, tmax=None, tmin: float = 0.0, active=None):
    """active: optional (B,) live-lane mask.  The dense kernel compacts
    live lanes to the front and skips programs holding only dead lanes;
    other accels ignore it."""
    if scene.accel == "pbvh" and scene.n_nodes > 0:
        from lucille_tpu.accel.pallas_bvh import pallas_bvh_closest_hit

        return pallas_bvh_closest_hit(scene, org, dirn, tmax=tmax, tmin=tmin)
    if scene.accel == "walk" and scene.n_nodes > 0:
        from lucille_tpu.accel.traverse import walk_closest_hit

        return walk_closest_hit(scene, org, dirn, tmax=tmax, tmin=tmin)
    if scene.accel == "ugrid" and scene.grid_res > 0:
        from lucille_tpu.accel.ugrid import ugrid_closest_hit

        return ugrid_closest_hit(scene, org, dirn, tmax=tmax, tmin=tmin)
    if scene.accel == "pallas":
        from lucille_tpu.accel.pallas_isect import pallas_closest_hit

        return pallas_closest_hit(scene, org, dirn, tmax=tmax, tmin=tmin,
                                  active=active)
    if scene.accel == "mxu":
        return mxu.mxu_closest_hit(scene, org, dirn, tmax=tmax, tmin=tmin)
    return bruteforce.brute_closest_hit(scene, org, dirn, tmax=tmax, tmin=tmin)


def any_hit(scene, org, dirn, tmax=None, tmin: float = 0.0, active=None):
    """active: see closest_hit (callers mask by their own live mask)."""
    if scene.accel == "pbvh" and scene.n_nodes > 0:
        from lucille_tpu.accel.pallas_bvh import pallas_bvh_any_hit

        return pallas_bvh_any_hit(scene, org, dirn, tmax=tmax, tmin=tmin)
    if scene.accel == "walk" and scene.n_nodes > 0:
        from lucille_tpu.accel.traverse import walk_any_hit

        return walk_any_hit(scene, org, dirn, tmax=tmax, tmin=tmin)
    if scene.accel == "ugrid" and scene.grid_res > 0:
        from lucille_tpu.accel.ugrid import ugrid_any_hit

        return ugrid_any_hit(scene, org, dirn, tmax=tmax, tmin=tmin)
    if scene.accel == "pallas":
        from lucille_tpu.accel.pallas_isect import pallas_any_hit

        return pallas_any_hit(scene, org, dirn, tmax=tmax, tmin=tmin,
                              active=active)
    if scene.accel == "mxu":
        return mxu.mxu_any_hit(scene, org, dirn, tmax=tmax, tmin=tmin)
    return bruteforce.brute_any_hit(scene, org, dirn, tmax=tmax, tmin=tmin)


def hemisphere_occlusion(scene, P_off, b0, b1, b2, hit, key, ntheta, nphi):
    """Fused stratified-hemisphere occlusion gather, or None.

    Returns ((B,) occluded-stratum counts, dict of gather counters to add
    to the eye-ray ones) where the accelerator has a fused gather."""
    if scene.accel == "pallas":
        from lucille_tpu.accel.pallas_ao import pallas_ao_occlusion

        occ = pallas_ao_occlusion(
            scene, P_off, b0, b1, b2, hit, key, ntheta, nphi
        )
        return occ, {}
    if scene.accel == "pbvh" and scene.n_nodes > 0:
        from lucille_tpu.accel.pallas_bvh import pallas_bvh_ao_occlusion

        return pallas_bvh_ao_occlusion(
            scene, P_off, b0, b1, b2, hit, key, ntheta, nphi
        )
    return None


def hemisphere_sky(scene, P_off, b0, b1, b2, hit, key, ntheta, nphi, sky):
    """Fused sunsky-AO gather: (B, 3) sky radiance summed over unoccluded
    strata, or None where the accelerator has no fused gather."""
    if scene.accel == "pallas":
        from lucille_tpu.accel.pallas_ao import pallas_ao_sky

        return pallas_ao_sky(
            scene, P_off, b0, b1, b2, hit, key, ntheta, nphi, sky
        )
    if scene.accel == "pbvh" and scene.n_nodes > 0:
        from lucille_tpu.accel.pallas_bvh import pallas_bvh_ao_sky

        return pallas_bvh_ao_sky(
            scene, P_off, b0, b1, b2, hit, key, ntheta, nphi, sky
        )
    return None
