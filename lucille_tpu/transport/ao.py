"""Ambient-occlusion integrator.

Faithful to the reference's hardwired integrator
(src/transport/ambientocclusion.c, called from render.c:803):

- eye ray -> closest hit;
- stratified cosine-importance hemisphere sampling over an
  ``ntheta x nphi`` grid (ambientocclusion.c:85-110):
  ``cos_theta = sqrt(z0)``, ``phi = 2*pi*z1``, local direction
  ``(cos(phi)cos_t, sin(phi)cos_t, sqrt(1-cos_t^2))`` rotated by the
  ri_ortho_basis frame (reflection.c:312-331);
- shading point offset along Ns by an epsilon — scene-relative here,
  fixing the reference's own FIXME (ambientocclusion.c:68-70);
- ``Lo = (N - occluded)/N`` (ambientocclusion.c:135-150); misses return
  black; a material texture modulates the result (ambientocclusion.c:393).

Wavefront structure: the ``ntheta*nphi`` strata run as a `lax.scan`, each
step tracing ONE occlusion ray per eye-ray lane — the whole image tile
advances through the hemisphere together, keeping peak memory at one
wavefront while XLA pipelines the Moller-Trumbore chunks.

Randomness: threefry keys folded per (scan step); the per-thread MT19937
streams of the reference (random.c:211) are matched at the distribution
level, not bitwise (SURVEY.md "Hard parts").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lucille_tpu.accel.dispatch import (
    any_hit,
    closest_hit,
    hemisphere_occlusion,
    hemisphere_sky,
)


def ortho_basis(n):
    """Per-ray orthonormal basis from normal.

    Capability-equivalent of ri_ortho_basis (reflection.c:312-331), with
    one deliberate deviation: the reference picks the provisional up
    axis as "first axis with |n_i| < 0.6", a branch that flips between
    neighboring lanes and scatters the basis AZIMUTH almost randomly
    across a coherent block.  Any orthonormal frame leaves the cosine-
    weighted estimator unbiased, so here the axis choice is a smooth
    function of n (y unless n is nearly vertical-in-y, then x): lanes
    with similar normals get similar frames, which is what makes a
    stratum's gathered directions a COMPACT WORLD-SPACE CONE — the
    property the cone-tiled block walks (pallas_bvh.py) live on."""
    # branchless Frisvad/Duff frame: continuous in n everywhere except
    # n = (0,0,-1), so neighboring normals get neighboring frames
    nx = n[..., 0]
    ny = n[..., 1]
    nz = n[..., 2]
    s = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    # the a term blows up only at nz -> -1; clamp for safety (frame
    # quality is irrelevant exactly at the singular antipode)
    a = jnp.clip(a, -1e3, 1e3)
    b = nx * ny * a
    b0 = jnp.stack([1.0 + s * nx * nx * a, s * b, -s * nx], axis=-1)
    b1 = jnp.stack([b, s + ny * ny * a, -ny], axis=-1)
    b0 = b0 / jnp.maximum(
        jnp.linalg.norm(b0, axis=-1, keepdims=True), 1e-20
    )
    b1 = b1 / jnp.maximum(
        jnp.linalg.norm(b1, axis=-1, keepdims=True), 1e-20
    )
    return b0, b1, n


def _interp_normal(scene, res):
    """Shading normal at hits: barycentric vertex-normal interpolation
    (ri_intersection_state_build, intersection_state.c:152-190)."""
    tri = jnp.maximum(res["tri"], 0)
    u = res["u"][..., None]
    v = res["v"][..., None]
    n0 = scene.n0[tri]
    n1 = scene.n1[tri]
    n2 = scene.n2[tri]
    n = (1.0 - u - v) * n0 + u * n1 + v * n2
    return n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


def ao_radiance(
    scene,
    org,
    dirn,
    key,
    ntheta: int,
    nphi: int,
    background: float = 0.0,
    textures=None,
    lights=None,
):
    """AO radiance for a wavefront of eye rays.

    org, dirn: (B, 3) float32.  Returns (radiance (B, 3), aux dict with
    hit mask + ray/test counters).

    When the scene carries a sunsky light, the integrator switches to the
    reference's sunsky-AO derivative (gather_sunsky +
    contribution_from_sunlight, ambientocclusion.c:154-332): sky radiance
    is accumulated along every UNOCCLUDED hemisphere stratum and a sun
    shadow ray adds the direct sun color.
    """
    B = org.shape[0]
    res = closest_hit(scene, org, dirn)
    hit = res["hit"]
    t = jnp.where(hit, res["t"], 0.0)
    P = org + t[..., None] * dirn
    Ns = _interp_normal(scene, res)

    b0, b1, b2 = ortho_basis(Ns)
    P_off = P + Ns * scene.eps  # eps-offset origin (ambientocclusion.c:68)

    nsamples = ntheta * nphi

    sunsky_light = None
    sun_lights = []
    if lights is not None:
        for li in lights:
            if li.type == "sunsky" and li.sunsky is not None:
                sunsky_light = li
            elif li.type == "sun":
                sun_lights.append(li)
    if sunsky_light is not None:
        return _gather_sunsky(
            scene, res, hit, P_off, b0, b1, b2, key, ntheta, nphi,
            sunsky_light, sun_lights, background, textures, B,
        )

    fused = hemisphere_occlusion(
        scene, P_off, b0, b1, b2, hit, key, ntheta, nphi
    )
    if fused is not None:
        # one fused gather (accel/pallas_ao.py, accel/pallas_bvh.py); its
        # counters join the eye-ray ones (the reference counts both,
        # raytrace.c:43 + render.h:40-47)
        occ, extra = fused
        return _finish(
            scene, res, hit, occ, nsamples, background, textures, B,
            extra=extra,
        )

    strata = jnp.arange(nsamples, dtype=jnp.int32)

    def step(occ_count, si):
        # stratum (i, j) from flat index: i = theta index, j = phi index
        i = (si % ntheta).astype(jnp.float32)
        j = (si // ntheta).astype(jnp.float32)
        k = jax.random.fold_in(key, si)
        ur = jax.random.uniform(k, (B, 2), dtype=jnp.float32)
        z0 = (i + ur[:, 0]) / ntheta
        z1 = (j + ur[:, 1]) / nphi
        cos_t = jnp.sqrt(z0)
        phi = 2.0 * jnp.pi * z1
        lx = jnp.cos(phi) * cos_t
        ly = jnp.sin(phi) * cos_t
        lz = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        wdir = (
            lx[..., None] * b0 + ly[..., None] * b1 + lz[..., None] * b2
        )
        occluded = any_hit(scene, P_off, wdir)
        return occ_count + (occluded & hit).astype(jnp.float32), None

    occ, _ = jax.lax.scan(step, jnp.zeros((B,), jnp.float32), strata)
    return _finish(scene, res, hit, occ, nsamples, background, textures, B)


def _gather_sunsky(scene, res, hit, P_off, b0, b1, b2, key, ntheta, nphi,
                   sunsky_light, sun_lights, background, textures, B):
    """Sunsky-AO gather (ambientocclusion.c:154-332): per unoccluded
    stratum accumulate the Preetham sky radiance along the ray; then one
    shadow ray toward the sun adds the sun color unattenuated (no cosine
    — contribution_from_sunlight:190-196); final Lo = col/(pi*nsamples),
    the reference's m = 1/pi normalization (the sun term shares the
    stratum divisor, faithfully)."""
    nsamples = ntheta * nphi
    sky = sunsky_light.sunsky

    col = hemisphere_sky(
        scene, P_off, b0, b1, b2, hit, key, ntheta, nphi, sky
    )
    if col is None:
        strata = jnp.arange(nsamples, dtype=jnp.int32)

        def step(col, si):
            i = (si % ntheta).astype(jnp.float32)
            j = (si // ntheta).astype(jnp.float32)
            k = jax.random.fold_in(key, si)
            ur = jax.random.uniform(k, (B, 2), dtype=jnp.float32)
            z0 = (i + ur[:, 0]) / ntheta
            z1 = (j + ur[:, 1]) / nphi
            cos_t = jnp.sqrt(z0)
            phi = 2.0 * jnp.pi * z1
            lx = jnp.cos(phi) * cos_t
            ly = jnp.sin(phi) * cos_t
            lz = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
            wdir = (
                lx[..., None] * b0 + ly[..., None] * b1 + lz[..., None] * b2
            )
            occluded = any_hit(scene, P_off, wdir)
            vis = (~occluded) & hit
            # world (y-up) -> sky model (z-up) frame, the same swap the
            # sun light construction applies (lightsource.c:152-158)
            d_sky = jnp.stack([wdir[:, 0], wdir[:, 2], wdir[:, 1]], axis=-1)
            return col + vis[:, None] * sky.sky_rgb(d_sky), None

        col, _ = jax.lax.scan(
            step, jnp.zeros((B, 3), jnp.float32), strata
        )

    # contribution_from_sunlight: trace along +sun direction, add the sun
    # color where unoccluded
    for sun in sun_lights:
        wi = jnp.asarray(sun.direction, jnp.float32)
        wi = wi / jnp.maximum(jnp.linalg.norm(wi), 1e-20)
        wi = jnp.broadcast_to(wi, P_off.shape)
        occluded = any_hit(scene, P_off, wi, active=hit)
        suncol = jnp.asarray(sun.color, jnp.float32) * sun.intensity
        col = col + (((~occluded) & hit).astype(jnp.float32))[:, None] * suncol

    lo = col / (jnp.pi * nsamples)
    radiance = jnp.where(hit[..., None], lo, background)
    radiance = _modulate(scene, res, hit, radiance, textures)

    aux = {
        "hit": hit,
        "nrays": B + jnp.sum(hit.astype(jnp.int32)) * (
            nsamples + len(sun_lights)
        ),
        "ntests": res["ntests"],
        "ntrav": res["ntrav"],
        "t": res["t"],
    }
    return radiance, aux


def _modulate(scene, res, hit, radiance, textures):
    """Vertex-color + material-texture modulation at the hit
    (ambientocclusion.c:393-400)."""
    tri = jnp.maximum(res["tri"], 0)
    u = res["u"][..., None]
    v = res["v"][..., None]
    w = 1.0 - u - v
    cs = w * scene.c0[tri] + u * scene.c1[tri] + v * scene.c2[tri]
    radiance = radiance * jnp.where(hit[..., None], cs, 1.0)
    if textures is not None and textures.data is not None:
        st = w * scene.st0[tri] + u * scene.st1[tri] + v * scene.st2[tri]
        geom = scene.geom_id[tri]
        tex_id = scene.mat_texture[geom]
        texcol = textures.fetch(jnp.maximum(tex_id, 0), st[..., 0], st[..., 1])
        has_tex = hit & (tex_id >= 0)
        radiance = radiance * jnp.where(has_tex[..., None], texcol, 1.0)
    return radiance


def _finish(scene, res, hit, occ, nsamples, background, textures, B,
            extra=None):
    """Shared epilogue: occlusion count -> radiance + texture modulation
    + statistics (ambientocclusion.c:135-150, 393-400).  `extra` adds
    gather-phase counters (ntrav/ntests) to the eye-ray ones."""
    lo = (nsamples - occ) / nsamples  # m = 1.0 (ambientocclusion.c:146)
    radiance = jnp.where(hit, lo, background)[..., None] * jnp.ones(
        (1, 3), jnp.float32
    )
    radiance = _modulate(scene, res, hit, radiance, textures)

    extra = extra or {}
    aux = {
        "hit": hit,
        # the reference counts a ray per ri_raytrace call (raytrace.c:43):
        # eye rays for every lane, hemisphere rays only where the eye ray hit
        "nrays": B + jnp.sum(hit.astype(jnp.int32)) * nsamples,
        "ntests": res["ntests"] + extra.get("ntests", 0),
        "ntrav": res["ntrav"] + extra.get("ntrav", 0),
        "t": res["t"],
    }
    return radiance, aux
