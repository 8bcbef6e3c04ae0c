"""Direct-lighting estimators over the light tables.

Capability-equivalent of lucille's light sampling (light.h:73-100 pos/dir
sampling; shader.c diffuse()/specular() built-ins tracing shadow rays to
per-light sample sets, shader.c:504-633; ibl.c dome sampling).  All
estimators are wavefront functions: P, N are (B, 3); one shadow wavefront
per light sample; the per-light Python loop unrolls at trace time since
light counts are tiny and static.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lucille_tpu.accel.dispatch import any_hit, hemisphere_occlusion
from lucille_tpu.lights.tables import (
    LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_DOME,
    LIGHT_IBL,
    LIGHT_POINT,
    LIGHT_SUN,
    LIGHT_SUNSKY,
    LightTables,
)


def _shadow(scene, P, N, wi, tmax=None, active=None):
    org = P + N * scene.eps
    occ = any_hit(scene, org, wi, tmax=tmax, active=active)
    return 1.0 - occ.astype(jnp.float32)


def sample_area_light(light, u):
    """Uniformly sample points on an area light's triangles.

    u: (B, 3) uniforms -> (points (B, 3), normals (B, 3), pdf_area (B,)).
    """
    tris = light.tris
    cdf = jnp.asarray(tris["area_cdf"])
    v0 = jnp.asarray(tris["v0"])
    e1 = jnp.asarray(tris["e1"])
    e2 = jnp.asarray(tris["e2"])
    ti = jnp.searchsorted(cdf, u[:, 0])
    ti = jnp.clip(ti, 0, len(cdf) - 1)
    # uniform barycentric via sqrt warp: b1 = 1-sqrt(u1), b2 = u2*sqrt(u1)
    su = jnp.sqrt(jnp.maximum(u[:, 1], 1e-12))
    b1 = 1.0 - su
    b2 = u[:, 2] * su
    pts = v0[ti] + b1[:, None] * e1[ti] + b2[:, None] * e2[ti]
    nrm = jnp.cross(e1[ti], e2[ti])
    nl = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / jnp.maximum(nl, 1e-20)
    pdf_area = 1.0 / jnp.maximum(tris["total_area"], 1e-20)
    return pts, nrm, jnp.full(u.shape[0], pdf_area, jnp.float32)


def _hemisphere_occlusion(scene, P, N, key, nsamples: int, active):
    """Stratified hemisphere occlusion COUNT via the fused AO gathers
    (accel/dispatch.hemisphere_occlusion), or None when no fused path
    serves this scene/wavefront.  Same estimator family as the
    cosweight loop below (stratified instead of independent samples)."""
    import math

    nt = int(math.isqrt(nsamples))
    while nt > 1 and nsamples % nt:
        nt -= 1
    nph = nsamples // nt
    if nt * nph != nsamples:
        return None
    B = P.shape[0]
    from lucille_tpu.transport.ao import ortho_basis

    hit = (
        active
        if active is not None
        else jnp.ones((B,), bool)
    )
    b0, b1, b2 = ortho_basis(N)
    P_off = P + N * scene.eps
    fused = hemisphere_occlusion(scene, P_off, b0, b1, b2, hit, key, nt, nph)
    return None if fused is None else fused[0]


def light_contribution(scene, light, P, N, key, nsamples: int = 1,
                       active=None):
    """Incident diffuse irradiance-ish contribution of one light:
    E = Li * cos / pdf, shadowed.  Returns (B, 3).

    active: optional live-lane mask — shadow wavefronts compact dead
    lanes away on the dense kernel path (accel/dispatch.py)."""
    B = P.shape[0]
    col = jnp.asarray(light.color, jnp.float32) * light.intensity

    if light.type in (LIGHT_DISTANT, LIGHT_SUN):
        # distant lights store the direction they SHINE (to - from), so
        # wi = -direction; sunlights store sun_dir, the direction TOWARD
        # the sun (lightsource.c:155-158), so wi = +direction — the AO
        # sunsky gather traces along +direction (ambientocclusion.c:181)
        sgn = 1.0 if light.type == LIGHT_SUN else -1.0
        wi = sgn * jnp.asarray(light.direction, jnp.float32)
        wi = wi / jnp.maximum(jnp.linalg.norm(wi), 1e-20)
        wi = jnp.broadcast_to(wi, P.shape)
        cos = jnp.maximum(jnp.sum(N * wi, axis=-1), 0.0)
        vis = _shadow(scene, P, N, wi, active=active)
        return (cos * vis)[:, None] * col

    if light.type == LIGHT_POINT:
        d = jnp.asarray(light.position, jnp.float32) - P
        r2 = jnp.maximum(jnp.sum(d * d, axis=-1), 1e-12)
        r = jnp.sqrt(r2)
        wi = d / r[:, None]
        cos = jnp.maximum(jnp.sum(N * wi, axis=-1), 0.0)
        # distance-capped shadow ray: occluders beyond the light don't count
        vis = 1.0 - any_hit(
            scene, P + N * scene.eps, wi, tmax=r - 2.0 * scene.eps,
            active=active,
        ).astype(jnp.float32)
        return (cos * vis / r2)[:, None] * col

    if light.type in (LIGHT_DOME, LIGHT_IBL) and light.env is not None:
        # textured environment light: route through the sampler the RIB
        # selected (lightsource.c:127-142 tokens -> ibl.c:53-540)
        return _env_contribution(scene, light, P, N, key, nsamples)

    if light.type == LIGHT_DOME:
        # CONSTANT dome: the gather is pure hemisphere VISIBILITY, which
        # is exactly the fused AO occlusion kernels' job (triangles
        # hoisted across all strata, hit compaction) — whitted frames
        # spent ~4 separate any_hit launches per tile here before.
        # E = col * pi * visible_fraction (each cosine-weighted sample
        # contributes li*pi; li constant).
        occ = _hemisphere_occlusion(scene, P, N, key, nsamples, active)
        if occ is not None:
            vis_frac = 1.0 - occ / nsamples
            return vis_frac[:, None] * col * jnp.pi

    if light.type in (LIGHT_DOME, LIGHT_SUNSKY, LIGHT_IBL):
        # cosine-weighted hemisphere gather (ibl.c:53 cosweight sampler)
        from lucille_tpu.shading.reflection import cosweight_sample
        from lucille_tpu.transport.ao import ortho_basis

        basis = ortho_basis(N)
        total = jnp.zeros((B, 3), jnp.float32)
        for si in range(nsamples):
            k = jax.random.fold_in(key, si)
            ur = jax.random.uniform(k, (B, 2), dtype=jnp.float32)
            wi, _pdf = cosweight_sample(ur[:, 0], ur[:, 1], basis)
            vis = _shadow(scene, P, N, wi, active=active)
            if light.type == LIGHT_SUNSKY and light.sunsky is not None:
                # sky radiance in the sampled direction (z-up frame with
                # the reference's y/z swap, lightsource.c:152-155)
                d_sky = jnp.stack(
                    [wi[:, 0], wi[:, 2], wi[:, 1]], axis=-1
                )
                li = light.sunsky.sky_rgb(d_sky)
            else:
                li = col[None, :]
            # cos/pdf = pi for cosine sampling of Li*cos/pi-free estimator
            total = total + vis[:, None] * li * jnp.pi
        return total / nsamples

    if light.type == LIGHT_AREA and light.tris is not None:
        total = jnp.zeros((B, 3), jnp.float32)
        for si in range(nsamples):
            k = jax.random.fold_in(key, si)
            u = jax.random.uniform(k, (B, 3), dtype=jnp.float32)
            pts, ln, pdf_a = sample_area_light(light, u)
            d = pts - P
            r2 = jnp.maximum(jnp.sum(d * d, axis=-1), 1e-10)
            r = jnp.sqrt(r2)
            wi = d / r[:, None]
            cos_s = jnp.maximum(jnp.sum(N * wi, axis=-1), 0.0)
            cos_l = jnp.maximum(-jnp.sum(ln * wi, axis=-1), 0.0)
            vis = 1.0 - any_hit(
                scene, P + N * scene.eps, wi, tmax=r - 2.0 * scene.eps,
                active=active,
            ).astype(jnp.float32)
            g = cos_s * cos_l / r2
            total = total + (vis * g / jnp.maximum(pdf_a, 1e-20))[:, None] * col
        return total / nsamples

    return jnp.zeros((B, 3), jnp.float32)


def _env_contribution(scene, light, P, N, key, nsamples: int):
    """Incident irradiance from a textured dome/IBL light through the
    selected sampler (ibl.c:53-540; light->iblsampler, light.h:19-23).
    Every sampler fetches the light's actual environment texture per
    gathered direction (texture.c:238)."""
    import math

    from lucille_tpu.lights import ibl

    env = light.env
    col = jnp.asarray(light.color, jnp.float32) * light.intensity
    sampler = light.ibl_sampler or "cosweight"

    if sampler == "importance":
        e = ibl.sample_env_importance(
            env.importance_table, scene, P, N, key, nsamples=nsamples
        )
        return e * col[None, :]
    if sampler == "stratified":
        n = max(1, int(math.sqrt(nsamples)))
        e = ibl.sample_env_stratified(
            env.fetch, scene, P, N, key, ntheta=n, nphi=n
        )
        return e * col[None, :]
    if sampler == "structured":
        sis = env.file_sis or env.sis_samples(64)
        dirs, rgb = sis
        if len(dirs) == 0:
            return jnp.zeros((P.shape[0], 3), jnp.float32)
        e = ibl.sample_env_structured(dirs, rgb, scene, P, N)
        return e * col[None, :]
    if sampler == "bruteforce":
        e = ibl.sample_env_bruteforce(env.importance_table, scene, P, N)
        return e * col[None, :]
    # default: cosweight (ibl.c:53)
    e = ibl.sample_env_cosweight(env.fetch, scene, P, N, key, nsamples=nsamples)
    return e * col[None, :]


def light_wi_cl(scene, light, P, N, key, index: int = 0):
    """One (direction, shadowed color) sample for a light — the binding
    behind RSL `illuminance` blocks (L and Cl).  Returns (None, None) for
    light types with no meaningful single-direction sample."""
    import jax

    B = P.shape[0]
    col = jnp.asarray(light.color, jnp.float32) * light.intensity
    k = jax.random.fold_in(key, 7000 + index)

    if light.type in (LIGHT_DISTANT, LIGHT_SUN):
        sgn = 1.0 if light.type == LIGHT_SUN else -1.0
        wi = sgn * jnp.asarray(light.direction, jnp.float32)
        wi = jnp.broadcast_to(wi / jnp.maximum(jnp.linalg.norm(wi), 1e-20), P.shape)
        vis = _shadow(scene, P, N, wi)
        return wi, vis[:, None] * col
    if light.type == LIGHT_POINT:
        d = jnp.asarray(light.position, jnp.float32) - P
        r2 = jnp.maximum(jnp.sum(d * d, axis=-1), 1e-12)
        r = jnp.sqrt(r2)
        wi = d / r[:, None]
        vis = 1.0 - any_hit(
            scene, P + N * scene.eps, wi, tmax=r - 2.0 * scene.eps
        ).astype(jnp.float32)
        return wi, (vis / r2)[:, None] * col
    if light.type == LIGHT_AREA and light.tris is not None:
        u = jax.random.uniform(k, (B, 3), dtype=jnp.float32)
        pts, ln, pdf_a = sample_area_light(light, u)
        d = pts - P
        r2 = jnp.maximum(jnp.sum(d * d, axis=-1), 1e-10)
        r = jnp.sqrt(r2)
        wi = d / r[:, None]
        cos_l = jnp.maximum(-jnp.sum(ln * wi, axis=-1), 0.0)
        vis = 1.0 - any_hit(
            scene, P + N * scene.eps, wi, tmax=r - 2.0 * scene.eps
        ).astype(jnp.float32)
        w = vis * cos_l / (r2 * jnp.maximum(pdf_a, 1e-20))
        return wi, w[:, None] * col
    if light.type in (LIGHT_DOME, LIGHT_SUNSKY, LIGHT_IBL):
        from lucille_tpu.shading.reflection import cosweight_sample
        from lucille_tpu.transport.ao import ortho_basis

        ur = jax.random.uniform(k, (B, 2), dtype=jnp.float32)
        wi, _pdf = cosweight_sample(ur[:, 0], ur[:, 1], ortho_basis(N))
        vis = _shadow(scene, P, N, wi)
        if light.type == LIGHT_SUNSKY and light.sunsky is not None:
            d_sky = jnp.stack([wi[:, 0], wi[:, 2], wi[:, 1]], axis=-1)
            li = light.sunsky.sky_rgb(d_sky)
        elif light.env is not None:
            li = light.env.fetch(wi) * col[None, :]  # texture.c:238
        else:
            li = jnp.broadcast_to(col, P.shape)
        # Cl scaled so that Cl * (L.N) integrates like the cosine gather
        cos = jnp.maximum(jnp.sum(N * wi, axis=-1), 1e-6)
        return wi, vis[:, None] * li * (jnp.pi / cos)[:, None] / jnp.pi
    return None, None


def shadow_rays_per_hit(lights, nsamples: int = 4) -> int:
    """Shadow rays direct_diffuse + direct_specular trace per shaded hit
    — for the raytrace.c:96-style ray accounting (the reference's
    diffuse()/specular() shadow rays go through ri_raytrace and count)."""
    n = 0
    for light in lights or ():
        n += nsamples if light.type in (
            LIGHT_DOME, LIGHT_AREA, LIGHT_SUNSKY, LIGHT_IBL
        ) else 1
        if light.type in (LIGHT_DISTANT, LIGHT_SUN, LIGHT_POINT):
            n += 1  # direct_specular's highlight shadow ray
    return n


def direct_diffuse(scene, lights: LightTables, P, N, key, nsamples: int = 4,
                   active=None):
    """diffuse(N) built-in: shadowed cosine lighting summed over lights
    (shader.c:504).  Returns (B, 3) irradiance estimate (divided by pi to
    be an exitant-radiance factor for a lambertian with albedo 1)."""
    total = jnp.zeros_like(P)
    for i, light in enumerate(lights):
        k = jax.random.fold_in(key, i + 1000)
        n = nsamples if light.type in (LIGHT_DOME, LIGHT_AREA, LIGHT_SUNSKY, LIGHT_IBL) else 1
        total = total + light_contribution(scene, light, P, N, k, n,
                                           active=active)
    return total / jnp.pi


def direct_specular(scene, lights: LightTables, P, N, V, roughness, key,
                    active=None):
    """specular(N, V, roughness) built-in (shader.c:529): Blinn-style
    highlight per light, shadowed."""
    total = jnp.zeros_like(P)
    inv_r = 1.0 / jnp.maximum(jnp.asarray(roughness, jnp.float32), 1e-3)
    for i, light in enumerate(lights):
        if light.type in (LIGHT_DISTANT, LIGHT_SUN):
            sgn = 1.0 if light.type == LIGHT_SUN else -1.0
            wi = sgn * jnp.asarray(light.direction, jnp.float32)
            wi = jnp.broadcast_to(wi / jnp.maximum(jnp.linalg.norm(wi), 1e-20), P.shape)
            tmax = None
        elif light.type == LIGHT_POINT:
            d = jnp.asarray(light.position, jnp.float32) - P
            r = jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-10)
            wi = d / r
            tmax = None
        else:
            continue  # dome/area specular handled by path tracing
        h = wi + V
        h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-20)
        ndoth = jnp.maximum(jnp.sum(N * h, axis=-1), 0.0)
        cos = jnp.maximum(jnp.sum(N * wi, axis=-1), 0.0)
        vis = _shadow(scene, P, N, wi, tmax, active=active)
        col = jnp.asarray(light.color, jnp.float32) * light.intensity
        total = total + (vis * (cos > 0) * jnp.power(ndoth, inv_r))[:, None] * col
    return total
