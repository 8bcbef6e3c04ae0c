"""Whitted-style recursive ray tracing, as a bounded wavefront loop.

Capability-equivalent of src/transport/whitted.c (classic reflect/refract
recursion, depth <= 8, whitted.c:24-70).  The recursion becomes a Python
loop over depth (static, so XLA unrolls and fuses): every lane carries a
throughput and a single continuation ray.

Deviation by design (documented): where the reference's recursion forks
into BOTH reflection and refraction branches, a wavefront lane follows ONE
stochastically-selected branch weighted by the Fresnel coefficients
(standard GPU/wavefront practice) — the estimator's expectation is the
same; variance moves into the sample dimension, which is wide and cheap.

Wavefront compaction: bounces past the first run under ``lax.cond`` on
``any(active)`` — when every lane has terminated (a matte scene kills all
lanes after depth 0) the remaining bounce bodies, including their shadow
wavefronts, are skipped AT RUN TIME, not merely masked.

Ray accounting matches raytrace.c:96 (every traced ray counts): bounce
rays count only while any lane is active, and the diffuse/specular shadow
rays count per shaded hit — the reference's diffuse() traces the same
shadow rays through ri_raytrace (shader.c:504-633).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lucille_tpu.accel.dispatch import closest_hit
from lucille_tpu.lights.sampling import (
    direct_diffuse,
    direct_specular,
    shadow_rays_per_hit,
)
from lucille_tpu.shading.reflection import fresnel, reflect
from lucille_tpu.transport.common import (
    background_radiance,
    face_forward,
    interp_hit,
)


def whitted_radiance(
    scene,
    lights,
    org,
    dirn,
    key,
    max_depth: int = 8,
    bgcolor=(0.0, 0.0, 0.0),
    textures=None,
):
    """Wavefront Whitted integrator.  org/dirn (B, 3) -> (radiance, aux)."""
    B = org.shape[0]
    nshadow = shadow_rays_per_hit(lights)

    def bounce(state, depth, last):
        radiance, throughput, active, org, dirn, nrays = state
        # bounce wavefronts compact dead lanes away (dense Pallas path
        # skips whole dead blocks); the eye bounce is fully live
        res = closest_hit(
            scene, org, dirn, active=None if depth == 0 else active
        )
        # every traced ray counts (raytrace.c:96) — only live lanes trace
        nrays = nrays + (
            B if depth == 0 else jnp.sum(active.astype(jnp.int32))
        )
        hit = res["hit"] & active
        h = interp_hit(scene, res, org, dirn)
        N = face_forward(h["Ns"], dirn)
        P = h["P"]

        # escaped rays pick up the environment
        env = background_radiance(lights, dirn, bgcolor)
        radiance = radiance + jnp.where(
            (active & ~res["hit"])[:, None], throughput * env, 0.0
        )

        # emission (area lights seen directly)
        radiance = radiance + jnp.where(
            hit[:, None], throughput * h["emission"], 0.0
        )

        # direct lighting on the diffuse part
        kdir = jax.random.fold_in(key, depth)
        # shadow wavefronts only trace for lanes whose eye/bounce ray hit
        diff = direct_diffuse(scene, lights, P, N, kdir, active=hit)
        # per-material roughness from the Surface binding ("roughness"
        # param, plastic.sl-style), not a hardcoded constant
        spec = direct_specular(scene, lights, P, N, -dirn, h["roughness"],
                               kdir, active=hit)
        from lucille_tpu.transport.common import apply_texture

        base = apply_texture(scene, textures, h, h["cs"] * h["mat_color"])
        kd = h["kd"][:, None]
        ks = h["ks"][:, None]
        local = base * kd * diff + ks * spec
        radiance = radiance + jnp.where(hit[:, None], throughput * local, 0.0)
        # shadow rays traced by diffuse()/specular() (shader.c:504-633)
        nrays = nrays + jnp.sum(hit.astype(jnp.int32)) * nshadow

        if last:
            return (radiance, throughput, active, org, dirn, nrays), res

        # continuation: specular reflect/refract via Fresnel-weighted
        # stochastic selection (see module docstring)
        refl = reflect(dirn, N)
        refl = refl / jnp.maximum(
            jnp.linalg.norm(refl, axis=-1, keepdims=True), 1e-20
        )
        mat_ior = jnp.maximum(h["ior"], 1.001)
        r_dir, t_dir, kr, kt = fresnel(dirn, N, mat_ior)
        u = jax.random.uniform(jax.random.fold_in(kdir, 7), (B,))
        kt_mat = h["kt"]
        # transmissive lanes pick refraction with probability kt (the
        # Fresnel transmittance); others always reflect
        choose_refract = (u < kt) & (kt_mat > 1e-4)
        new_dir = jnp.where(choose_refract[:, None], t_dir, refl)
        gain = jnp.where(choose_refract, kt_mat, h["ks"])[:, None]
        cont = hit & ((h["ks"] > 1e-4) | (kt_mat > 1e-4))
        throughput = jnp.where(cont[:, None], throughput * gain, throughput)
        # refracted rays push through the surface, reflected ones off it
        off = jnp.where(choose_refract[:, None], -N, N) * scene.eps
        org = jnp.where(cont[:, None], P + off, org)
        dirn = jnp.where(cont[:, None], new_dir, dirn)
        return (radiance, throughput, cont, org, dirn, nrays), res

    state = (
        jnp.zeros((B, 3), jnp.float32),
        jnp.ones((B, 3), jnp.float32),
        jnp.ones((B,), bool),
        org,
        dirn,
        jnp.int32(0),
    )
    # eye bounce always runs; its hit mask/depth feed alpha + atmosphere
    state, res0 = bounce(state, 0, last=(max_depth == 1))
    first_hit = res0["hit"]
    eye_t = res0["t"]

    for depth in range(1, max_depth):
        last = depth == max_depth - 1

        def live_body(s, depth=depth, last=last):
            return bounce(s, depth, last)[0]

        # run-time skip: a bounce with zero active lanes executes nothing
        # (the wavefront-compaction analog for static shapes)
        state = jax.lax.cond(
            jnp.any(state[2]), live_body, lambda s: s, state
        )

    radiance, _tp, _act, _o, _d, nrays = state
    return radiance, {"nrays": nrays, "hit": first_hit, "t": eye_t}
