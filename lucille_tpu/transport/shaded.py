"""Shader-driven integrator: evaluate bound surface shaders per hit.

The path the reference INTENDED (ri_shade -> shader_shading ->
shader->shaderproc, shading.c:85-151 — presently short-circuited `#if 0`
at shading.c:48-55, with AO hardwired instead): here it actually runs.
Every geometry's Surface binding (RSL source compiled by shading/sl.py,
or a built-in from shading/shader.py) is evaluated over the hit
wavefront.

Device lowering of per-geometry dispatch: shaders are Python-level
constants, so the (small) set of distinct shaders is evaluated
masked-dense — each shader runs on the WHOLE wavefront and lanes select
their geometry's result.  No divergence, no gather of code pointers; for
the handful of shaders real scenes bind, redundant lanes are cheaper
than any scatter (same trade the reference's SIMD packets make).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lucille_tpu.accel.dispatch import closest_hit
from lucille_tpu.shading.shader import ShaderContext, ShaderGlobals, get_shader
from lucille_tpu.transport.ao import ortho_basis
from lucille_tpu.transport.common import (
    background_radiance,
    face_forward,
    interp_hit,
)


def shaded_radiance(
    scene,
    lights,
    org,
    dirn,
    key,
    shader_table=None,
    max_depth: int = 8,
    bgcolor=(0.0, 0.0, 0.0),
    textures=None,
):
    """Evaluate surface shaders at primary hits.

    shader_table: list of (shader_fn, params) rows indexed by geom id —
    built by the renderer from each geometry's Surface binding; None
    falls back to matte for everything.

    ``trace()`` (shader.c:895-925) is live: each wavefront's
    ShaderContext gets a trace_fn that recursively re-shades a secondary
    wavefront at depth-1.  The recursion is Python-trace-time and LAZY —
    it unrolls into the XLA graph only when a bound shader actually
    calls trace(), so matte scenes pay nothing.  max_depth bounds the
    recursion exactly like the reference's MAX_RAY_DEPTH guard inside
    trace() itself.
    """
    if shader_table is None:
        shader_table = [(get_shader("matte")[0], {})] * scene.n_geoms
    # the reference's trace() itself refuses past ray_depth 3
    # (shader.c:911-914) regardless of max_ray_depth; matching that also
    # bounds the masked-dense unrolling (whitted.sl calls trace twice per
    # level) to at most 2^3 secondary wavefronts
    depth = min(max_depth, 3)
    return _shade_wavefront(
        scene, lights, org, dirn, key, shader_table, depth, bgcolor,
        textures,
    )


def _shade_wavefront(
    scene, lights, org, dirn, key, shader_table, depth, bgcolor, textures
):
    """One wavefront of shader evaluation; trace() recurses here."""
    B = org.shape[0]
    res = closest_hit(scene, org, dirn)
    hit = res["hit"]
    h = interp_hit(scene, res, org, dirn)
    N = face_forward(h["Ns"], dirn)
    P = h["P"]

    b0, b1, _ = ortho_basis(N)
    sg = ShaderGlobals(
        P=P,
        N=N,
        Ng=h["Ng"],
        I=dirn,
        E=org,
        Cs=h["cs"] * h["mat_color"],
        Os=jnp.ones((B, 3), jnp.float32),
        s=h["st"][..., 0],
        t=h["st"][..., 1],
        u=res["u"],
        v=res["v"],
        dPdu=b0,
        dPdv=b1,
    )

    def trace_fn(torg, tdirn):
        # secondary rays re-enter the same masked-dense shade at depth-1;
        # rays that escape pick up the background/environment like the
        # reference's trace() miss path
        sub, _ = _shade_wavefront(
            scene, lights, torg, tdirn,
            jax.random.fold_in(key, depth), shader_table, depth - 1,
            bgcolor, textures,
        )
        return sub

    ctx = ShaderContext(
        scene=scene, key=key, lights=lights, textures=textures,
        trace_depth_left=depth,
        trace_fn=trace_fn if depth > 0 else None,
    )

    # deduplicate: evaluate each distinct shader once over the wavefront
    ci = jnp.zeros((B, 3), jnp.float32)
    done = set()
    for gid, (fn, params) in enumerate(shader_table):
        key_id = (id(fn), tuple(sorted(map(str, params.items()))))
        if key_id in done:
            continue
        done.add(key_id)
        # all geoms bound to this same (fn, params)
        gids = [
            g
            for g, (f2, p2) in enumerate(shader_table)
            if (id(f2), tuple(sorted(map(str, p2.items())))) == key_id
        ]
        mask = jnp.zeros((B,), bool)
        for g in gids:
            mask = mask | (h["geom"] == g)
        out_ci, _out_oi = fn(sg, params, ctx)
        ci = jnp.where((hit & mask)[:, None], out_ci, ci)

    env = background_radiance(lights, dirn, bgcolor)
    radiance = jnp.where(hit[:, None], ci, env)
    return radiance, {
        "hit": hit,
        "nrays": B,
        "ntests": res["ntests"],
        "ntrav": res["ntrav"],
        "t": res["t"],
    }


def build_shader_table(desc):
    """Resolve each geometry's Surface binding to (fn, params).

    RSL sources are searched as '<name>.sl' on the option searchpaths and
    compiled on first use (the dlopen-of-<name>.so replacement,
    attribute.c:372-428); otherwise built-in shaders match by name;
    unknown names fall back to matte with a warning."""
    from pathlib import Path

    from lucille_tpu.shading.shader import _SHADERS

    table = []
    for g in desc.geoms:
        name = g.attrs.surface
        params = dict(g.attrs.surface_params or {})
        # normalize inline declarations: 'uniform float Kd' -> 'Kd'
        params = {k.split()[-1]: v for k, v in params.items()}
        if name and name.lower() not in _SHADERS:
            for sp in desc.options.searchpaths or ["."]:
                cand = Path(sp) / f"{name}.sl"
                if cand.exists():
                    from lucille_tpu.shading.sl import load_sl_file

                    try:
                        load_sl_file(cand)
                    except Exception:  # noqa: BLE001 — malformed .sl
                        pass
                    break
        fn, defaults = get_shader(name)
        merged = dict(defaults)
        merged.update(params)
        table.append((fn, merged))
    return table
