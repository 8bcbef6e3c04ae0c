"""Displacement / Atmosphere / Imager shader execution.

The reference's shader ABI (render/shader.h:27-120) spans more than
surface shaders; this module executes the other three stages the RIB can
bind:

- **Displacement** (``RiDisplacement``): run over each geometry's
  VERTICES at scene-compile time — the ray tracer's analog of REYES
  dice-time displacement.  ``P`` moves along ``N``; normals are rebuilt
  from the displaced mesh (area-weighted), which is exact where the RSL
  calls ``calculatenormal(P)``.
- **Atmosphere / volume** (``RiAtmosphere``): run per eye ray at shading
  time over (Ci, ray length) — fog over ``t`` like the reference's
  volume-shader slot.
- **Imager** (``RiImager``): run once over the assembled frame before
  display output (Ci, alpha per pixel).

Resolution order per stage: builtin table (the MOSAIC Blender-export
shaders and the RenderMan standard fog/depthcue/background are built in,
implementing the semantics of the .sl sources shipped with
examples/plane_sphere/Shaders) -> .sl source found on the option
searchpath, compiled by shading/sl.py -> warn once and ignore.
"""

from __future__ import annotations

import numpy as np

from lucille_tpu.base.log import LOG_INFO, LOG_WARN, log, log_once


def _p1(params: dict, name: str, default):
    """Scalar/array parameter lookup tolerant of inline declarations."""
    for key, val in params.items():
        if key.split()[-1] == name:
            arr = np.asarray(val, dtype=np.float64).reshape(-1)
            return arr if np.ndim(default) else float(arr[0])
    return default


def _pstr(params: dict, name: str, default: str = "") -> str:
    for key, val in params.items():
        if key.split()[-1] == name:
            return str(val[0] if isinstance(val, (list, tuple, np.ndarray)) else val)
    return default


def _find_sl(name: str, searchpaths):
    from lucille_tpu.imageio.loader import find_file

    return find_file(f"{name}.sl", searchpaths)


# ---------------------------------------------------------------------------
# imager stage (film post-pass)
# ---------------------------------------------------------------------------


def apply_imager(frame, alpha, name, params, searchpaths=None):
    """frame: (H, W, 3) f32; alpha: (H, W) f32 coverage.  Returns the
    post-processed (H, W, 3) frame."""
    import jax.numpy as jnp

    if not name:
        return frame
    if name in ("background", "MOSAICbackground"):
        # Ci += (1 - alpha) * bgcolor; alpha = 1
        # (examples/plane_sphere/Shaders/MOSAICbackground.sl semantics)
        bg = np.asarray(_p1(params, "bgcolor", np.ones(3)), np.float32)[:3]
        return frame + (1.0 - alpha)[..., None] * bg
    fn = _compile_stage(name, searchpaths, "imager")
    if fn is None:
        return frame
    H, W = frame.shape[:2]
    sg, ctx = _flat_globals(frame.reshape(-1, 3), W, H)
    out = fn.run_vars(
        sg, dict(params), ctx,
        extra_globals={"alpha": jnp.asarray(alpha, jnp.float32).reshape(-1),
                       "Ci": jnp.asarray(frame, jnp.float32).reshape(-1, 3)},
    )
    return jnp.reshape(out["Ci"], frame.shape)


# ---------------------------------------------------------------------------
# atmosphere / volume stage (per eye ray)
# ---------------------------------------------------------------------------


def apply_atmosphere(ci, ray_len, P, hit, name, params, searchpaths=None,
                     dirn=None):
    """Fog the wavefront radiance by ray length.

    ci: (B, 3); ray_len: (B,) eye-ray |I|; P: (B, 3) hit points;
    hit: (B,) bool — escaped rays keep their radiance; dirn: optional
    (B, 3) eye directions (the "miefog" phase needs the eye/sun angle).
    """
    import jax
    import jax.numpy as jnp

    if not name:
        return ci
    if name in ("miefog",) and dirn is not None:
        # single-scattering haze with a Lorenz-Mie phase function
        # (ops/mie.py — the MieScattering R&D tool driving a real
        # atmosphere): Beer-Lambert extinction over the eye path plus
        # in-scatter from a directional sun, with the phase evaluated
        # at cos(theta) between the eye ray and the sun direction.
        from lucille_tpu.ops.mie import phase_table

        density = max(_p1(params, "density", 0.05), 0.0)
        albedo = min(max(float(_p1(params, "albedo", 0.9)), 0.0), 1.0)
        sundir = np.asarray(
            _p1(params, "sundir", np.array([0.3, 1.0, 0.2])), np.float32
        )[:3]
        sundir = sundir / max(np.linalg.norm(sundir), 1e-9)
        suncol = np.asarray(
            _p1(params, "suncolor", np.ones(3)), np.float32
        )[:3] * _p1(params, "intensity", 1.0)
        wavelength = _p1(params, "wavelength", 600.0)   # nm
        radius = _p1(params, "particlesize", 1000.0)    # nm
        eta = _p1(params, "eta", 1.33)                  # water droplet
        table = jnp.asarray(
            phase_table(wavelength, radius, eta, 1.0), jnp.float32
        )
        d = dirn / jnp.maximum(
            jnp.linalg.norm(dirn, axis=-1, keepdims=True), 1e-20
        )
        # f32 products, never TF32 (a GPU f32 matmul may use it by default)
        cosg = jnp.matmul(d, jnp.asarray(sundir),
                          precision=jax.lax.Precision.HIGHEST)
        res = table.shape[0]
        theta = jnp.arccos(jnp.clip(cosg, -1.0, 1.0))
        f = theta / (2.0 * jnp.pi) * res
        i0 = jnp.clip(f.astype(jnp.int32), 0, res - 2)
        wfrac = f - i0.astype(jnp.float32)
        ph = table[i0] * (1.0 - wfrac) + table[i0 + 1] * wfrac
        ext = jnp.exp(-density * ray_len)
        inscatter = (
            albedo * (1.0 - ext[:, None]) * ph[:, None] * suncol[None, :]
        )
        out = ci * ext[:, None] + inscatter
        return jnp.where(hit[:, None], out, ci)
    if name in ("fog",):
        # standard RenderMan fog: mix toward background on 1-exp(-l/d)
        dist = max(_p1(params, "distance", 1.0), 1e-6)
        bg = np.asarray(_p1(params, "background", np.zeros(3)), np.float32)[:3]
        f = 1.0 - jnp.exp(-ray_len / dist)
        out = ci * (1.0 - f)[:, None] + f[:, None] * bg
        return jnp.where(hit[:, None], out, ci)
    if name in ("depthcue",):
        mind = _p1(params, "mindistance", 0.0)
        maxd = max(_p1(params, "maxdistance", 1.0), mind + 1e-6)
        bg = np.asarray(_p1(params, "background", np.zeros(3)), np.float32)[:3]
        f = jnp.clip((ray_len - mind) / (maxd - mind), 0.0, 1.0)
        out = ci * (1.0 - f)[:, None] + f[:, None] * bg
        return jnp.where(hit[:, None], out, ci)
    if name == "MOSAICfog":
        # examples/plane_sphere/Shaders/MOSAICfog.sl semantics (Blender
        # mist); defaults (isMist=0) are a no-op, matching the export
        if _p1(params, "isMist", 0.0) <= 0:
            return ci
        sta = _p1(params, "Sta", 0.0)
        di = _p1(params, "Di", 0.0)
        if sta >= di:
            return ci
        hi = _p1(params, "Hi", 0.0)
        misi = _p1(params, "Misi", 0.0)
        mtype = int(_p1(params, "MistType", 0.0))
        mistcol = np.asarray(_p1(params, "MistCol", np.zeros(3)), np.float32)[:3]
        li = ray_len - sta
        dl = di - sta
        if mtype == 0:
            dl = dl / jnp.clip(li / dl, 1e-6, 1.0)
        elif mtype == 2:
            dl = (dl + li) / 2.0
        d = 1.0 - jnp.clip(li / dl, 0.0, 1.0)
        if hi > 0:
            # height falloff on the world height of the hit point
            hfrac = jnp.clip(P[:, 1] / hi, 0.0, 1.0)
            d = d * (1.0 - hfrac) + 1.0 * hfrac
        d = d * (1.0 - misi)
        out = mistcol[None, :] * (1.0 - d)[:, None] + ci * d[:, None]
        return jnp.where(hit[:, None], out, ci)
    fn = _compile_stage(name, searchpaths, "volume")
    if fn is None:
        return ci
    B = ci.shape[0]
    sg, ctx = _flat_globals(ci, B, 1)
    # volume shaders read the ray vector I (length = ray length)
    sg_I = P * 0.0
    out = fn.run_vars(
        sg, dict(params), ctx,
        extra_globals={
            "Ci": jnp.asarray(ci),
            "I": jnp.asarray(P) * 0.0
            + jnp.asarray(ray_len)[:, None] * jnp.asarray([[0.0, 0.0, 1.0]]),
            "P": jnp.asarray(P),
        },
    )
    del sg_I
    return jnp.where(hit[:, None], jnp.reshape(out["Ci"], ci.shape), ci)


# ---------------------------------------------------------------------------
# displacement stage (vertex-level, scene compile time)
# ---------------------------------------------------------------------------


def displace_scene(desc) -> None:
    """Run bound displacement shaders over their geometries' vertices,
    in place, then rebuild vertex normals from the displaced mesh.
    Called once before scene compilation."""
    for g in desc.geoms:
        name = getattr(g.attrs, "displacement", None)
        if not name or getattr(g, "_displaced", False):
            continue  # idempotent: a second Renderer must not re-displace
        params = g.attrs.displacement_params
        if _displace_geom(g, name, params, desc.options.searchpaths):
            g._displaced = True
            log(LOG_INFO, "displaced '%s' over %d vertices", name,
                len(g.positions))


def _vertex_normals(P: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (geom.c ri_geom_calc_normals
    capability)."""
    fn = np.cross(P[idx[:, 1]] - P[idx[:, 0]], P[idx[:, 2]] - P[idx[:, 0]])
    vn = np.zeros_like(P)
    for k in range(3):
        np.add.at(vn, idx[:, k], fn)
    n = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(n, 1e-20)


def _displace_geom(g, name, params, searchpaths) -> bool:
    P = np.asarray(g.positions, dtype=np.float64)
    idx = np.asarray(g.indices)
    N = g.normals
    if N is None or len(N) != len(P):
        N = _vertex_normals(P, idx)
    N = np.asarray(N, dtype=np.float64)
    st = g.st if getattr(g, "st", None) is not None else None
    s = st[:, 0] if st is not None else np.zeros(len(P))
    t = st[:, 1] if st is not None else np.zeros(len(P))

    if name == "MOSAICdisplace":
        # examples/plane_sphere/Shaders/MOSAICdisplace.sl: displacement
        # map moves P along N by Disp * (tex - Mid); empty DispMap = noop
        dispmap = _pstr(params, "DispMap", "")
        if not dispmap:
            return False
        from lucille_tpu.imageio.loader import find_file, load_image

        found = find_file(dispmap, searchpaths)
        if found is None:
            log_once(LOG_WARN, f"DispMap '{dispmap}' not found; skipping")
            return False
        img = np.asarray(load_image(found), np.float64)
        disp = _p1(params, "Disp", 1.0)
        mid = _p1(params, "Mid", 0.5)
        from lucille_tpu.lights.envmap import _np_bilinear

        amp = disp * (_np_bilinear(img, s, t)[..., 0] - mid)
        P = P + amp[:, None] * N
    else:
        fn = _compile_stage(name, searchpaths, "displacement")
        if fn is None:
            return False
        import jax.numpy as jnp

        sg, ctx = _flat_globals(np.zeros((len(P), 3), np.float32), len(P), 1)
        sg.P = jnp.asarray(P, jnp.float32)
        sg.N = jnp.asarray(N, jnp.float32)
        sg.Ng = sg.N
        sg.s = jnp.asarray(s, jnp.float32)
        sg.t = jnp.asarray(t, jnp.float32)
        out = fn.run_vars(sg, dict(params), ctx)
        P = np.asarray(out["P"], dtype=np.float64)

    g.positions = P
    g.normals = _vertex_normals(P, idx)
    return True


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

_compiled: dict = {}


def _compile_stage(name, searchpaths, kind):
    """Find + compile ``name.sl`` on the searchpath; cache; warn once on
    failure (the reference warns per missing shader DSO)."""
    key = (name, kind)
    if key in _compiled:
        return _compiled[key]
    fn = None
    path = _find_sl(name, searchpaths)
    if path is not None:
        try:
            from lucille_tpu.shading.sl import compile_sl

            with open(path) as f:
                fn, _defaults = compile_sl(f.read())
            if fn.shader_kind != kind:
                log_once(LOG_WARN, f"'{name}.sl' is a {fn.shader_kind} "
                         f"shader, expected {kind}; using it anyway")
        except Exception as e:  # compile errors must not kill the render
            log_once(LOG_WARN, f"cannot compile {kind} shader '{name}': {e}")
            fn = None
    else:
        log_once(LOG_WARN, f"{kind} shader '{name}' not found on searchpath;"
                 " ignoring")
    _compiled[key] = fn
    return fn


def _flat_globals(ci_flat, w, h):
    """Minimal ShaderGlobals/ctx for non-surface stages."""
    import jax.numpy as jnp

    from lucille_tpu.shading.shader import ShaderContext, ShaderGlobals

    import jax

    B = ci_flat.shape[0]
    z = jnp.zeros((B, 3), jnp.float32)
    zs = jnp.zeros((B,), jnp.float32)
    xy = jnp.stack(
        [
            (jnp.arange(B, dtype=jnp.float32) % w) / max(w, 1),
            (jnp.arange(B, dtype=jnp.float32) // w) / max(h, 1),
        ],
        axis=-1,
    )
    sg = ShaderGlobals(
        P=jnp.concatenate([xy, jnp.zeros((B, 1))], axis=-1),
        N=z + jnp.asarray([0.0, 0.0, 1.0]),
        Ng=z + jnp.asarray([0.0, 0.0, 1.0]),
        I=z,
        E=z,
        Cs=jnp.asarray(ci_flat, jnp.float32),
        Os=jnp.ones((B, 3), jnp.float32),
        s=xy[:, 0],
        t=xy[:, 1],
        u=zs,
        v=zs,
        dPdu=z + jnp.asarray([1.0, 0.0, 0.0]),
        dPdv=z + jnp.asarray([0.0, 1.0, 0.0]),
    )
    ctx = ShaderContext(scene=None, key=jax.random.key(0))
    return sg, ctx
