#!/usr/bin/env python3
"""Smoke test of the render path on one GPU: the quickest proof that the
system still starts, renders and agrees with its plain reference there.

    python chip_smoke.py          # one card, phases 1-5
    python chip_smoke.py --four   # four cards: sharded renders vs one card

Phases (one process, one card; each prints one JSON line):

1. device   — require a GPU; print its kind and nvidia-smi's name and
               power limit; the compile-cache directory in use;
2. cli      — render scenes/ao_objects.rib (640x480, 3x3, 64 gather rays)
               through lucille_tpu.cli.main; the HDR must be finite with a
               non-zero mean; then the second-frame time of the same scene;
3. methods  — whitted, pathtrace and sunsky-AO frames of the same scene;
4. heightfield — the 1,045,458-triangle procedural heightfield
               (bench_large.heightfield_scene(724), 160x120, 2x2, 64 AO
               rays) with the accelerator base/backend.py chooses;
5. parity   — every Triton kernel against accel/bruteforce.py (f32) on
               full-width wavefronts, mismatch rates within the stated
               tolerances; the Triton custom calls in the compiled tile
               steps;
6. timings  — each kernel alone and each cell's frame, with the kernels
               and with XLA's plain version of them.

Tolerances (phase 5): hit/miss and any-hit agree on >= 99.99% of rays
(or (ray, stratum) pairs), and where both sides hit the same triangle
|t - t_ref| <= 1e-4 (1 + t).  The formulations round differently only on
triangle edges and at grazing angles.

Exits non-zero, printing no result, when JAX finds no GPU.  The last line
of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

AO_RIB = os.path.join(HERE, "scenes", "ao_objects.rib")
OUT_DIR = os.path.join(HERE, "chiprun_out", "smoke")
AO_TILE = 240  # bench.py's tile for the AO scene
HF_TILE = 128  # bench_large.py's tile
SUNSKY = 'AreaLightSource "sunsky" 1 "hour" [10.0] "turbidity" [2.2]\n'
DISTANT = ('LightSource "distantlight" 1 "intensity" [1.0] '
           '"from" [0 8 4] "to" [0 0 0]\n')

MATCH_MIN = 0.9999  # hit/miss and any-hit agreement
T_RTOL = 1e-4  # |t - t_ref| <= T_RTOL * (1 + t) on shared triangles
MIN_HF_RAYS = 65536  # eye rays compared on the 1M heightfield


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


# ---------------------------------------------------------------------------
# scenes and frames
# ---------------------------------------------------------------------------


def ao_state(inject=None, method=None, accel=None):
    from lucille_tpu.ri.api import RiState
    from lucille_tpu.rib.parser import parse_rib

    with open(AO_RIB) as f:
        text = f.read()
    if inject:
        text = text.replace("WorldBegin", "WorldBegin\n" + inject, 1)
    state = RiState()
    parse_rib(text, state)
    if method is not None:
        state.options.render_method = method
    if accel is not None:
        state.options.accel_method = accel
    return state


def hf_state(n, accel=None):
    from bench_large import heightfield_scene

    state = heightfield_scene(n)
    if accel is not None:
        state.options.accel_method = accel
    return state


_RENDERERS = {}


def renderer(state, tile, mesh=None, accel_tag=None, key=None):
    """Renderer over the state's scene; accel_tag swaps the compiled
    scene's accelerator tag (the plain per-ray walk over the same tile
    BVH is only reachable this way).  With a key, a renderer built once
    is reused, so its compiled tile step is too."""
    from lucille_tpu.render.renderer import Renderer

    if key is not None and key in _RENDERERS:
        return _RENDERERS[key]
    r = Renderer(state.scene, tile_size=tile, mesh=mesh)
    if accel_tag is not None:
        r.scene = dataclasses.replace(r.scene, accel=accel_tag)
    if key is not None:
        _RENDERERS[key] = r
    return r


def frames(r, n):
    """Render n frames; returns (last image, [seconds per frame], rays of
    one frame).  render_frame returns host numpy, so each time covers the
    device work."""
    import numpy as np

    secs = []
    img = None
    for _ in range(n):
        r.stats.nrays = 0
        t0 = time.perf_counter()
        img = r.render_frame()
        secs.append(time.perf_counter() - t0)
    require(np.isfinite(img).all(), "image finite")
    return img, secs, int(r.stats.nrays)


def check_image(name, img):
    import numpy as np

    mean = float(np.asarray(img).mean())
    require(np.isfinite(img).all(), f"{name}: finite")
    require(mean > 0.0, f"{name}: non-zero mean")
    return mean


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(jax, backend, count):
    devs = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    cache = backend.enable_compile_cache()
    n_cached = len(os.listdir(cache)) if cache and os.path.isdir(cache) else 0
    print(smi, flush=True)
    emit("device", platform=devs[0].platform, kind=devs[0].device_kind,
         count=len(devs), nvidia_smi=smi.splitlines()[:count],
         jax=jax.__version__, compile_cache=cache,
         cache_entries_before=n_cached)


def phase_cli():
    from lucille_tpu import cli
    from lucille_tpu.imageio.rgbe import read_hdr

    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, "ao_objects.hdr")
    t0 = time.perf_counter()
    rc = cli.main([AO_RIB, "--output", out, "--tile", str(AO_TILE)])
    first = time.perf_counter() - t0
    require(rc == 0, "cli exit code 0")
    img = read_hdr(out)
    require(img.shape == (480, 640, 3), f"cli image shape {img.shape}")
    mean = check_image("cli AO frame", img)
    # the same scene and tile again: the second frame is the steady one
    r = renderer(ao_state(), AO_TILE, key=("ao", "auto"))
    _, secs, rays = frames(r, 3)
    emit("cli", scene="scenes/ao_objects.rib", resolution="640x480",
         pixel_samples="3x3", gather_rays=64, accel=r.scene.accel,
         n_tris=r.scene.n_tris, mean=mean, rays=rays,
         cli_s_with_compile=first, warm_s=secs[0], frame_s=secs[1:],
         rays_per_s=rays / min(secs[1:]))


def phase_methods():
    out = {}
    for name, inject, method in (
        ("whitted", DISTANT, "whitted"),
        ("pathtrace", DISTANT, "pathtrace"),
        ("sunsky_ao", SUNSKY, None),
    ):
        r = renderer(ao_state(inject=inject, method=method), AO_TILE,
                     key=(name, "auto"))
        img, secs, rays = frames(r, 3)
        out[name] = dict(mean=check_image(name, img), rays=rays,
                         warm_s=secs[0], frame_s=secs[1:],
                         accel=r.scene.accel)
    emit("methods", **out)


def phase_heightfield():
    t0 = time.perf_counter()
    r = renderer(hf_state(724), HF_TILE, key=("hf1m", "auto"))
    setup = time.perf_counter() - t0
    require(r.scene.n_tris == 1045458, "1M heightfield triangle count")
    img, secs, rays = frames(r, 3)
    emit("heightfield", n_tris=r.scene.n_tris, accel=r.scene.accel,
         n_nodes=r.scene.n_nodes, resolution="160x120", pixel_samples="2x2",
         gather_rays=64, mean=check_image("heightfield", img), rays=rays,
         setup_s=setup, warm_s=secs[0], frame_s=secs[1:],
         rays_per_s=rays / min(secs[1:]))


def eye_rays(state):
    """Every subpixel eye ray of the state's frame: (org, dirn) (B, 3)."""
    import jax.numpy as jnp
    import numpy as np

    from lucille_tpu.sampling.hammersley import subpixel_samples

    opt = state.options
    xs_n, ys_n = (int(v) for v in opt.current_display().sampling_rates)
    jit_np, _ = subpixel_samples(xs_n, ys_n)
    px = np.arange(opt.width, dtype=np.float32)[None, :, None]
    py = np.arange(opt.height, dtype=np.float32)[:, None, None]
    shape = (opt.height, opt.width, len(jit_np))
    fx = np.broadcast_to(px + jit_np[:, 0], shape).reshape(-1)
    fy = np.broadcast_to(py + jit_np[:, 1], shape).reshape(-1)
    return state.camera.generate_rays(jnp.asarray(fx), jnp.asarray(fy))


def chunked(fn, n, chunk, *arrays):
    """fn over row chunks of arrays; results concatenated."""
    import jax.numpy as jnp

    outs = [fn(*(a[i:i + chunk] for a in arrays)) for i in range(0, n, chunk)]
    if isinstance(outs[0], dict):
        return {k: jnp.concatenate([o[k] for o in outs]) for k in ("t", "tri", "hit")}
    return jnp.concatenate(outs)


def closest_parity(name, got, ref):
    import numpy as np

    h_g, h_r = np.asarray(got["hit"]), np.asarray(ref["hit"])
    agree = float((h_g == h_r).mean())
    same = h_g & h_r & (np.asarray(got["tri"]) == np.asarray(ref["tri"]))
    t_g, t_r = np.asarray(got["t"])[same], np.asarray(ref["t"])[same]
    t_bad = int((np.abs(t_g - t_r) > T_RTOL * (1.0 + np.abs(t_r))).sum())
    res = dict(rays=int(h_g.size), hit_rate=float(h_r.mean()),
               hit_agree=agree, hit_mismatch_rate=1.0 - agree,
               same_tri=int(same.sum()), t_out_of_tol=t_bad)
    require(agree >= MATCH_MIN, f"{name}: hit agreement {agree}")
    require(t_bad == 0, f"{name}: {t_bad} t values out of tolerance")
    return res


def anyhit_parity(name, got, ref):
    import numpy as np

    g, r = np.asarray(got), np.asarray(ref)
    agree = float((g == r).mean())
    require(agree >= MATCH_MIN, f"{name}: any-hit agreement {agree}")
    return dict(rays=int(g.size), occluded_rate=float(r.mean()),
                agree=agree, mismatch_rate=1.0 - agree)


def timed(fn, *args, reps=3):
    """(first call s, [steady call s]) of a jitted fn, with its outputs
    pulled to the host."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        secs.append(time.perf_counter() - t0)
    return first, secs


def triton_calls(jitted, *args):
    """(kernel names found in the lowered step, Triton custom calls in
    the compiled step)."""
    lowered = jitted.lower(*args)
    names = sorted(
        n for n in ("lucille_dense_closest", "lucille_dense_anyhit",
                    "lucille_ao_gather", "lucille_bvh_closest",
                    "lucille_bvh_anyhit")
        if n in lowered.as_text()
    )
    compiled = lowered.compile().as_text()
    return names, compiled.count("xla.gpu.triton")


def tile_step_args(r, x0=0, y0=0):
    """Arguments of the renderer's compiled tile step for tile (x0, y0)."""
    import jax
    import jax.numpy as jnp

    from lucille_tpu.render.film import subsample_filter_table
    from lucille_tpu.sampling.hammersley import subpixel_samples

    opt = r.desc.options
    xs_n, ys_n = (int(v) for v in opt.current_display().sampling_rates)
    jit_np, _ = subpixel_samples(xs_n, ys_n)
    weights = jnp.asarray(subsample_filter_table(
        opt.pixel_filter, jit_np, *opt.pixel_filter_width))
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), x0), y0)
    return (r.scene, jnp.int32(x0), jnp.int32(y0),
            jnp.asarray(jit_np, jnp.float32), weights, key)


def phase_parity():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lucille_tpu.accel import bruteforce
    from lucille_tpu.accel.pallas_ao import (
        pallas_ao_occlusion_bits, stratum_direction,
    )
    from lucille_tpu.accel.pallas_bvh import (
        _conetile_rays, _pallas_bvh_any_hit, pallas_bvh_closest_hit,
    )
    from lucille_tpu.accel.pallas_isect import (
        pallas_any_hit, pallas_closest_hit,
    )
    from lucille_tpu.transport.ao import _interp_normal, ortho_basis

    hi = jax.default_matmul_precision("highest")
    brute_c = jax.jit(bruteforce.brute_closest_hit)
    brute_a = jax.jit(bruteforce.brute_any_hit)
    CH = 1 << 19

    # ---- dense kernels on the full 640x480x9 eye wavefront -------------
    state = ao_state()
    r_ao = renderer(state, AO_TILE, key=("ao", "auto"))
    sc = r_ao.scene
    require(sc.accel == "pallas", "AO scene uses the dense kernels")
    org, dirn = eye_rays(state)
    B = org.shape[0]
    with hi:
        ref = chunked(lambda o, d: brute_c(sc, o, d), B, CH, org, dirn)
        got = pallas_closest_hit(sc, org, dirn)
        dense_closest = closest_parity("dense closest", got, ref)
        t_ref = jnp.where(ref["hit"], ref["t"], 1.0)
        got_a = pallas_any_hit(sc, org, dirn, tmax=0.5 * t_ref)
        ref_a = chunked(lambda o, d, t: brute_a(sc, o, d, tmax=t), B, CH,
                        org, dirn, 0.5 * t_ref)
        dense_any = anyhit_parity("dense any-hit (t < t_hit/2)", got_a, ref_a)
        got_a = pallas_any_hit(sc, org, dirn)
        dense_any_inf = anyhit_parity("dense any-hit", got_a, ref["hit"])

        # ---- AO gather: the kernel's own directions on both sides ----
        hit = got["hit"]
        P = org + jnp.where(hit, got["t"], 0.0)[:, None] * dirn
        Ns = _interp_normal(sc, got)
        b0, b1, b2 = ortho_basis(Ns)
        P_off = P + Ns * sc.eps
        key = jax.random.key(1)
        occ, bits, u01 = pallas_ao_occlusion_bits(
            sc, P_off, b0, b1, b2, hit, key, 8, 8
        )
        basis = tuple(tuple(b[:, k] for k in range(3)) for b in (b0, b1, b2))
        idx = jnp.nonzero(hit)[0]
        mism = 0
        pairs = 0
        for s in range(64):
            w = jnp.stack(stratum_direction(jnp.int32(s), u01[0], u01[1],
                                            *basis, 8, 8), axis=-1)
            want = chunked(lambda o, d: brute_a(sc, o, d), idx.shape[0], CH,
                           P_off[idx], w[idx])
            bit = ((bits[s // 32, idx] >> (s % 32)) & 1) == 1
            mism += int(jnp.sum(bit != want))
            pairs += int(idx.shape[0])
        ao_rate = 1.0 - mism / pairs
        require(ao_rate >= MATCH_MIN, f"AO gather agreement {ao_rate}")
        pop = jnp.sum(jax.lax.population_count(bits), axis=0)
        require(bool(jnp.all(occ == pop.astype(jnp.float32))),
                "AO counts equal bit popcounts")
    emit("kernel_parity_dense", dense_closest=dense_closest,
         dense_anyhit_window=dense_any, dense_anyhit=dense_any_inf,
         ao_gather=dict(pairs=pairs, agree=ao_rate, mismatch_rate=1 - ao_rate,
                        mismatched_pairs=mism))

    # ---- BVH kernels on the 1M heightfield ------------------------------
    hstate = hf_state(724)
    r_hf = renderer(hstate, HF_TILE, key=("hf1m", "auto"))
    hs = r_hf.scene
    require(hs.accel == "pbvh", "1M heightfield uses the tile BVH")
    org_h, dir_h = eye_rays(hstate)
    Bh = org_h.shape[0]
    require(Bh >= MIN_HF_RAYS, "at least 64k eye rays")
    with hi:
        ref_h = chunked(lambda o, d: brute_c(hs, o, d), Bh, 1 << 16,
                        org_h, dir_h)
        got_h = pallas_bvh_closest_hit(hs, org_h, dir_h)
        bvh_closest = closest_parity("bvh closest", got_h, ref_h)
        hit_h = ref_h["hit"]
        Ph = org_h + jnp.where(hit_h, ref_h["t"], 0.0)[:, None] * dir_h
        Nh = _interp_normal(hs, dict(got_h))
        c0, c1, c2 = ortho_basis(Nh)
        oo, dd, _order, _layout = _conetile_rays(
            hs, Ph + Nh * hs.eps, c0, c1, c2, hit_h, jax.random.key(2), 8, 8
        )
        got_ah, _ = _pallas_bvh_any_hit(hs, oo, dd, None, 0.0)
        ref_ah = chunked(lambda o, d: brute_a(hs, o, d), oo.shape[0],
                         1 << 18, oo, dd)
        bvh_any = anyhit_parity("bvh any-hit (AO rays)", got_ah, ref_ah)
    emit("kernel_parity_bvh", bvh_closest=bvh_closest, bvh_anyhit_ao=bvh_any)

    # ---- nothing interpreted: Triton custom calls in the tile steps -----
    found = {}
    r_ao.render_frame()
    found["ao"] = triton_calls(r_ao._kernel, *tile_step_args(r_ao))
    r_pt = renderer(ao_state(inject=DISTANT, method="pathtrace"), AO_TILE,
                    key=("pathtrace", "auto"))
    r_pt.render_frame()
    found["pathtrace"] = triton_calls(r_pt._kernel, *tile_step_args(r_pt))
    r_hf.render_frame()
    found["heightfield"] = triton_calls(r_hf._kernel, *tile_step_args(r_hf))
    need = {"ao": {"lucille_dense_closest", "lucille_ao_gather"},
            "pathtrace": {"lucille_dense_closest", "lucille_dense_anyhit"},
            "heightfield": {"lucille_bvh_closest", "lucille_bvh_anyhit"}}
    for k, (names, ncalls) in found.items():
        require(need[k] <= set(names), f"{k} tile step names {names}")
        require(ncalls >= len(need[k]), f"{k}: {ncalls} Triton calls")
    emit("triton_calls", **{k: {"kernels": v[0], "custom_calls": v[1]}
                            for k, v in found.items()})

    return dict(sc=sc, org=org, dirn=dirn, hs=hs, org_h=org_h, dir_h=dir_h,
                oo=oo, dd=dd)


def phase_timings(w):
    """Each kernel against XLA's plain version: alone on the wavefronts
    of phase_parity (w), then end to end on the frame."""
    import jax

    from lucille_tpu.accel import bruteforce, mxu
    from lucille_tpu.accel.pallas_bvh import (
        _pallas_bvh_any_hit, pallas_bvh_closest_hit,
    )
    from lucille_tpu.accel.pallas_isect import (
        pallas_any_hit, pallas_closest_hit,
    )
    from lucille_tpu.accel.traverse import walk_any_hit, walk_closest_hit

    sc, org, dirn = w["sc"], w["org"], w["dirn"]
    hs, org_h, dir_h, oo, dd = (w[k] for k in ("hs", "org_h", "dir_h",
                                               "oo", "dd"))
    B = org.shape[0]
    CH = 1 << 19
    brute_c = bruteforce.brute_closest_hit
    with jax.default_matmul_precision("highest"):
        iso = {}
        _, s = timed(jax.jit(pallas_closest_hit), sc, org, dirn)
        iso["dense_closest"] = {"kernel_s": s}
        _, s = timed(jax.jit(lambda a, o, d: chunked(
            lambda o2, d2: brute_c(a, o2, d2), B, CH, o, d)), sc, org, dirn)
        iso["dense_closest"]["bruteforce_s"] = s
        _, s = timed(jax.jit(lambda a, o, d: chunked(
            lambda o2, d2: mxu.mxu_closest_hit(a, o2, d2), B, CH, o, d)),
            sc, org, dirn)
        iso["dense_closest"]["mxu_s"] = s
        _, s = timed(jax.jit(pallas_any_hit), sc, org, dirn)
        iso["dense_anyhit"] = {"kernel_s": s}
        _, s = timed(jax.jit(lambda a, o, d: chunked(
            lambda o2, d2: mxu.mxu_any_hit(a, o2, d2), B, CH, o, d)),
            sc, org, dirn)
        iso["dense_anyhit"]["mxu_s"] = s
        _, s = timed(jax.jit(pallas_bvh_closest_hit), hs, org_h, dir_h)
        iso["bvh_closest"] = {"kernel_s": s}
        _, s = timed(jax.jit(walk_closest_hit), hs, org_h, dir_h, reps=1)
        iso["bvh_closest"]["walk_s"] = s
        _, s = timed(jax.jit(lambda a, o, d: _pallas_bvh_any_hit(
            a, o, d, None, 0.0)[0]), hs, oo, dd)
        iso["bvh_anyhit"] = {"kernel_s": s, "rays": int(oo.shape[0])}
        _, s = timed(jax.jit(walk_any_hit), hs, oo, dd, reps=1)
        iso["bvh_anyhit"]["walk_s"] = s
    emit("kernel_times", **iso)

    # frames with each kernel and with XLA's plain version (renderers
    # built in earlier phases are reused, compiled tile steps included)
    for name, mk, tile, tags in (
        ("ao", lambda a: ao_state(accel=a), AO_TILE,
         (("auto", None), ("mxu", None), ("bruteforce", None))),
        ("whitted", lambda a: ao_state(inject=DISTANT, method="whitted",
                                       accel=a), AO_TILE,
         (("auto", None), ("mxu", None))),
        ("hf130k", lambda a: hf_state(256, a), HF_TILE,
         (("auto", None), ("auto", "walk"))),
        ("hf1m", lambda a: hf_state(724, a), HF_TILE,
         (("auto", None), ("auto", "walk"))),
    ):
        times = {}
        for accel, tag in tags:
            r = renderer(mk(accel), tile, accel_tag=tag,
                         key=(name, tag or accel))
            _, secs, rays = frames(r, 3)
            times[r.scene.accel] = dict(warm_s=secs[0], frame_s=secs[1:],
                                        rays=rays)
        emit("frame_times", cell=name, **times)


def phase_four(jax):
    """Sharded renders on a 4-card mesh against one card, same key."""
    import numpy as np

    from lucille_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    out = {}
    for name, mk, tile in (
        ("ao_objects", lambda: ao_state(), 160),
        ("heightfield_1m", lambda: hf_state(724), 64),
    ):
        r1 = renderer(mk(), tile)
        img1, secs1, rays1 = frames(r1, 2)
        r4 = renderer(mk(), tile, mesh=mesh)
        img4, secs4, rays4 = frames(r4, 2)
        rel = float(np.abs(img4 - img1).mean() / max(np.abs(img1).mean(), 1e-30))
        require(rays4 == rays1, f"{name}: nrays {rays4} vs {rays1}")
        require(rel <= 1e-5, f"{name}: relative mean difference {rel}")
        out[name] = dict(rays_1=rays1, rays_4=rays4, rel_mean_diff=rel,
                         max_abs_diff=float(np.abs(img4 - img1).max()),
                         frame_s_1=secs1[1], frame_s_4=secs4[1],
                         mean=check_image(name, img4))
    emit("four", mesh_devices=int(mesh.devices.size), **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the four-card sharded renders")
    args = ap.parse_args(argv)
    os.environ["LUCILLE_NO_SPAWN_VIEWER"] = "1"

    import jax

    from lucille_tpu.base import backend

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    count = 4 if args.four else 1
    if len(devs) < count:
        print(f"chip_smoke: needs {count} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2

    phase_device(jax, backend, count)
    if args.four:
        phase_four(jax)
    else:
        phase_cli()
        phase_methods()
        phase_heightfield()
        phase_timings(phase_parity())
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
