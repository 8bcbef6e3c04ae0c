"""Benchmark: render throughput of the in-repo scenes on the default
backend.

Prints ONE JSON line:
    {"metric": "rays_per_sec", "value": N, "unit": "rays/s", ...}

The AO cell renders scenes/ao_objects.rib at 640x480 (lucille's default
resolution), 3x3 subpixel samples, 64 AO rays; whitted, pathtrace and
sunsky-AO render the same scene.  Ray counting matches the reference's
(raytrace.c:96): eye rays + hemisphere rays for primary hits only.  The
heightfield cells (bench_large.py) are the scenes the CPU-lucille
baselines there were measured on; the AO-scene cells have no CPU-lucille
baseline (the reference's own example is not in this repository).
"""

from __future__ import annotations

import json
import os
import sys
import time

RIB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes",
                   "ao_objects.rib")


def _measure(rib, width, height, tile, method=None, inject=None):
    from lucille_tpu.render.renderer import Renderer
    from lucille_tpu.ri.api import RiState
    from lucille_tpu.rib.parser import parse_rib, parse_rib_file

    state = RiState()
    if inject:
        # splice extra RIB (e.g. a sunsky light) after WorldBegin
        with open(rib) as f:
            text = f.read().replace("WorldBegin", "WorldBegin\n" + inject, 1)
        parse_rib(text, state)
    else:
        parse_rib_file(rib, state)
    state.Format(width, height)
    if method is not None:
        state.options.render_method = method
    renderer = Renderer(state.scene, tile_size=tile)
    # warmup frame: pays the one-time device-claim latency + kernel
    # compile on the SAME renderer (a fresh Renderer would close over new
    # constants and recompile)
    renderer.render_frame()
    renderer.stats.nrays = 0
    renderer.stats.render_seconds = 0.0
    # best of two timed frames; both samples are returned
    samples = []
    t0 = time.perf_counter()
    renderer.render_frame()
    samples.append(time.perf_counter() - t0)
    nrays = renderer.stats.nrays
    t0 = time.perf_counter()
    renderer.render_frame()
    samples.append(time.perf_counter() - t0)
    return nrays, min(samples), samples


def main() -> int:
    import jax

    from bench_large import measure as measure_large
    from lucille_tpu.base import backend

    backend.enable_compile_cache()
    width, height = 640, 480
    tile = int(os.environ.get("BENCH_TILE", "240"))

    rays, dt, frame_samples = _measure(RIB, width, height, tile)
    rays_per_sec = rays / dt

    ps = {}
    # every non-AO integrator on the same scene.  Bounce rays count LIVE
    # lanes only (raytrace.c:96 counts actual ri_raytrace calls).
    for method in ("whitted", "pathtrace"):
        rays_m, dt_m, m_samples = _measure(
            RIB, width, height, tile, method=method
        )
        ps[f"{method}_rays_per_sec"] = rays_m / dt_m
        ps[f"{method}_seconds"] = dt_m
        ps[f"{method}_frame_samples"] = m_samples

    # sunsky-AO on the same scene (the fused gather's per-stratum
    # occlusion bitmask path, transport/ao.py)
    rays_sk, dt_sk, sk_samples = _measure(
        RIB, width, height, tile,
        inject='AreaLightSource "sunsky" 1 "hour" [10.0] '
               '"turbidity" [2.2]\n',
    )
    ps["sunsky_ao_rays_per_sec"] = rays_sk / dt_sk
    ps["sunsky_ao_seconds"] = dt_sk
    ps["sunsky_ao_frame_samples"] = sk_samples

    # large scenes through the tile BVH: 130,050 and 1,045,458 triangles
    # (bench_large.py; vs CPU-lucille on the same procedural scenes)
    for n, name in ((256, "heightfield_130k"), (724, "heightfield_1m")):
        lg = measure_large(n)
        ps[f"{name}_rays_per_sec"] = lg["value"]
        ps[f"{name}_vs_baseline"] = lg["vs_baseline"]
        ps[f"{name}_seconds"] = lg["seconds"]
        ps[f"{name}_frame_samples"] = lg["frame_samples"]

    print(
        json.dumps(
            {
                "metric": "rays_per_sec",
                "value": rays_per_sec,
                "unit": "rays/s",
                "detail": {
                    "scene": "scenes/ao_objects.rib",
                    "resolution": f"{width}x{height}",
                    "pixel_samples": "3x3",
                    "gather_rays": 64,
                    "rays": rays,
                    "seconds": dt,
                    "frames_timed": 2,
                    "frame_samples": frame_samples,
                    "backend": jax.devices()[0].platform,
                    "device": jax.devices()[0].device_kind,
                    **ps,
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
