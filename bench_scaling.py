"""Multi-device scaling-efficiency harness.

BASELINE target: >= 80% rays/s scaling efficiency from 1 chip upward.
Measures the sharded tile renderer (parallel/mesh.py) on 1..N devices of
whatever backend is active and prints one JSON line per mesh size plus a
summary.  CPU runs (JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8) validate the
mechanism; on a multi-GPU host the same harness measures real scaling.

    python bench_scaling.py [--devices 1 2 4 8] [--size 256]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

AO_SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scenes", "ao_objects.rib")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--gather", type=int, default=16)
    a = ap.parse_args()

    import jax

    from lucille_tpu.base import backend
    from lucille_tpu.parallel.mesh import make_mesh
    from lucille_tpu.ri.api import RiState
    from lucille_tpu.rib.parser import parse_rib_file

    backend.enable_compile_cache()
    pool = jax.devices()
    ndev_avail = len(pool)
    if a.devices and max(a.devices) > ndev_avail:
        raise SystemExit(
            f"need {max(a.devices)} devices, have {ndev_avail}"
        )
    sizes = a.devices or [n for n in (1, 2, 4, 8) if n <= ndev_avail]

    state = RiState()
    parse_rib_file(AO_SCENE, state)
    state.Format(a.size, a.size * 3 // 4)
    state.options.gather_nsamples = a.gather

    # virtual CPU devices timeshare the same physical cores: aggregate
    # throughput stays flat no matter how many devices the mesh has, so
    # wall-clock efficiency is only meaningful on real chips.  Detect it
    # from the mesh's own devices.
    virtual = False

    results = []
    ref_img = None
    for n in sizes:
        mesh = make_mesh(n, devices=pool)
        dev0 = next(iter(mesh.devices.flat))
        virtual = dev0.platform == "cpu" and (
            "xla_force_host_platform_device_count"
            in os.environ.get("XLA_FLAGS", "")
        )
        # the unified production Renderer, sharded over the mesh
        from lucille_tpu.render.renderer import Renderer

        r = Renderer(state.scene, tile_size=a.tile, mesh=mesh)
        r.render_frame()  # warm (compile + claim)
        nrays0 = r.stats.nrays
        t0 = time.perf_counter()
        img = r.render_frame()
        dt = time.perf_counter() - t0
        nrays = r.stats.nrays - nrays0
        rps = nrays / dt
        results.append((n, rps))
        print(
            json.dumps(
                {
                    "metric": "rays_per_sec",
                    "devices": n,
                    "value": rps,
                    "seconds": dt,
                    "virtual_devices": virtual,
                }
            )
        )
        # sharding-invariance: every mesh size must produce the same frame
        import numpy as np

        if ref_img is None:
            ref_img = np.asarray(img)
        else:
            d = float(np.abs(np.asarray(img) - ref_img).max())
            if d > 1e-5:
                print(json.dumps({"metric": "sharding_mismatch", "max": d}))
                return 1

    if len(results) > 1:
        base_n, base_rps = results[0]
        last_n, last_rps = results[-1]
        if virtual:
            # fixed physical compute: the correct invariant is that the
            # AGGREGATE stays flat while work divides across devices
            eff = last_rps / base_rps
            print(
                json.dumps(
                    {
                        "metric": "virtual_aggregate_retention",
                        "from_devices": base_n,
                        "to_devices": last_n,
                        "value": eff,
                        "note": (
                            "virtual CPU devices share the physical cores; "
                            "per-chip scaling_efficiency (target 0.8) needs "
                            "real multi-chip hardware — this run validates "
                            "the sharded mechanism + output invariance"
                        ),
                    }
                )
            )
        else:
            eff = (last_rps / last_n) / (base_rps / base_n)
            print(
                json.dumps(
                    {
                        "metric": "scaling_efficiency",
                        "from_devices": base_n,
                        "to_devices": last_n,
                        "value": eff,
                        "target": 0.8,
                    }
                )
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
