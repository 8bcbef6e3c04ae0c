"""Command-line renderer: the `lsh` equivalent.

Mirrors the reference front-end (src/lsh/main.c:420-434):

    python -m lucille_tpu.cli [options] scene.rib

    --pixelsamples N   override PixelSamples (main.c:298-306)
    --maxraydepth N    override max ray depth
    --output FILE      override the display name
    --gather-rays N    override AO/final-gather ray count
    --tile N           tile (bucket) size, default 64 (render.c:197 uses 32)
    --order O          spiral|scanline|zorder|hilbert (render.h:36-38)
    --accel A          bvh|bruteforce (Option "raytrace" "accel_method")
    --debug --verbose  logging toggles (main.c:328-341)

CLI overrides are applied at WorldBegin through the backdoor callback,
exactly like the reference (backdoor.h:14-16, main.c:213-241).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lucille-tpu",
        description="RenderMan-style renderer in JAX (lsh equivalent)",
    )
    p.add_argument(
        "rib", nargs="?", default=None,
        help="RIB scene file (optionally gzip'd); omit for the interactive shell",
    )
    p.add_argument("--output", "-o", help="override output file name")
    p.add_argument(
        "--display",
        help="override the display driver (file|framebuffer|socket|null)",
    )
    p.add_argument("--pixelsamples", type=int, help="subpixel samples per axis")
    p.add_argument("--maxraydepth", type=int, help="maximum ray depth")
    p.add_argument("--gather-rays", type=int, help="AO/final gather rays")
    p.add_argument("--tile", type=int, default=64, help="tile size (default 64)")
    p.add_argument(
        "--order",
        default=None,
        choices=["spiral", "scanline", "zorder", "hilbert"],
        help="tile order (default spiral)",
    )
    p.add_argument(
        "--accel",
        choices=["auto", "bvh", "grid", "bruteforce", "mxu", "pallas"],
        help="accel override (auto: base/backend.py chooses per platform "
        "and scene size)",
    )
    p.add_argument(
        "--method",
        choices=["ao", "whitted", "pathtrace", "dirtmap", "shader"],
        help="integrator override (Option \"renderer\" \"method\")",
    )
    p.add_argument("--nthreads", type=int, help="accepted for lsh compatibility")
    p.add_argument(
        "--mesh",
        type=int,
        default=None,
        metavar="N",
        help="shard tiles over an N-device mesh (default: all devices in "
        "a multi-process run, single device otherwise)",
    )
    p.add_argument(
        "--coordinator",
        default=None,
        metavar="HOST:PORT",
        help="multi-host coordinator address (jax.distributed; the "
        "ri_parallel_init analog, parallel.c:62)",
    )
    p.add_argument(
        "--num-processes", type=int, default=None, help="multi-host process count"
    )
    p.add_argument(
        "--process-id", type=int, default=None, help="this host's process index"
    )
    p.add_argument(
        "--recover",
        action="store_true",
        help="tile-level checkpoint + resume (the reference accepts PRMan's "
        "-recover but ignores it, main.c:291; this one works)",
    )
    p.add_argument("--width", type=int, help="override image width")
    p.add_argument("--height", type=int, help="override image height")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--stats", action="store_true", help="print ray statistics")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    # multi-host bring-up FIRST, before anything touches a JAX backend —
    # the reference calls ri_parallel_init before RiBegin (main.c:119)
    from lucille_tpu.parallel.distributed import (
        barrier,
        initialize_distributed,
        is_primary_host,
    )

    distributed = initialize_distributed(
        args.coordinator, args.num_processes, args.process_id
    )

    from lucille_tpu.base import backend

    backend.enable_compile_cache()  # also rejects unsupported platforms

    from lucille_tpu.base.log import set_debug
    from lucille_tpu.base.timer import get_timer
    from lucille_tpu.display.drivers import get_display_driver
    from lucille_tpu.render.renderer import Renderer
    from lucille_tpu.ri.api import RiState
    from lucille_tpu.rib.parser import parse_rib_file

    if args.debug:
        set_debug(True)

    if args.rib is None:
        # no scene: drop into the interactive shell (lsh.c behavior)
        from lucille_tpu.shell import Shell

        Shell().run()
        return 0

    timer = get_timer()

    def apply_overrides(state: RiState):
        """Backdoor world_begin callback (main.c:213-241)."""
        opt = state.options
        if args.pixelsamples is not None:
            state.PixelSamples(args.pixelsamples, args.pixelsamples)
        if args.maxraydepth is not None:
            opt.max_ray_depth = args.maxraydepth
        if args.gather_rays is not None:
            opt.gather_nsamples = args.gather_rays
        if args.accel is not None:
            opt.accel_method = args.accel
        if args.method is not None:
            opt.render_method = args.method
        if args.order is not None:
            opt.bucket_order = args.order
        if args.width is not None or args.height is not None:
            state.Format(args.width or opt.width, args.height or opt.height)
        if args.output is not None:
            disp = opt.current_display()
            disp.name = args.output
            if disp.driver == "framebuffer":
                disp.driver = "file"
        if args.display is not None:
            opt.current_display().driver = args.display
        opt.tile_size = args.tile

    state = RiState()
    state.world_begin_cb = apply_overrides

    timer.start("RIB parsing")
    try:
        parse_rib_file(args.rib, state)
    except FileNotFoundError:
        print(f"lucille-tpu: cannot open '{args.rib}'")
        return 1
    timer.end("RIB parsing")

    if state.world_block == 0:
        # RIB had no WorldBegin/WorldEnd (e.g. a shader-only snippet):
        # nothing to render, mirroring lsh which simply exits cleanly.
        return 0

    desc = state.scene
    opt = desc.options

    mesh = None
    if args.mesh is not None or distributed:
        from lucille_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh)  # None -> all (global) devices
    renderer = Renderer(desc, tile_size=opt.tile_size, mesh=mesh)

    # host 0 owns every display, exactly like lucille's rank-0-only
    # drv->open/write/close (render.c:468-514, 1219-1243)
    drivers = []
    if is_primary_host():
        for d in opt.displays or [None]:
            if d is None:
                drv = get_display_driver("framebuffer")
                drv.open("untitled.hdr", opt.width, opt.height)
            else:
                drv = get_display_driver(d.driver)
                drv.open(d.name, opt.width, opt.height)
            drivers.append(drv)

    last = [0.0]
    t_start = [None]

    def tile_cb(x0, y0, tile):
        for drv in drivers:
            drv.write(x0, y0, tile)

    def progress_cb(frac):
        """Progress bar + ETA (reference progress_bar, render.c:985-1041)."""
        for drv in drivers:
            drv.progress(frac)
        if t_start[0] is None:
            t_start[0] = time.time()
        if args.verbose and (time.time() - last[0] > 0.5 or frac >= 1.0):
            last[0] = time.time()
            elapsed = time.time() - t_start[0]
            eta = elapsed / max(frac, 1e-6) * (1.0 - frac)
            nbar = int(frac * 32)
            bar = "=" * nbar + " " * (32 - nbar)
            print(
                f"\r|{bar}| {frac * 100:3.0f}%   "
                f"ETA {int(eta // 60):2d}:{int(eta % 60):02d}  "
                f"Elap {int(elapsed // 60):2d}:{int(elapsed % 60):02d}",
                end="",
                flush=True,
            )

    ckpt = None
    if args.recover:
        # multi-process safe: the renderer broadcasts host-0's recovered
        # image + done-bitmap to every process at frame start
        # (parallel/distributed.py broadcast_from_primary), so sharded
        # tile rounds skip identical tiles; only host 0 reads/writes the
        # checkpoint file itself
        base = (opt.current_display().name or "untitled.hdr") if opt.displays else "untitled.hdr"
        ckpt = base + ".ckpt.npz"

    image = renderer.render_frame(
        tile_cb=tile_cb,
        progress_cb=progress_cb,
        checkpoint=ckpt,
        recover=args.recover,
    )
    if opt.imager:
        # the imager post-pass ran over the assembled frame; re-write it
        # so the file/socket drivers flush the post-processed pixels
        tile_cb(0, 0, image)
    del image
    if args.verbose:
        print()

    for drv in drivers:
        drv.close()
    barrier("frame-end")  # render.c:368's post-frame MPI barrier

    if (args.stats or args.verbose) and is_primary_host():
        print(renderer.stats.report())
        print(timer.dump())
    return 0


if __name__ == "__main__":
    sys.exit(main())
