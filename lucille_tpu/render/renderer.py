"""Frame renderer: tile orchestration over a jit-compiled render kernel.

The device-side equivalent of ri_render_frame (src/render/render.c:317-369)
and its bucket machinery (render.c:582-710, 1043-1207):

- the image is cut into fixed-size tiles (static shapes -> ONE compiled
  kernel reused for every tile; `frame_mode` renders the whole padded
  frame in a single device call);
- per tile, the kernel generates the deterministic sigma-Hammersley
  subpixel rays (render.c:830-917), runs the selected integrator
  wavefront (AO by default, matching the reference's hardwired call at
  render.c:803 — but Whitted/pathtrace/dirtmap are selectable via
  Option "renderer" "method"), and reconstructs pixels with the RIB
  PixelFilter as constant per-subsample weights (filter.c:36);
- tiles run in spiral order by default for progressive display
  (render.c:198), streaming each finished tile to the display drivers —
  the mutex-guarded bucket_write of the reference becomes a plain host
  callback since device work is already serialized per tile;
- statistics (rays, triangle tests, Mrays/sec — raytrace.c:71-112) and
  phase timers (render.c:1243) are accumulated host-side.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from lucille_tpu.base.log import LOG_INFO, LOG_WARN, log
from lucille_tpu.base.stats import RenderStats
from lucille_tpu.base.timer import get_timer
from lucille_tpu.render.film import subsample_filter_table
from lucille_tpu.render.tiles import tile_list
from lucille_tpu.sampling.hammersley import subpixel_samples
from lucille_tpu.scene.compile import compile_scene


def build_tile_kernel(
    camera,
    lights,
    method: str,
    tile_w: int,
    tile_h: int,
    xsamples: int,
    ysamples: int,
    gather_nsamples: int,
    max_depth: int,
    bgcolor=(0.0, 0.0, 0.0),
    textures=None,
    shader_table=None,
    atmosphere=None,
    searchpaths=None,
    want_alpha=False,
):
    """Compile-once tile kernel: (scene, x0, y0, jitter, weights, key) ->
    ((tile_h, tile_w, 3) radiance, aux).  Per-frame constants (camera,
    lights, integrator, atmosphere shader) are baked into the closure."""
    import jax
    import jax.numpy as jnp

    from lucille_tpu.transport.dispatch import get_integrator

    integrator = get_integrator(method)
    extra_kwargs = {}
    if method in ("shader", "sl", "shade"):
        extra_kwargs["shader_table"] = shader_table
    S = xsamples * ysamples

    @jax.jit
    def kernel(scene, x0, y0, jitter, weights, key):
        xs = jnp.arange(tile_w, dtype=jnp.float32)
        ys = jnp.arange(tile_h, dtype=jnp.float32)
        px = x0.astype(jnp.float32) + xs[None, :, None]  # (1, w, 1)
        py = y0.astype(jnp.float32) + ys[:, None, None]  # (h, 1, 1)
        jx = jitter[:, 0][None, None, :]
        jy = jitter[:, 1][None, None, :]
        shape = (tile_h, tile_w, S)
        fx = jnp.broadcast_to(px + jx, shape).reshape(-1)
        fy = jnp.broadcast_to(py + jy, shape).reshape(-1)

        lens_u = None
        if camera.dof_active:
            # per-ray thin-lens samples; a distinct fold keeps the lens
            # stream independent of the integrator's gather streams
            lens_u = jax.random.uniform(
                jax.random.fold_in(key, 0x10EF),
                fx.shape + (2,),
                dtype=jnp.float32,
            )
        org, dirn = camera.generate_rays(fx, fy, lens_u)
        radiance, aux = integrator(
            scene,
            lights,
            org,
            dirn,
            key,
            gather_nsamples=gather_nsamples,
            max_depth=max_depth,
            bgcolor=bgcolor,
            textures=textures,
            **extra_kwargs,
        )
        # atmosphere/volume shader: fog Ci by eye-ray length at shading
        # (shading/pipeline.py; the reference's volume-shader ABI slot)
        if atmosphere is not None and aux.get("t") is not None:
            from lucille_tpu.shading.pipeline import apply_atmosphere

            t_eye = aux["t"]
            hitw = aux["hit"]
            ray_len = jnp.where(hitw, t_eye, 0.0) * jnp.linalg.norm(
                dirn, axis=-1
            )
            P_hit = org + jnp.where(hitw, t_eye, 0.0)[:, None] * dirn
            radiance = apply_atmosphere(
                radiance, ray_len, P_hit, hitw, atmosphere[0], atmosphere[1],
                searchpaths, dirn=dirn,
            )

        # pixel-filter reconstruction over subsamples (render.c:715-823
        # box-averages; RIB PixelFilter generalizes via constant weights)
        r = radiance.reshape(tile_h, tile_w, S, 3)
        img = jnp.sum(r * weights[None, None, :, None], axis=2)
        nrays = jnp.asarray(aux.get("nrays", fx.shape[0]), jnp.int32)
        hitmask = aux["hit"].reshape(tile_h, tile_w, S)
        if "ntests" not in aux:
            aux = dict(aux, ntests=0, ntrav=0)
        # statistics counters ride as ONE f32 vector, one host transfer
        # per tile (f32 because per-tile triangle-test counts overflow
        # int32 on big scenes)
        out_aux = {
            "counters": jnp.stack(
                [
                    jnp.asarray(aux.get("ntests", 0), jnp.float32),
                    jnp.asarray(aux.get("ntrav", 0), jnp.float32),
                    jnp.asarray(nrays, jnp.float32),
                ]
            ),
            "hit": hitmask.any(axis=2),
        }
        if want_alpha:
            # fractional subsample coverage — the imager stage's alpha
            # (computed only when an imager is bound: it costs one more
            # device->host transfer per tile)
            out_aux["alpha"] = hitmask.astype(jnp.float32).mean(axis=2)
        return img, out_aux

    return kernel


class _Round:
    """One sharded tile round in flight: D tiles, one per mesh device.
    Materializes to host numpy lazily, once, on first access (so the
    async-dispatch overlap of the single-device path is preserved)."""

    def __init__(self, result):
        self._result = result
        self._np = None

    def get(self, slot: int):
        if self._np is None:
            from lucille_tpu.parallel.distributed import all_gather_host

            imgs, aux = self._result
            self._np = (
                all_gather_host(imgs),
                {k: all_gather_host(v) for k, v in aux.items()},
            )
            self._result = None
        imgs, aux = self._np
        out = {"counters": aux["counters"][slot]}
        if "alpha" in aux:
            out["alpha"] = aux["alpha"][slot]
        return imgs[slot], out


@dataclass
class Renderer:
    """Holds the compiled scene + camera and renders frames.

    mesh: optional jax.sharding.Mesh — tiles are then dispatched in rounds
    of mesh-size through a shard_map of the SAME tile kernel (any
    integrator, filters, textures), the successor of lucille's MPI bucket
    distribution (render.c:559-573, scaffolded there, working here)."""

    desc: "SceneDescription"
    tile_size: int = 64
    frame_mode: bool = False  # render the whole frame in one device call
    mesh: object = None  # jax.sharding.Mesh | None
    stats: RenderStats = field(default_factory=RenderStats)

    def __post_init__(self):
        timer = get_timer()
        timer.start("Scene compile")
        from lucille_tpu.shading.pipeline import displace_scene

        displace_scene(self.desc)  # run bound displacement shaders
        self.textures, texture_ids = _load_textures(self.desc)
        self.scene = compile_scene(
            self.desc, texture_ids=texture_ids
        ).device_put()
        timer.end("Scene compile")
        self.camera = self.desc.camera
        self._frozen_camera = _FrozenCamera.from_camera(self.camera)
        from lucille_tpu.lights.tables import build_light_tables

        self.lights = build_light_tables(self.desc)
        self._kernel = None
        self._kernel_shape = None
        self._batch = None  # shard_map'ed kernel (mesh mode)
        self._batch_kernel = None  # the tile kernel _batch wraps

    def _get_kernel(self, tile_w, tile_h, xsamples, ysamples):
        opt = self.desc.options
        atm = next(
            (g.attrs.atmosphere for g in self.desc.geoms
             if getattr(g.attrs, "atmosphere", None)), None,
        )
        shape = (tile_w, tile_h, xsamples, ysamples, opt.render_method,
                 opt.gather_nsamples, opt.max_ray_depth, atm)
        if self._kernel_shape != shape:
            shader_table = None
            if opt.render_method in ("shader", "sl", "shade"):
                from lucille_tpu.transport.shaded import build_shader_table

                shader_table = build_shader_table(self.desc)
            # frame-level atmosphere: the first bound volume shader (the
            # MOSAIC/Blender export binds one global fog)
            atmosphere = None
            for g in self.desc.geoms:
                if getattr(g.attrs, "atmosphere", None):
                    atmosphere = (g.attrs.atmosphere,
                                  dict(g.attrs.atmosphere_params))
                    break
            self._kernel = build_tile_kernel(
                self._frozen_camera,
                self.lights,
                opt.render_method,
                tile_w,
                tile_h,
                xsamples,
                ysamples,
                opt.gather_nsamples,
                opt.max_ray_depth,
                opt.bgcolor,
                textures=self.textures,
                shader_table=shader_table,
                atmosphere=atmosphere,
                searchpaths=tuple(opt.searchpaths),
                want_alpha=bool(opt.imager),
            )
            self._kernel_shape = shape
        return self._kernel

    def _get_batch(self, kernel):
        """shard_map'ed wrapper of the tile kernel, rebuilt only when the
        kernel itself changes (mesh mode)."""
        if self._batch is None or self._batch_kernel is not kernel:
            from lucille_tpu.parallel.mesh import sharded_tile_batch

            self._batch = sharded_tile_batch(self.mesh, kernel)
            self._batch_kernel = kernel
        return self._batch

    def render_frame(
        self,
        tile_cb: Optional[Callable] = None,
        progress_cb: Optional[Callable] = None,
        key=None,
        checkpoint: Optional[str] = None,
        recover: bool = False,
    ) -> np.ndarray:
        """Render the full frame; returns (H, W, 3) float32 in raster order
        (row 0 = raster y 0; the hdr file driver flips, drivers.py).

        checkpoint: path of a tile-level checkpoint file.  When set, the
        accumulated image + tile-done bitmap are written (atomically)
        after each finished tile, and removed on completion.  With
        recover=True, a matching existing checkpoint resumes the frame,
        skipping finished tiles — the working version of the reference's
        accepted-but-ignored PRMan ``-recover`` flag (main.c:291-293);
        the reference loses the whole frame on a crash (SURVEY.md §5).
        """
        import jax
        import jax.numpy as jnp

        opt = self.desc.options
        W, H = opt.width, opt.height
        disp = opt.current_display()
        xsamples = int(disp.sampling_rates[0])
        ysamples = int(disp.sampling_rates[1])

        jitter_np, _inst = subpixel_samples(xsamples, ysamples)
        jitter = jnp.asarray(jitter_np, dtype=jnp.float32)
        weights = jnp.asarray(
            subsample_filter_table(
                opt.pixel_filter, jitter_np, *opt.pixel_filter_width
            )
        )
        if key is None:
            key = jax.random.key(0)

        # RiCropWindow: fractional window -> raster rect (RiSpec rounding:
        # [ceil(W*xmin), ceil(W*xmax)-1]).  Tiles stay anchored on the
        # full-frame grid and RNG keys fold on tile ORIGIN, so the pixels
        # inside the crop are bit-identical to the same pixels of a full
        # render; pixels outside stay black in the full-size output (the
        # reference stores crop_window, camera.c:401-409, and never clips).
        cxmin, cxmax, cymin, cymax = self.camera.crop_window
        crop_px0 = max(0, int(np.ceil(W * cxmin)))
        crop_px1 = min(W, max(crop_px0 + 1, int(np.ceil(W * cxmax))))
        crop_py0 = max(0, int(np.ceil(H * cymin)))
        crop_py1 = min(H, max(crop_py0 + 1, int(np.ceil(H * cymax))))
        cropped = (crop_px0, crop_py0, crop_px1, crop_py1) != (0, 0, W, H)

        if self.frame_mode:
            if self.mesh is not None:
                log(
                    LOG_WARN,
                    "frame_mode renders on a single device; ignoring the "
                    "%d-device mesh (use tile mode for sharded rendering)",
                    int(self.mesh.devices.size),
                )
            tiles = [(0, 0, 0, 0)]
            tile_w = -(-W // 8) * 8
            tile_h = -(-H // 8) * 8
        else:
            tiles = tile_list(W, H, self.tile_size, opt.bucket_order)
            tile_w = tile_h = self.tile_size
            if cropped:
                tiles = [
                    (x0, y0, i, j)
                    for (x0, y0, i, j) in tiles
                    if x0 < crop_px1
                    and x0 + tile_w > crop_px0
                    and y0 < crop_py1
                    and y0 + tile_h > crop_py0
                ]

        kernel = self._get_kernel(tile_w, tile_h, xsamples, ysamples)
        image = np.zeros((H, W, 3), dtype=np.float32)
        alpha = np.zeros((H, W), dtype=np.float32)  # imager coverage

        # ---- tile-level checkpoint/resume -------------------------------
        ckpt_meta = np.asarray(
            [W, H, tile_w, tile_h, xsamples, ysamples, len(tiles)],
            dtype=np.int64,
        )
        done = np.zeros(len(tiles), dtype=bool)
        from lucille_tpu.parallel.distributed import (
            broadcast_from_primary,
            is_primary_host,
            process_count,
        )

        if checkpoint and recover:
            if is_primary_host() and os.path.exists(checkpoint):
                try:
                    data = np.load(checkpoint)
                    if np.array_equal(data["meta"], ckpt_meta):
                        image = np.asarray(data["image"], dtype=np.float32)
                        done = np.asarray(data["done"], dtype=bool)
                        if "alpha" in data:
                            alpha = np.asarray(data["alpha"], np.float32)
                        log(
                            LOG_INFO,
                            "recovered %d/%d finished tiles from %s",
                            int(done.sum()),
                            len(tiles),
                            checkpoint,
                        )
                    else:
                        log(
                            LOG_WARN,
                            "checkpoint %s does not match this frame; "
                            "ignoring",
                            checkpoint,
                        )
                except Exception as e:  # corrupt file: start fresh
                    log(LOG_WARN, "cannot read checkpoint %s: %s",
                        checkpoint, e)
            if process_count() > 1:
                # ship host-0's recovery state to every process so the
                # sharded tile rounds skip IDENTICAL tiles (the ckpt file
                # may exist only on host 0) — MPI_Bcast analog
                image, alpha, done = broadcast_from_primary(
                    (image, alpha, done.astype(np.uint8))
                )
                done = done.astype(bool)

        def _save_ckpt():
            if not is_primary_host():
                return  # host 0 owns the checkpoint like it owns displays
            tmp = checkpoint + ".tmp.npz"
            with open(tmp, "wb") as f:
                np.savez(f, image=image, done=done, meta=ckpt_meta,
                         alpha=alpha)
            os.replace(tmp, checkpoint)  # atomic against mid-write crashes

        timer = get_timer()
        timer.start("Render frame")
        ntests_total = 0
        ntrav_total = 0
        # dispatch phase: JAX execution is async — enqueue every tile
        # kernel before the first blocking host transfer, so device
        # compute overlaps host-side collection
        if self.mesh is not None and not self.frame_mode:
            # mesh mode: rounds of one tile per device through a shard_map
            # of the SAME kernel (the working version of the reference's
            # scaffolded MPI bucket distribution, render.c:559-573)
            batch = self._get_batch(kernel)
            D = int(self.mesh.devices.size)
            todo = [ti for ti in range(len(tiles)) if not done[ti]]
            pending = [None] * len(tiles)
            fold_origin = jax.vmap(
                lambda xy: jax.random.fold_in(
                    jax.random.fold_in(key, xy[0]), xy[1]
                )
            )
            for s in range(0, len(todo), D):
                group = todo[s : s + D]
                # short final round: repeat the last tile into the unused
                # slots (rendered, discarded — the static-shape analog of
                # empty buckets)
                padded = group + [group[-1]] * (D - len(group))
                origins = jnp.asarray(
                    [[tiles[ti][0], tiles[ti][1]] for ti in padded],
                    dtype=jnp.int32,
                )
                rnd = _Round(
                    batch(self.scene, origins, fold_origin(origins), jitter, weights)
                )
                for slot, ti in enumerate(group):
                    pending[ti] = (rnd, slot)
        elif (
            os.environ.get("LUCILLE_FRAME_ACCUM") == "1"
            and tile_cb is None
            and progress_cb is None
            and checkpoint is None
            and not cropped
            and len(tiles) > 1
        ):
            # ---- device-side frame accumulation -------------------------
            # Assemble the frame in a DEVICE buffer and pull it ONCE, for
            # single-transfer workflows (LUCILLE_FRAME_ACCUM=1); the
            # default per-tile pulls with copy_to_host_async (below)
            # overlap transfers with compute and with each other.
            dev_img = jnp.zeros((H, W, 3), jnp.float32)
            dev_alpha = jnp.zeros((H, W), jnp.float32)
            # one row PER TILE (not a running f32 sum): frame totals past
            # 2^24 would silently lose integer precision in a float32
            # accumulator; rows are summed on host in f64
            dev_counters = jnp.zeros((len(tiles), 3), jnp.float32)
            have_alpha = False
            for ti, (x0, y0, _i, _j) in enumerate(tiles):
                tkey = jax.random.fold_in(jax.random.fold_in(key, x0), y0)
                img, aux = kernel(
                    self.scene, jnp.int32(x0), jnp.int32(y0), jitter,
                    weights, tkey,
                )
                th = min(tile_h, H - y0)
                tw = min(tile_w, W - x0)
                dev_img = jax.lax.dynamic_update_slice(
                    dev_img, img[:th, :tw], (y0, x0, 0)
                )
                if "alpha" in aux:
                    have_alpha = True
                    dev_alpha = jax.lax.dynamic_update_slice(
                        dev_alpha, aux["alpha"][:th, :tw], (y0, x0)
                    )
                dev_counters = dev_counters.at[ti].set(aux["counters"])
                done[ti] = True
            # ONE bulk pull for the image + one for the counter vector
            image = np.asarray(dev_img, dtype=np.float32)
            if have_alpha:
                alpha = np.asarray(dev_alpha, dtype=np.float32)
            counters = np.asarray(dev_counters).astype(np.float64).sum(axis=0)
            self.stats.add(nrays=int(counters[2]))
            ntests_total += int(counters[0])
            ntrav_total += int(counters[1])
            pending = None
        else:
            pending = []
            for ti, (x0, y0, _i, _j) in enumerate(tiles):
                if done[ti]:
                    pending.append(None)
                    continue
                # key folds on the tile ORIGIN (not list index) so a
                # cropped render's sample streams match the full render's
                tkey = jax.random.fold_in(jax.random.fold_in(key, x0), y0)
                pending.append(
                    kernel(
                        self.scene, jnp.int32(x0), jnp.int32(y0), jitter, weights, tkey
                    )
                )
            # start every device->host copy NOW: each tile's transfer
            # begins the moment its kernel finishes instead of when its
            # blocking np.asarray turn comes up in the collection loop —
            # the transfer-plan half of the reference's bucket-thread
            # overlap (render.c:1043-1166)
            for p in pending:
                if p is None:
                    continue
                for arr in (p[0], *p[1].values()):
                    if hasattr(arr, "copy_to_host_async"):
                        arr.copy_to_host_async()
        for ti, (x0, y0, _i, _j) in enumerate(tiles if pending is not None
                                              else ()):
            th = min(tile_h, H - y0)
            tw = min(tile_w, W - x0)
            if pending[ti] is None:  # recovered tile: replay to displays
                if tile_cb:
                    tile_cb(x0, y0, image[y0 : y0 + th, x0 : x0 + tw])
                if progress_cb:
                    progress_cb((ti + 1) / len(tiles))
                continue
            if isinstance(pending[ti][0], _Round):
                img, aux = pending[ti][0].get(pending[ti][1])
            else:
                img, aux = pending[ti]
            tile_np = np.asarray(img)
            tile_alpha = np.asarray(aux["alpha"]) if "alpha" in aux else None
            if cropped:
                # clip the tile write to the crop rect
                wy0, wy1 = max(y0, crop_py0), min(y0 + th, crop_py1)
                wx0, wx1 = max(x0, crop_px0), min(x0 + tw, crop_px1)
                image[wy0:wy1, wx0:wx1] = tile_np[
                    wy0 - y0 : wy1 - y0, wx0 - x0 : wx1 - x0
                ]
                if tile_alpha is not None:
                    alpha[wy0:wy1, wx0:wx1] = tile_alpha[
                        wy0 - y0 : wy1 - y0, wx0 - x0 : wx1 - x0
                    ]
            else:
                image[y0 : y0 + th, x0 : x0 + tw] = tile_np[:th, :tw]
                if tile_alpha is not None:
                    alpha[y0 : y0 + th, x0 : x0 + tw] = tile_alpha[:th, :tw]
            counters = np.asarray(aux["counters"])  # ONE host transfer
            self.stats.add(nrays=int(counters[2]))
            ntests_total += int(counters[0])
            ntrav_total += int(counters[1])
            done[ti] = True
            if checkpoint:
                _save_ckpt()
            if tile_cb:
                tile_cb(x0, y0, tile_np[:th, :tw])
            if progress_cb:
                progress_cb((ti + 1) / len(tiles))
        if checkpoint and os.path.exists(checkpoint):
            os.remove(checkpoint)  # frame completed; nothing to resume
        if opt.imager:
            # imager shader: film post-pass over the assembled frame
            # (shading/pipeline.py; RiImager)
            from lucille_tpu.shading.pipeline import apply_imager

            timer.start("Imager")
            image = np.asarray(
                apply_imager(image, alpha, opt.imager, opt.imager_params,
                             opt.searchpaths),
                dtype=np.float32,
            )
            timer.end("Imager")
        self.stats.render_seconds += timer.end("Render frame")
        self.stats.add(ntriangle_tests=ntests_total, ntraversals=ntrav_total)
        log(
            LOG_INFO,
            "frame done: %d tiles, %.2f Mrays/s",
            len(tiles),
            self.stats.mrays_per_sec,
        )
        return image


def _load_textures(desc):
    """Load every material texture via the option searchpaths and build
    the device atlas.  Returns (TextureAtlas, {name: id})."""
    from lucille_tpu.texture.texture import TextureAtlas

    names = {
        g.attrs.material.texture
        for g in desc.geoms
        if g.attrs.material.texture
    }
    if not names:
        return TextureAtlas(), {}
    from pathlib import Path

    from lucille_tpu.base.log import LOG_WARN, log
    from lucille_tpu.imageio.loader import load_image

    images = {}
    for name in sorted(names):
        found = None
        for sp in desc.options.searchpaths or ["."]:
            cand = Path(sp) / name
            if cand.exists():
                found = cand
                break
        if found is None and Path(name).exists():
            found = Path(name)
        if found is None:
            log(LOG_WARN, "texture '%s' not found on searchpath; ignoring", name)
            continue
        try:
            images[name] = load_image(found)
        except (ValueError, OSError) as e:
            log(LOG_WARN, "cannot load texture '%s': %s", name, e)
    atlas = TextureAtlas.build(images)
    return atlas, dict(atlas.names)


class _FrozenCamera:
    """Hashable camera snapshot usable inside jitted closures."""

    def __init__(self, fields: tuple):
        self._fields = fields
        (
            self.horizontal_resolution,
            self.vertical_resolution,
            self.camera_projection,
            self.is_rh,
            self.flength,
            self.fstop,
            self.focal_length,
            self.focal_distance,
            c2w_bytes,
            shape,
        ) = fields
        self.camera_to_world = np.frombuffer(c2w_bytes).reshape(shape)

    @staticmethod
    def from_camera(cam) -> "_FrozenCamera":
        c2w = np.ascontiguousarray(cam.camera_to_world, dtype=np.float64)
        return _FrozenCamera(
            (
                cam.horizontal_resolution,
                cam.vertical_resolution,
                cam.camera_projection,
                cam.is_rh,
                cam.flength,
                cam.fstop,
                cam.focal_length,
                cam.focal_distance,
                c2w.tobytes(),
                c2w.shape,
            )
        )

    # borrow the real camera's ray-gen methods
    ray_constants = __import__(
        "lucille_tpu.ri.camera", fromlist=["Camera"]
    ).Camera.ray_constants
    generate_rays = __import__(
        "lucille_tpu.ri.camera", fromlist=["Camera"]
    ).Camera.generate_rays
    dof_active = __import__(
        "lucille_tpu.ri.camera", fromlist=["Camera"]
    ).Camera.dof_active

    def __hash__(self):
        return hash(self._fields)

    def __eq__(self, other):
        return isinstance(other, _FrozenCamera) and self._fields == other._fields


def render_frame(desc, **kwargs) -> np.ndarray:
    """One-shot convenience: SceneDescription -> (H, W, 3) image."""
    return Renderer(desc, tile_size=desc.options.tile_size).render_frame(**kwargs)
