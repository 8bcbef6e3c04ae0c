"""Device-mesh tile sharding.

Design (SURVEY.md sections 2.8 and 7):

- the frame's tiles form the data-parallel axis — the moral successor of
  lucille's bucket queue, but STATIC: round r assigns tile r*D+d to
  device d, no queue, no locks (render.c:582-710 bucket machinery);
- the scene is replicated to every device (read-only render state, like
  lucille's per-process scene after each MPI rank parses the RIB);
- each device renders its tile with the SAME compiled tile kernel the
  single-chip Renderer builds (any integrator, pixel-filter weights,
  textures, shader tables) — `sharded_tile_batch` simply shard_maps that
  kernel, so the single- and multi-device images cannot drift;
- per-round ray/test counters ride back per-tile (sharded) plus a psum'd
  round total — the analog of the MPI gather at frame end
  (render.c:1219-1243);
- the host assembles the image from the sharded output; under
  `jax.distributed` (parallel/distributed.py) the mesh spans hosts and
  host 0 owns the displays.  The mesh is one flat axis: the cards of a
  host reach each other all to all, so no torus layout is wanted.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def make_mesh(
    n_devices: int | None = None, axis: str = "tiles", devices=None
) -> Mesh:
    """Mesh over the first n devices of the default backend (or of
    `devices`).  Too few devices is an error: a mesh never swaps in
    another backend's devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)} "
                "(set XLA_FLAGS=--xla_force_host_platform_device_count)"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def sharded_tile_batch(mesh: Mesh, tile_kernel):
    """shard_map the production tile kernel over the mesh: one tile per
    device per call.

    tile_kernel is exactly what render.renderer.build_tile_kernel returns:
        (scene, x0, y0, jitter, weights, key) -> (img (th, tw, 3), aux)

    Returned fn signature (D = mesh size):
        fn(scene, origins (D, 2) i32, keys (D,) PRNG, jitter, weights)
            -> (imgs (D, th, tw, 3),
                aux {nrays (D,), ntests (D,), ntrav (D,)})
    """
    axis = mesh.axis_names[0]

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(), P()),
        out_specs=(
            P(axis),
            {"counters": P(axis), "alpha": P(axis)},
        ),
        # integrator while_loops mix replicated literals with varying ray
        # state; skip the vma type check (tiles are independent, counters
        # psum at the end)
        check_vma=False,
    )
    def work(scene, origins, keys, jitter, weights):
        img, aux = tile_kernel(
            scene, origins[0, 0], origins[0, 1], jitter, weights, keys[0]
        )
        out_aux = {
            "counters": aux["counters"][None],
            # mesh tiles always carry alpha: the whole round is ONE
            # all_gather anyway, so there is no extra transfer to save
            "alpha": aux.get(
                "alpha", jnp.asarray(aux["hit"], jnp.float32)
            )[None],
        }
        return img[None], out_aux

    return jax.jit(work)


def render_frame_sharded(
    desc, mesh: Mesh | None = None, key=None, tile: int = 64
):
    """Render a full frame with tiles sharded over the mesh, through the
    production Renderer (same kernel, displays, checkpoint, stats as the
    single-chip path).  Returns (image (H, W, 3) float32, nrays)."""
    from lucille_tpu.render.renderer import Renderer

    if mesh is None:
        mesh = make_mesh()
    r = Renderer(desc, tile_size=tile, mesh=mesh)
    image = r.render_frame(key=key)
    return image, r.stats.nrays
