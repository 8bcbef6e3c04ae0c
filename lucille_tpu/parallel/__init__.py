"""Scale-out: device meshes and sharded tile rendering.

JAX replacement for lucille's parallel substrate (SURVEY.md
section 2.8): the pthread bucket queue (render.c:1043-1207) and the MPI
byte-collective layer (src/base/parallel.c:62-233) both collapse into ONE
mechanism here — static tile sharding over a `jax.sharding.Mesh` with
`shard_map`, XLA collectives for reductions, and host-0 image assembly
(the analog of rank-0 display ownership, render.c:468-514).
"""

from lucille_tpu.parallel.distributed import (
    all_gather_host,
    barrier,
    initialize_distributed,
    is_primary_host,
    process_count,
    process_index,
)
from lucille_tpu.parallel.mesh import (
    make_mesh,
    render_frame_sharded,
    sharded_tile_batch,
)

__all__ = [
    "make_mesh",
    "sharded_tile_batch",
    "render_frame_sharded",
    "initialize_distributed",
    "is_primary_host",
    "process_count",
    "process_index",
    "barrier",
    "all_gather_host",
]
