"""Multi-host process bring-up over jax.distributed.

The counterpart of the reference's typed MPI facade
(src/base/parallel.c:62-233):

    ri_parallel_init      (parallel.c:62)  -> initialize_distributed()
    ri_parallel_ntasks    (parallel.c:95)  -> process_count()
    ri_parallel_taskid    (parallel.c:106) -> process_index()
    ri_parallel_barrier   (parallel.c:128) -> barrier()
    ri_parallel_gather    (parallel.c:117) -> all_gather_host()
    rank-0 display I/O    (render.c:468-514,1219-1243) -> is_primary_host()

Like the reference built without WITH_MPI (parallel.c:73-78, single-task
no-op fallback), single-process runs skip bring-up entirely and every
query degrades gracefully to the one-task answer — so the whole test
suite runs multi-host-shaped code on one machine (SURVEY.md section 4).

One process per card: a JAX process reserves most of a card's memory
when it first touches it, so processes sharing a host must each claim a
different card.  initialize_distributed gives process p the local card
``p % local_device_count`` unless the caller names the cards.
"""

from __future__ import annotations

_initialized = False


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Bring up the multi-host runtime; returns True when distributed mode
    is active.  Must run before any JAX backend query (the analog of the
    reference calling ri_parallel_init before everything, main.c:119).

    A single-process invocation (no coordinator, num_processes absent or
    1) is a no-op returning False — the WITH_MPI=undef build.

    local_device_ids: the cards this process may use.  Default: one card,
    chosen from process_id, when the host has more than one visible GPU
    (CUDA_VISIBLE_DEVICES or the driver's count), so co-located
    processes never all claim every card.
    """
    global _initialized
    if coordinator is None and (num_processes is None or int(num_processes) <= 1):
        return False
    import jax

    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is None and process_id is not None:
        n_local = _local_gpu_count()
        if n_local > 1:
            local_device_ids = [int(process_id) % n_local]
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return True


def _local_gpu_count() -> int:
    """Visible GPUs on this host, read without starting a JAX backend
    (jax.distributed.initialize must come first)."""
    import os

    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([v for v in vis.split(",") if v.strip()])
    if not os.path.isdir("/dev"):
        return 0
    # the driver's per-card device nodes: /dev/nvidia0, /dev/nvidia1, ...
    return sum(
        1 for d in os.listdir("/dev")
        if d.startswith("nvidia") and d[6:].isdigit()
    )


def finalize_distributed() -> None:
    """ri_parallel_finalize (parallel.c:85) analog."""
    global _initialized
    if _initialized:
        import jax

        jax.distributed.shutdown()
        _initialized = False


def process_count() -> int:
    import jax

    return jax.process_count()


def process_index() -> int:
    import jax

    return jax.process_index()


def is_primary_host() -> bool:
    """True on the process that owns display/file output — the analog of
    lucille's rank-0-only drv->open/write/close (render.c:468-514)."""
    return process_index() == 0


def barrier(name: str = "frame") -> None:
    """Cross-host sync point (frame barriers, render.c:342,368)."""
    if process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def broadcast_from_primary(tree):
    """Broadcast host-0's pytree of numpy arrays to every process — the
    MPI_Bcast analog (parallel.c:150).  Used to ship the checkpoint
    done-bitmap + accumulated image at frame start so every process skips
    the SAME tiles under ``--recover`` (the checkpoint file may exist
    only on host 0's filesystem).  Single-process: identity."""
    if process_count() == 1:
        return tree
    import jax
    import numpy as np
    from jax.experimental import multihost_utils

    out = multihost_utils.broadcast_one_to_all(tree)
    return jax.tree_util.tree_map(np.asarray, out)


def all_gather_host(x):
    """Materialize a (possibly globally-sharded) device array on THIS host
    as numpy — the MPI_Gather-to-rank-0 analog (parallel.c:117), except
    every host gets the result (cheap; frames are small next to ray work).
    Single-process: a plain device->host transfer."""
    import numpy as np

    if process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
