"""lucille_tpu — a global-illumination renderer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
syoyo/lucille RenderMan-compatible renderer (reference: C sources under
/root/reference; see SURVEY.md at the repo root for the full map).

Architecture (a redesign, not a port):

- Host side (Python/NumPy): RIB scene ingest (lexer/parser/state machine),
  scene compilation to padded SoA device arrays, binned-SAH BVH build
  flattened to skip-link arrays, image IO (Radiance RGBE), CLI.
- Device side (JAX/XLA/Pallas): wavefront ray generation, BVH traversal
  and Moller-Trumbore intersection over ray batches, integrators
  (ambient occlusion, Whitted, path tracing) expressed as fused,
  statically-shaped tile kernels under jit.
- Scale-out: tiles sharded over a `jax.sharding.Mesh` with `shard_map`;
  statistics reduced with `psum`; host 0 writes the image (the device-side
  equivalent of lucille's MPI rank-0 display ownership,
  reference src/base/parallel.c:62-233).
"""

from lucille_tpu.version import __version__

__all__ = ["__version__"]
