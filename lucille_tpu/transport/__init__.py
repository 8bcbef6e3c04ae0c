"""Transport integrators: ambient occlusion, Whitted, path tracing.

JAX replacement for lucille's src/transport layer (SURVEY.md
section 2.5).  Each integrator is a pure function over a wavefront of eye
rays: recursion (whitted.c:32, transport.c:130) becomes bounded bounce
loops with explicit throughput, and the per-pixel call tree becomes fused
batched array ops under jit.
"""

from lucille_tpu.transport.ao import ao_radiance

__all__ = ["ao_radiance"]
