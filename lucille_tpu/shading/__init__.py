"""Shading: BRDFs, reflection utilities, and the JAX shader system.

JAX replacement for lucille's shading stack (src/render/brdf.c,
reflection.c, shader.c + the sl2c/LLVM RSL toolchain — SURVEY.md sections
2.4/2.6).  Shaders are JAX-traced Python functions over a pytree of shader
globals — jit IS the shader JIT the reference's LLVM engine aspired to
(src/shader/README.txt: "shader runs as fast as native code"), and every
BRDF is differentiable by construction.
"""

from lucille_tpu.shading import brdf, reflection
from lucille_tpu.shading.shader import (
    ShaderGlobals,
    get_shader,
    register_shader,
)

__all__ = ["brdf", "reflection", "ShaderGlobals", "register_shader", "get_shader"]
