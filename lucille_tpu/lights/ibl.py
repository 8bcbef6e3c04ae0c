"""Image-based lighting samplers.

Capability map to src/render/ibl.c (selected per light by the RIB token
"sampling", lightsource.c:127-142, enum light.h:19-23):

- ``cosweight``  (ibl.c:53)  -> cosine-weighted hemisphere + env lookup
- ``importance`` (ibl.c:~)   -> luminance-CDF texel sampling (host-built
  marginal/conditional tables, device gathers)
- ``stratified``             -> stratified hemisphere + env lookup
- ``structured``             -> precomputed SIS directions from sisgen
  (tools_tpu/sisgen.py; reference tools/sis + light->sisfile)
- ``bruteforce`` (ibl.c:395) -> integrate every env texel (reference
  ground-truth path; here a dense masked sum — regular elementwise work)

All samplers return (B, 3) incident radiance estimates for shading
points P with normals N, shadowed by any_hit wavefronts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lucille_tpu.accel.dispatch import any_hit
from lucille_tpu.shading.reflection import cosweight_sample
from lucille_tpu.transport.ao import ortho_basis


def latlong_directions(h: int, w: int):
    """Direction + solid angle per texel of an (h, w) lat-long map (y-up)."""
    theta = (np.arange(h) + 0.5) / h * np.pi  # 0..pi from +y
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi - np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack(
        [np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], axis=-1
    )
    solid = (np.pi / h) * (2.0 * np.pi / w) * np.sin(t)
    return dirs, solid


class EnvImportanceTable:
    """Host-precomputed luminance CDF over a lat-long environment map."""

    def __init__(self, image: np.ndarray):
        self.image = np.asarray(image, dtype=np.float32)
        h, w = self.image.shape[:2]
        self.h, self.w = h, w
        dirs, solid = latlong_directions(h, w)
        lum = self.image.mean(axis=-1) * solid
        flat = np.maximum(lum.reshape(-1), 0.0)
        total = flat.sum()
        self.total = float(total)
        self.cdf = jnp.asarray(np.cumsum(flat) / max(total, 1e-20))
        self.dirs = jnp.asarray(dirs.reshape(-1, 3).astype(np.float32))
        self.radiance = jnp.asarray(self.image.reshape(-1, 3))
        self.solid = jnp.asarray(solid.reshape(-1).astype(np.float32))
        self.pdf = jnp.asarray(
            (flat / max(total, 1e-20) / np.maximum(solid.reshape(-1), 1e-12)).astype(
                np.float32
            )
        )


def sample_env_importance(table: EnvImportanceTable, scene, P, N, key, nsamples=8):
    """Importance-sample the environment by luminance (ibl.c importance)."""
    B = P.shape[0]
    total = jnp.zeros((B, 3), jnp.float32)
    for si in range(nsamples):
        u = jax.random.uniform(jax.random.fold_in(key, si), (B,))
        idx = jnp.clip(jnp.searchsorted(table.cdf, u), 0, table.dirs.shape[0] - 1)
        wi = table.dirs[idx]
        li = table.radiance[idx]
        pdf = jnp.maximum(table.pdf[idx], 1e-9)
        cos = jnp.maximum(jnp.sum(N * wi, axis=-1), 0.0)
        vis = 1.0 - any_hit(scene, P + N * scene.eps, wi).astype(jnp.float32)
        total = total + li * ((cos * vis) / pdf)[:, None]
    return total / nsamples


def sample_env_cosweight(env_fn, scene, P, N, key, nsamples=8):
    """Cosine-weighted gather (ri_ibl_sample_cosweight, ibl.c:53).

    env_fn(dirs (B,3)) -> (B,3) radiance."""
    B = P.shape[0]
    basis = ortho_basis(N)
    total = jnp.zeros((B, 3), jnp.float32)
    for si in range(nsamples):
        ur = jax.random.uniform(jax.random.fold_in(key, si), (B, 2))
        wi, _ = cosweight_sample(ur[:, 0], ur[:, 1], basis)
        vis = 1.0 - any_hit(scene, P + N * scene.eps, wi).astype(jnp.float32)
        total = total + env_fn(wi) * (vis * jnp.pi)[:, None]
    return total / nsamples


def sample_env_stratified(env_fn, scene, P, N, key, ntheta=4, nphi=4):
    """Stratified hemisphere gather (IBL_SAMPLING_STRATIFIED)."""
    B = P.shape[0]
    basis = ortho_basis(N)
    total = jnp.zeros((B, 3), jnp.float32)
    for i in range(ntheta):
        for j in range(nphi):
            k = jax.random.fold_in(key, i * nphi + j)
            ur = jax.random.uniform(k, (B, 2))
            z0 = (i + ur[:, 0]) / ntheta
            z1 = (j + ur[:, 1]) / nphi
            cos_t = jnp.sqrt(z0)
            phi = 2 * jnp.pi * z1
            wi = (
                (jnp.cos(phi) * jnp.sqrt(1 - z0))[:, None] * basis[0]
                + (jnp.sin(phi) * jnp.sqrt(1 - z0))[:, None] * basis[1]
                + cos_t[:, None] * basis[2]
            )
            vis = 1.0 - any_hit(scene, P + N * scene.eps, wi).astype(jnp.float32)
            total = total + env_fn(wi) * (vis * jnp.pi)[:, None]
    return total / (ntheta * nphi)


def sample_env_structured(samples_dirs, samples_rgb, scene, P, N):
    """Structured importance sampling: precomputed (S, 3) directions with
    (S, 3) pre-integrated radiance weights from sisgen (reference
    gensamples.dat via light->sisfile, light.h:51-52).  Deterministic —
    no RNG at render time, the hallmark of SIS."""
    dirs = jnp.asarray(samples_dirs, jnp.float32)
    rgb = jnp.asarray(samples_rgb, jnp.float32)
    total = jnp.zeros((P.shape[0], 3), jnp.float32)
    for si in range(dirs.shape[0]):
        wi = jnp.broadcast_to(dirs[si], P.shape)
        cos = jnp.maximum(jnp.sum(N * wi, axis=-1), 0.0)
        vis = 1.0 - any_hit(scene, P + N * scene.eps, wi).astype(jnp.float32)
        total = total + rgb[si] * (cos * vis)[:, None]
    return total


def sample_env_bruteforce(table: EnvImportanceTable, scene, P, N, max_texels=4096):
    """Integrate every environment texel (ri_ibl_sample_bruteforce,
    ibl.c:395).  O(B * texels) shadow rays — the ground-truth oracle.
    Maps are downsampled host-side to at most `max_texels` first."""
    ntex = table.dirs.shape[0]
    stride = max(1, int(np.ceil(ntex / max_texels)))
    total = jnp.zeros((P.shape[0], 3), jnp.float32)
    for i in range(0, ntex, stride):
        wi = jnp.broadcast_to(table.dirs[i], P.shape)
        cos = jnp.maximum(jnp.sum(N * wi, axis=-1), 0.0)
        vis = 1.0 - any_hit(scene, P + N * scene.eps, wi).astype(jnp.float32)
        # Riemann sum: Li * cos * vis * (texel solid angle * stride)
        dw = table.solid[i] * stride
        total = total + table.radiance[i] * (cos * vis * dw)[:, None]
    return total
