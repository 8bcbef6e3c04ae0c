"""Pallas kernel (Triton route): fused ambient-occlusion gather.

The AO integrator's hot phase traces ``ntheta*nphi`` stratified
hemisphere rays per primary hit (ambientocclusion.c:43-150).  The plain
formulation runs that as a `lax.scan` of occlusion queries, one per
stratum, each streaming every triangle and writing the (ray, stratum)
directions to device memory.  This kernel fuses the whole gather:

1. **Hit compaction.**  About half the eye rays miss the scene; the
   wrapper moves hit lanes to the front (a stable partition, or on
   larger scenes a sort by normal octant and origin Morton cell so a
   program's lanes share nearby origins and similar hemispheres) and
   programs wholly past the hit count skip all work.  Results scatter
   back to raster order afterwards.
2. **Directions in registers.**  Each stratum's direction is generated
   inside the strata loop from the shading basis and the per-lane jitter
   (the stratified ``cos_theta = sqrt((i+u)/n)`` sampling of
   ambientocclusion.c:85-110); no per-stratum ray buffer exists.
   Per-stratum randomness is Cranley-Patterson rotation: each lane draws
   two uniforms (indexed by compacted position) and stratum s shifts
   them by the additive-recurrence (R2) sequence ``frac(u + frac(s *
   alpha_k))`` — the generalized-Hammersley flavour of the reference's
   QMC sampler (qmc.c:380-428).
3. **Culled tiles, early exit.**  Per stratum the program walks the
   triangle tiles; a tile whose AABB none of the program's still
   unoccluded rays can reach is skipped, and the walk ends once every
   live ray is occluded.
4. **Signed-volume (triple-product) test.**  Occlusion needs a boolean,
   not (t, u, v): with pa, pb, pc the vertex offsets from the origin,
   ``U = d.(pb x pc)``, ``V = d.(pc x pa)``, ``W = d.n - U - V``; the ray
   hits iff U, V, W share a sign and ``(pa.n) (d.n) > 0``.  No division.

Memory plan per program (RB rays):
- rays: (16, RB) f32 rows [P_off | b0 | b1 | b2 | hit | pad*3];
- jitter: (8, RB) f32 rows [u0 | u1 | pad*6];
- triangles: (16, Npad) f32 rows [v0 | v1 | v2 | n] with n = e1 x e2,
  streamed from device memory one (TC,) row slice at a time;
- tile boxes: (8, n_tiles) f32.

Interpret mode runs the same kernel on the CPU for the test suite.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from lucille_tpu.accel.bruteforce import DET_EPS
from lucille_tpu.accel.pallas_isect import (
    TC,
    any_lane,
    bounded_inv,
    live_block,
    pack_boxes,
    partition_order,
    slab,
    tile_cols,
    triton_call,
)

TC_OCC = TC  # triangles per tile in the occlusion loop

# rays per program; the wrapper pads the wavefront up to a multiple
# (pad lanes carry hit=False, compact to the back and are skipped).
# 64 measured best on an H100 for one 240x240x9 AO tile (pallas_isect.py)
AO_RAY_BLOCK = 64

# R2 additive-recurrence constants (plastic number alpha, alpha^2): the
# per-stratum Cranley-Patterson shifts frac(s * A)
_R2_A1 = 0.7548776662466927
_R2_A2 = 0.5698402909980532

# from this many tiles on, hit lanes are sorted by (normal octant, origin
# Morton cell) instead of a plain partition, so a program's rays are
# coherent enough for the tile culls to bite (untuned)
_SORT_MIN_TILES = 8


def stratum_direction(s, u0_lane, u1_lane, b0, b1, b2, ntheta, nphi):
    """Direction of stratum s for every lane: CP-rotated R2 jitter on the
    stratified cosine-weighted grid (ambientocclusion.c:85-110), rotated
    into the (b0, b1, b2) frame (reflection.c:332-340).  b*: 3-tuples of
    (RB,) rows.  The same arithmetic serves the kernel and its callers
    that recompute the kernel's directions."""
    sf = s.astype(jnp.float32)
    sh0 = sf * _R2_A1
    sh1 = sf * _R2_A2
    u0 = u0_lane + (sh0 - jnp.floor(sh0))
    u0 = u0 - jnp.floor(u0)
    u1 = u1_lane + (sh1 - jnp.floor(sh1))
    u1 = u1 - jnp.floor(u1)
    # lax.rem/div: s >= 0, and jnp's floor semantics add selects that
    # the Triton lowering mistypes
    fi = jax.lax.rem(s, ntheta).astype(jnp.float32)
    fj = jax.lax.div(s, ntheta).astype(jnp.float32)
    z0 = (fi + u0) * (1.0 / ntheta)
    z1 = (fj + u1) * (1.0 / nphi)
    cos_t = jnp.sqrt(z0)
    phi = (2.0 * jnp.pi) * z1
    lx = jnp.cos(phi) * cos_t
    ly = jnp.sin(phi) * cos_t
    lz = jnp.sqrt(jnp.maximum(1.0 - z0, 0.0))
    return tuple(
        lx * b0[k] + ly * b1[k] + lz * b2[k] for k in range(3)
    )


def _ao_kernel(nact_ref, rays_ref, jit_ref, boxes_ref, tris_ref, occ_ref,
               *bits_refs, n_tiles, ntheta, nphi):
    """Occlusion counts (and optionally per-stratum bits) for RB lanes."""
    nsamples = ntheta * nphi
    rb = occ_ref.shape[0]
    ox, oy, oz = (rays_ref[k, :] for k in range(3))
    b0 = tuple(rays_ref[3 + k, :] for k in range(3))
    b1 = tuple(rays_ref[6 + k, :] for k in range(3))
    b2 = tuple(rays_ref[9 + k, :] for k in range(3))
    hit = rays_ref[12, :] > 0.5
    u0_lane = jit_ref[0, :]
    u1_lane = jit_ref[1, :]
    n_bit_rows = -(-nsamples // 32)
    # programs holding no hit lane (compaction) trace no stratum
    live_strata = live_block(nact_ref, rb) * nsamples

    def stratum(s, carry):
        occ, bits = carry[0], carry[1:]
        dx, dy, dz = stratum_direction(
            s, u0_lane, u1_lane, b0, b1, b2, ntheta, nphi
        )
        ivx, ivy, ivz = bounded_inv(dx), bounded_inv(dy), bounded_inv(dz)

        def tcond(c):
            i, o = c
            return (i < n_tiles) & any_lane(hit & (o == 0))

        def tbody(c):
            i, o = c
            tn, tf = slab(boxes_ref, i, ox, oy, oz, ivx, ivy, ivz)
            reach = (tn <= tf) & (tf > 0.0) & hit & (o == 0)

            def test():
                (v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z,
                 nx, ny, nz) = tile_cols(tris_ref, i * TC_OCC, TC_OCC,
                                         range(12))
                pax = v0x - ox  # (TC, RB) origin offsets
                pay = v0y - oy
                paz = v0z - oz
                pbx = v1x - ox
                pby = v1y - oy
                pbz = v1z - oz
                pcx = v2x - ox
                pcy = v2y - oy
                pcz = v2z - oz
                # cbc = pb x pc, cca = pc x pa
                cbcx = pby * pcz - pbz * pcy
                cbcy = pbz * pcx - pbx * pcz
                cbcz = pbx * pcy - pby * pcx
                ccax = pcy * paz - pcz * pay
                ccay = pcz * pax - pcx * paz
                ccaz = pcx * pay - pcy * pax
                s_n = pax * nx + pay * ny + paz * nz  # (A - o) . n
                U = dx * cbcx + dy * cbcy + dz * cbcz
                V = dx * ccax + dy * ccay + dz * ccaz
                dn = dx * nx + dy * ny + dz * nz  # d.n (MT det, negated)
                W = dn - U - V  # U + V + W = d.n
                inside = (jnp.minimum(jnp.minimum(U, V), W) >= 0.0) | (
                    jnp.maximum(jnp.maximum(U, V), W) <= 0.0
                )
                # t = s_n/dn > 0 without the division; DET_EPS keeps the
                # reference's degenerate-det rejection (bvh.c:746)
                h = inside & (s_n * dn > 0.0) & (jnp.abs(dn) > DET_EPS)
                return o | jnp.max(h.astype(jnp.int32), axis=0)

            o = jax.lax.cond(any_lane(reach), test, lambda: o)
            return i + 1, o

        _, o = jax.lax.while_loop(
            tcond, tbody, (jnp.int32(0), jnp.zeros((rb,), jnp.int32))
        )
        o = o & hit.astype(jnp.int32)
        # stratum s sets bit s % 32 of bit row s // 32
        new_bits = tuple(
            bits[r]
            | ((o * (jax.lax.div(s, 32) == r).astype(jnp.int32))
               << jnp.clip(s - 32 * r, 0, 31))
            for r in range(len(bits))
        )
        return (occ + o.astype(jnp.float32), *new_bits)

    n_carry_bits = n_bit_rows if bits_refs else 0
    init = (jnp.zeros((rb,), jnp.float32),) + tuple(
        jnp.zeros((rb,), jnp.int32) for _ in range(n_carry_bits)
    )
    out = jax.lax.fori_loop(0, live_strata, stratum, init)
    occ_ref[:] = out[0]
    if bits_refs:
        for r in range(n_bit_rows):
            bits_refs[0][r, :] = out[1 + r]


def occlusion_test_reference(org, dirn, v0, v1, v2):
    """Plain-JAX mirror of the kernel's signed-volume any-hit test.

    org, dirn: (B, 3); v0/v1/v2: (T, 3).  Returns (B,) bool.  The parity
    tests' oracle for the kernel's math (the MT formulation agrees except
    within float rounding of the u/v/t boundaries)."""
    pa = v0[None] - org[:, None]  # (B, T, 3)
    pb = v1[None] - org[:, None]
    pc = v2[None] - org[:, None]
    n = jnp.cross(v1 - v0, v2 - v0)[None]  # (1, T, 3)
    d = dirn[:, None]
    U = jnp.sum(d * jnp.cross(pb, pc), axis=-1)
    V = jnp.sum(d * jnp.cross(pc, pa), axis=-1)
    dn = jnp.sum(d * n, axis=-1)
    W = dn - U - V
    s_n = jnp.sum(pa * n, axis=-1)
    inside = (jnp.minimum(jnp.minimum(U, V), W) >= 0.0) | (
        jnp.maximum(jnp.maximum(U, V), W) <= 0.0
    )
    hit = inside & (s_n * dn > 0.0) & (jnp.abs(dn) > DET_EPS)
    return jnp.any(hit, axis=-1)


def _spread3(x):
    """Interleave the low 8 bits of x with two zero bits (int32)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def compaction_order(scene, P_off, b2, hit, n_tri_tiles):
    """Lane ordering for the compaction step.

    Small scenes: stable hit-first partition (raster order kept).  From
    _SORT_MIN_TILES tiles on: hit lanes sorted by (shading-normal octant,
    Morton cell of the shading point), so each program sees nearby
    origins with similar hemispheres — the coherence the tile culls live
    on.  Deterministic.  Returns (order, nhit)."""
    if n_tri_tiles < _SORT_MIN_TILES:
        return partition_order(hit)
    ext = jnp.maximum(scene.bbox_max - scene.bbox_min, 1e-12)
    q = jnp.clip(
        ((P_off - scene.bbox_min) / ext * 256.0).astype(jnp.int32), 0, 255
    )
    morton = (
        (_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1) | _spread3(q[:, 2])
    )
    octant = (
        (b2[:, 0] > 0).astype(jnp.int32) * 4
        + (b2[:, 1] > 0).astype(jnp.int32) * 2
        + (b2[:, 2] > 0).astype(jnp.int32)
    )
    key = jnp.where(hit, octant * (1 << 24) + morton, jnp.int32(1 << 29))
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    return order, jnp.sum(hit.astype(jnp.int32))


def pack_occ(scene, tc: int):
    """Scene SoA -> (16, Npad) f32 occlusion matrix, rows [v0|v1|v2|n].

    Padding columns are all-zero triangles: every triple product
    vanishes, `s_n * dn = 0` is not > 0, so pads never occlude."""
    n = scene.tri_v0.shape[0]
    npad = -(-n // tc) * tc
    v1 = scene.tri_v0 + scene.tri_e1
    v2 = scene.tri_v0 + scene.tri_e2
    nrm = jnp.cross(scene.tri_e1, scene.tri_e2)
    tris = jnp.zeros((16, npad), jnp.float32)
    tris = tris.at[0:3, :n].set(scene.tri_v0.T)
    tris = tris.at[3:6, :n].set(v1.T)
    tris = tris.at[6:9, :n].set(v2.T)
    tris = tris.at[9:12, :n].set(nrm.T)
    return tris, npad


def pallas_ao_occlusion(scene, P_off, b0, b1, b2, hit, key, ntheta: int,
                        nphi: int):
    """Occlusion counts for a wavefront of primary hits.

    P_off: (B, 3) eps-offset shading points; b0/b1/b2: (B, 3) ortho
    basis (b2 = shading normal); hit: (B,) primary-hit mask.  Returns
    (B,) f32 — how many of the ``ntheta*nphi`` stratified hemisphere rays
    are occluded (0 where ``hit`` is False)."""
    occ, _bits, _u = _pallas_ao_occlusion(
        scene, P_off, b0, b1, b2, hit, key, ntheta, nphi, False
    )
    return occ


def pallas_ao_occlusion_bits(scene, P_off, b0, b1, b2, hit, key,
                             ntheta: int, nphi: int):
    """Like pallas_ao_occlusion, but also returns (bits (ceil(S/32), B)
    i32 raster-order per-stratum occlusion masks, u01 (2, B) per-lane
    jitter) so a caller can recompute the kernel's exact directions."""
    return _pallas_ao_occlusion(
        scene, P_off, b0, b1, b2, hit, key, ntheta, nphi, True
    )


def pallas_ao_sky(scene, P_off, b0, b1, b2, hit, key, ntheta, nphi, sky):
    """Sunsky-AO gather (ambientocclusion.c:154-332) through the fused
    kernel's per-stratum bitmask: the directions are recomputed with the
    kernel's own jitter and R2 rotation, so stratum s's visibility bit
    pairs with exactly the direction the kernel traced, and each
    unoccluded stratum adds the sky radiance along it.  Returns (B, 3)."""
    _occ, bits, u01 = pallas_ao_occlusion_bits(
        scene, P_off, b0, b1, b2, hit, key, ntheta, nphi
    )
    nsamples = ntheta * nphi
    B = P_off.shape[0]
    basis = tuple(tuple(b[:, k] for k in range(3)) for b in (b0, b1, b2))

    def step(col, s):
        wx, wy, wz = stratum_direction(s, u01[0], u01[1], *basis,
                                       ntheta, nphi)
        row = jax.lax.dynamic_index_in_dim(bits, s // 32, axis=0,
                                           keepdims=False)
        occluded = ((row >> (s % 32)) & 1) == 1
        vis = (~occluded) & hit
        # world (y-up) -> sky model (z-up): lightsource.c:152-158's swap
        d_sky = jnp.stack([wx, wz, wy], axis=-1)
        return col + vis[:, None] * sky.sky_rgb(d_sky), None

    col, _ = jax.lax.scan(step, jnp.zeros((B, 3), jnp.float32),
                          jnp.arange(nsamples, dtype=jnp.int32))
    return col


@partial(jax.jit, static_argnames=("ntheta", "nphi", "want_bits"))
def _pallas_ao_occlusion(scene, P_off, b0, b1, b2, hit, key, ntheta, nphi,
                         want_bits=False):
    B = P_off.shape[0]
    Bpad = -(-B // AO_RAY_BLOCK) * AO_RAY_BLOCK
    nsamples = ntheta * nphi
    tris, npad = pack_occ(scene, TC_OCC)
    n_tiles = npad // TC_OCC

    # hit compaction; wavefront pad lanes (Bpad > B) carry hit=False
    if Bpad != B:
        hit_w = jnp.zeros((Bpad,), hit.dtype).at[:B].set(hit)
        pad3 = lambda a: jnp.zeros((Bpad, 3), a.dtype).at[:B].set(a)
        P_off, b0, b1, b2 = pad3(P_off), pad3(b0), pad3(b1), pad3(b2)
    else:
        hit_w = hit
    order, nhit = compaction_order(scene, P_off, b2, hit_w, n_tiles)

    # per-lane CP-rotation bases, indexed by COMPACTED position: i.i.d.
    # uniforms, so the estimator is unchanged.  Drawn at width B (not
    # Bpad) so the stream does not depend on the block padding; live
    # lanes only read columns < nhit <= B.
    jitter = jnp.zeros((8, Bpad), jnp.float32)
    jitter = jitter.at[0:2, :B].set(
        jax.random.uniform(key, (2, B), dtype=jnp.float32)
    )

    rays = jnp.zeros((16, Bpad), jnp.float32)
    rays = rays.at[0:3].set(P_off[order].T)
    rays = rays.at[3:6].set(b0[order].T)
    rays = rays.at[6:9].set(b1[order].T)
    rays = rays.at[9:12].set(b2[order].T)
    rays = rays.at[12].set(hit_w[order].astype(jnp.float32))
    nact = nhit.astype(jnp.int32).reshape((1,))
    boxes = pack_boxes(scene, npad, TC_OCC)

    n_bit_rows = -(-nsamples // 32)
    row = pl.BlockSpec((AO_RAY_BLOCK,), lambda i: (i,))
    out_specs = [row]
    out_shape = [jax.ShapeDtypeStruct((Bpad,), jnp.float32)]
    if want_bits:
        out_specs.append(
            pl.BlockSpec((n_bit_rows, AO_RAY_BLOCK), lambda i: (0, i))
        )
        out_shape.append(jax.ShapeDtypeStruct((n_bit_rows, Bpad), jnp.int32))

    outs = triton_call(
        partial(_ao_kernel, n_tiles=n_tiles, ntheta=ntheta, nphi=nphi),
        grid=(Bpad // AO_RAY_BLOCK,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),
            pl.BlockSpec((16, AO_RAY_BLOCK), lambda i: (0, i)),
            pl.BlockSpec((8, AO_RAY_BLOCK), lambda i: (0, i)),
            pl.BlockSpec(boxes.shape, lambda i: (0, 0)),
            pl.BlockSpec(tris.shape, lambda i: (0, 0)),
        ],
        out_specs=out_specs,
        out_shape=out_shape,
        name="lucille_ao_gather",
    )(nact, rays, jitter, boxes, tris)
    occ = jnp.zeros((Bpad,), jnp.float32).at[order].set(outs[0])
    if not want_bits:
        return occ[:B], None, None
    bits = jnp.zeros((n_bit_rows, Bpad), jnp.int32).at[:, order].set(outs[1])
    # per-lane jitter back in raster order: compacted column j belongs to
    # raster lane order[j]
    u_r = jnp.zeros((2, Bpad), jnp.float32).at[:, order].set(jitter[0:2])
    return occ[:B], bits[:, :B], u_r[:, :B]
