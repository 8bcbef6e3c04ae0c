"""AO gather kernel parity (interpret mode on the CPU): the fused Triton
gather must reproduce the unfused path exactly when fed the same
stratified jitter."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_intersect import _random_soup, _scene_from_tris


def _reference_occlusion(sc, P, b0, b1, b2, hit, key, ntheta, nphi, mt=False):
    """Recompute the kernel's math with plain JAX, using the identical
    jitter stream.  mt=False mirrors the kernel's signed-volume any-hit
    exactly; mt=True uses the Moller-Trumbore brute path (agrees except
    within float rounding of the u/v/t window boundaries)."""
    from lucille_tpu.accel.bruteforce import brute_any_hit
    from lucille_tpu.accel.pallas_ao import occlusion_test_reference

    v1 = sc.tri_v0 + sc.tri_e1
    v2 = sc.tri_v0 + sc.tri_e2
    from lucille_tpu.accel.pallas_ao import (
        _R2_A1,
        _R2_A2,
        TC_OCC,
        compaction_order,
    )

    B = P.shape[0]
    ns = ntheta * nphi
    # per-lane CP-rotation bases indexed by compacted lane position
    # (matches the wrapper): lane order[j] consumes jitter column j
    n_tiles = -(-sc.tri_v0.shape[0] // TC_OCC)
    order, _ = compaction_order(sc, P, b2, hit, n_tiles)
    inv = jnp.zeros((B,), jnp.int32).at[order].set(jnp.arange(B, dtype=jnp.int32))
    base = jax.random.uniform(key, (2, B), dtype=jnp.float32)[:, inv]
    count = jnp.zeros(B)
    for s in range(ns):
        sf = jnp.float32(s)
        sh0 = sf * jnp.float32(_R2_A1)
        sh1 = sf * jnp.float32(_R2_A2)
        u0 = base[0] + (sh0 - jnp.floor(sh0))
        u0 = u0 - jnp.floor(u0)
        u1 = base[1] + (sh1 - jnp.floor(sh1))
        u1 = u1 - jnp.floor(u1)
        z0 = (float(s % ntheta) + u0) / ntheta
        z1 = (float(s // ntheta) + u1) / nphi
        cos_t = jnp.sqrt(z0)
        phi = 2 * jnp.pi * z1
        lx = jnp.cos(phi) * cos_t
        ly = jnp.sin(phi) * cos_t
        lz = jnp.sqrt(jnp.maximum(1 - z0, 0))
        w = lx[:, None] * b0 + ly[:, None] * b1 + lz[:, None] * b2
        if mt:
            occl = brute_any_hit(sc, P, w)
        else:
            occl = occlusion_test_reference(P, w, sc.tri_v0, v1, v2)
        count = count + (occl & hit).astype(jnp.float32)
    return count


@pytest.mark.parametrize(
    "ntheta,nphi",
    [(4, 4), pytest.param(8, 8, marks=pytest.mark.slow)],  # ~18 s
)
def test_megakernel_matches_unfused(ntheta, nphi):
    from lucille_tpu.accel.pallas_ao import pallas_ao_occlusion
    from lucille_tpu.transport.ao import ortho_basis

    v0, v1, v2 = _random_soup(700, seed=5)
    sc = _scene_from_tris(v0, v1, v2, "pallas")
    B = 256
    rng = np.random.default_rng(1)
    P = jnp.asarray(rng.uniform(-4, 4, (B, 3)), jnp.float32)
    N = rng.normal(size=(B, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    b0, b1, b2 = ortho_basis(jnp.asarray(N, jnp.float32))
    hit = jnp.asarray(rng.uniform(size=B) < 0.8)
    key = jax.random.key(7)

    occ = pallas_ao_occlusion(sc, P, b0, b1, b2, hit, key, ntheta, nphi)
    ref = _reference_occlusion(sc, P, b0, b1, b2, hit, key, ntheta, nphi)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))

    # Moller-Trumbore cross-check: the two formulations may disagree only
    # where a sample lands within float rounding of the u/v/t window
    # boundary — vanishingly rare for random jitter
    ref_mt = np.asarray(
        _reference_occlusion(sc, P, b0, b1, b2, hit, key, ntheta, nphi, mt=True)
    )
    diff = np.abs(np.asarray(occ) - ref_mt)
    assert diff.max() <= 1.0
    assert (diff != 0).mean() < 0.01


def test_ao_radiance_uses_megakernel_and_matches_scan():
    """End-to-end ao_radiance on accel=pallas (megakernel) vs bruteforce
    (scan): different RNG streams, so compare image statistics."""
    from lucille_tpu.transport.ao import ao_radiance

    v0, v1, v2 = _random_soup(400, seed=2, spread=2.0, size=0.8)
    sc_p = _scene_from_tris(v0, v1, v2, "pallas")
    sc_b = _scene_from_tris(v0, v1, v2, "bruteforce")
    B = 512
    rng = np.random.default_rng(3)
    org = jnp.asarray(rng.uniform(-3, 3, (B, 3)), jnp.float32)
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dirn = jnp.asarray(d, jnp.float32)
    key = jax.random.key(0)

    rad_p, aux_p = ao_radiance(sc_p, org, dirn, key, 8, 8)
    rad_b, aux_b = ao_radiance(sc_b, org, dirn, key, 8, 8)
    assert bool(jnp.array_equal(aux_p["hit"], aux_b["hit"]))
    assert int(aux_p["nrays"]) == int(aux_b["nrays"])
    hit = np.asarray(aux_p["hit"])
    a = np.asarray(rad_p)[hit, 0]
    b = np.asarray(rad_b)[hit, 0]
    # same stratified estimator, independent jitter: per-ray values agree
    # to MC noise (64 strata -> sigma ~ 1/16), means much tighter
    assert abs(a.mean() - b.mean()) < 0.02
    assert np.abs(a - b).max() < 0.25


def test_megakernel_culled_paths_match(ntheta=4, nphi=4):
    """A soup big enough (19 tiles) for the sorted lane order: exact
    parity against the uncullable plain-JAX oracle proves the per-stratum
    tile culls and the early exit are conservative."""
    from lucille_tpu.accel.pallas_ao import (
        _SORT_MIN_TILES,
        TC_OCC,
        pallas_ao_occlusion,
    )
    from lucille_tpu.transport.ao import ortho_basis

    ntris = TC_OCC * 19 - 5  # not a tile multiple
    assert ntris // TC_OCC >= _SORT_MIN_TILES
    v0, v1, v2 = _random_soup(ntris, seed=13)
    sc = _scene_from_tris(v0, v1, v2, "pallas")
    B = 512
    rng = np.random.default_rng(21)
    P = jnp.asarray(rng.uniform(-4, 4, (B, 3)), jnp.float32)
    N = rng.normal(size=(B, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    b0, b1, b2 = ortho_basis(jnp.asarray(N, jnp.float32))
    hit = jnp.asarray(rng.uniform(size=B) < 0.7)
    key = jax.random.key(17)

    occ = pallas_ao_occlusion(sc, P, b0, b1, b2, hit, key, ntheta, nphi)
    ref = _reference_occlusion(sc, P, b0, b1, b2, hit, key, ntheta, nphi)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))
    assert float(jnp.sum(occ)) > 0  # scene dense enough to occlude


@pytest.mark.parametrize("B", [1, 130, 257])
def test_ragged_wavefront_matches_oracle(B):
    """Wavefronts that are not a multiple of AO_RAY_BLOCK are padded with
    dead lanes that never reach the results."""
    from lucille_tpu.accel.pallas_ao import pallas_ao_occlusion
    from lucille_tpu.transport.ao import ortho_basis

    v0, v1, v2 = _random_soup(150, seed=6, spread=2.0, size=0.8)
    sc = _scene_from_tris(v0, v1, v2, "pallas")
    rng = np.random.default_rng(B)
    P = jnp.asarray(rng.uniform(-2, 2, (B, 3)), jnp.float32)
    N = rng.normal(size=(B, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    b0, b1, b2 = ortho_basis(jnp.asarray(N, jnp.float32))
    hit = jnp.ones((B,), bool)
    key = jax.random.key(B)
    occ = pallas_ao_occlusion(sc, P, b0, b1, b2, hit, key, 2, 2)
    ref = _reference_occlusion(sc, P, b0, b1, b2, hit, key, 2, 2)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))


def test_no_hit_lanes_report_zero():
    """An all-miss eye wavefront: every program is past the hit count and
    skips all work; counts are zero."""
    from lucille_tpu.accel.pallas_ao import pallas_ao_occlusion_bits
    from lucille_tpu.transport.ao import ortho_basis

    v0, v1, v2 = _random_soup(100, seed=7)
    sc = _scene_from_tris(v0, v1, v2, "pallas")
    B = 100
    P = jnp.zeros((B, 3), jnp.float32)
    b0, b1, b2 = ortho_basis(jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (B, 1)))
    occ, bits, _u = pallas_ao_occlusion_bits(
        sc, P, b0, b1, b2, jnp.zeros((B,), bool), jax.random.key(0), 4, 4
    )
    assert not np.asarray(occ).any()
    assert not np.asarray(bits).any()


def test_unit_sky_reduces_to_plain_ao():
    """pallas_ao_sky with sky_rgb == 1 counts the unoccluded strata of
    the same launch: col = (nsamples - occ) on every hit lane."""
    from lucille_tpu.accel.pallas_ao import pallas_ao_occlusion, pallas_ao_sky
    from lucille_tpu.transport.ao import ortho_basis

    class UnitSky:
        def sky_rgb(self, d):
            return jnp.ones((d.shape[0], 3), jnp.float32)

    v0, v1, v2 = _random_soup(300, seed=9)
    sc = _scene_from_tris(v0, v1, v2, "pallas")
    B = 200
    rng = np.random.default_rng(8)
    P = jnp.asarray(rng.uniform(-4, 4, (B, 3)), jnp.float32)
    N = rng.normal(size=(B, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    b0, b1, b2 = ortho_basis(jnp.asarray(N, jnp.float32))
    hit = jnp.asarray(rng.uniform(size=B) < 0.75)
    key = jax.random.key(4)
    occ = pallas_ao_occlusion(sc, P, b0, b1, b2, hit, key, 8, 8)
    col = pallas_ao_sky(sc, P, b0, b1, b2, hit, key, 8, 8, UnitSky())
    expect = (64.0 - np.asarray(occ)) * np.asarray(hit)
    for c in range(3):
        np.testing.assert_array_equal(np.asarray(col)[:, c], expect)


def test_occlusion_bits_match_counts():
    """pallas_ao_occlusion_bits: the per-stratum bitmask's popcount must
    equal the fused kernel's occlusion count bit-for-bit (same launch)."""
    from lucille_tpu.accel.pallas_ao import (
        pallas_ao_occlusion,
        pallas_ao_occlusion_bits,
    )
    from lucille_tpu.transport.ao import ortho_basis

    v0, v1, v2 = _random_soup(500, seed=11)
    sc = _scene_from_tris(v0, v1, v2, "pallas")
    B = 384
    rng = np.random.default_rng(4)
    P = jnp.asarray(rng.uniform(-4, 4, (B, 3)), jnp.float32)
    N = rng.normal(size=(B, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    b0, b1, b2 = ortho_basis(jnp.asarray(N, jnp.float32))
    hit = jnp.asarray(rng.uniform(size=B) < 0.7)
    key = jax.random.key(3)

    occ = pallas_ao_occlusion(sc, P, b0, b1, b2, hit, key, 8, 8)
    occ2, bits, u01 = pallas_ao_occlusion_bits(
        sc, P, b0, b1, b2, hit, key, 8, 8
    )
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ2))
    b = np.asarray(bits).astype(np.uint32)
    pop = np.zeros(B)
    for r in range(b.shape[0]):
        for k in range(32):
            pop += (b[r] >> k) & 1
    hitm = np.asarray(hit)
    np.testing.assert_array_equal(pop * hitm, np.asarray(occ))
    # jitter columns: raster order, live lanes carry uniforms in [0, 1)
    u = np.asarray(u01)
    assert u.shape == (2, B)
    assert (u >= 0).all() and (u < 1).all()


def test_sunsky_megakernel_matches_scan_statistics():
    """Sunsky-AO on accel=pallas (bitmask megakernel path) vs bruteforce
    (wavefront scan): independent jitter streams, matching statistics."""
    from lucille_tpu.lights.tables import build_light_tables
    from lucille_tpu.ri.api import RiState
    from lucille_tpu.rib.parser import parse_rib
    from lucille_tpu.scene.compile import compile_scene
    from lucille_tpu.transport.ao import ao_radiance

    def render(accel):
        s = RiState()
        s.options.accel_method = accel
        parse_rib(
            "WorldBegin\n"
            'AreaLightSource "sunsky" 1 "hour" [10.0] "turbidity" [2.2]\n'
            'PointsPolygons [4] [0 3 2 1] "P" '
            '[-50 0 -50  50 0 -50  50 0 50  -50 0 50]\n'
            'PointsPolygons [3] [0 1 2] "P" [-2 0 -2  2 0 -2  0 3 0]\n'
            "WorldEnd\n",
            s,
        )
        scene = compile_scene(s.scene).device_put()
        lights = build_light_tables(s.scene)
        B = 512
        rng = np.random.default_rng(9)
        org = jnp.asarray(
            np.stack(
                [rng.uniform(-4, 4, B), np.full(B, 6.0),
                 rng.uniform(-4, 4, B)], axis=-1
            ),
            jnp.float32,
        )
        dirn = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (B, 3))
        rad, aux = ao_radiance(
            scene, org, dirn, jax.random.key(1), 8, 8, lights=lights
        )
        return np.asarray(rad), np.asarray(aux["hit"])

    rad_p, hit_p = render("pallas")
    rad_b, hit_b = render("bruteforce")
    np.testing.assert_array_equal(hit_p, hit_b)
    a = rad_p[hit_p].mean(axis=0)
    b = rad_b[hit_b].mean(axis=0)
    np.testing.assert_allclose(a, b, rtol=0.05)
