"""Tile-BVH (accel/pallas_bvh.py) tests: host build invariants and
packet-walk kernel parity against oracles (interpret mode on the CPU),
plus the plain per-ray walks (accel/traverse.py) they are timed against."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _random_soup(n, seed=0, spread=5.0, size=0.3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3))
    v0 = c + rng.normal(0, size, (n, 3))
    v1 = c + rng.normal(0, size, (n, 3))
    v2 = c + rng.normal(0, size, (n, 3))
    return v0, v1, v2


def _scene(v0, v1, v2, accel="bvh"):
    from lucille_tpu.ri.types import AttributeState, GeomData, SceneDescription
    from lucille_tpu.scene.compile import compile_scene

    n = len(v0)
    pos = np.concatenate([v0, v1, v2])
    idx = np.stack(
        [np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], axis=-1
    ).astype(np.int32)
    desc = SceneDescription()
    desc.geoms.append(
        GeomData(positions=pos, indices=idx, attrs=AttributeState())
    )
    desc.options.accel_method = accel
    return compile_scene(desc).device_put()


class TestTileBVHBuild:
    def test_every_triangle_placed_once(self):
        from lucille_tpu.accel.pallas_bvh import build_tile_bvh

        v0, v1, v2 = _random_soup(1000, seed=1)
        src, nbox, nmeta, m = build_tile_bvh(v0, v1, v2)
        from lucille_tpu.accel.pallas_bvh import TC

        real = src[src >= 0]
        assert sorted(real.tolist()) == list(range(1000))
        assert len(src) % TC == 0

    def test_skip_walk_visits_every_node(self):
        from lucille_tpu.accel.pallas_bvh import build_tile_bvh

        v0, v1, v2 = _random_soup(700, seed=2)
        src, nbox, nmeta, m = build_tile_bvh(v0, v1, v2)
        skip, first, count = nmeta
        i, visited = 0, 0
        while i < m:
            visited += 1
            i = i + 1 if count[i] == 0 else int(skip[i])
        assert visited == m

    def test_leaf_tiles_disjoint_and_cover(self):
        from lucille_tpu.accel.pallas_bvh import build_tile_bvh

        v0, v1, v2 = _random_soup(600, seed=3)
        src, nbox, nmeta, m = build_tile_bvh(v0, v1, v2)
        skip, first, count = nmeta
        leaf = count > 0
        spans = sorted(
            (int(f), int(f + c)) for f, c in zip(first[leaf], count[leaf])
        )
        pos = 0
        for a, e in spans:
            assert a == pos
            pos = e
        from lucille_tpu.accel.pallas_bvh import TC

        assert pos * TC == len(src)

    def test_each_leaf_is_one_tile(self):
        """Leaves hold at most TC triangles, so every leaf visit is one
        dense tile test; no node budget grows them."""
        from lucille_tpu.accel.pallas_bvh import build_tile_bvh

        v0, v1, v2 = _random_soup(5000, seed=4)
        src, nbox, nmeta, m = build_tile_bvh(v0, v1, v2)
        count = nmeta[2]
        assert set(np.unique(count[count > 0]).tolist()) == {1}
        assert m > 5000 // 16  # no leaf-size doubling


class TestAOKernelParity:
    def test_occlusion_counts_match_scan_path(self):
        """The production (cone-tiled) BVH AO path against a dense
        occlusion oracle with the SAME per-lane CP-rotated jitter
        replicated in plain JAX (the cone path draws its uniforms on the
        unsorted padded wavefront, _stratified_dirs)."""
        from lucille_tpu.accel.pallas_ao import (
            _R2_A1,
            _R2_A2,
            occlusion_test_reference,
        )
        from lucille_tpu.accel.pallas_bvh import pallas_bvh_ao_occlusion
        from lucille_tpu.transport.ao import ortho_basis

        v0, v1, v2 = _random_soup(900, seed=5)
        sc = _scene(v0, v1, v2, "bvh")
        rng = np.random.default_rng(11)
        B = 64
        P = jnp.asarray(rng.uniform(-4, 4, (B, 3)), jnp.float32)
        nrm = rng.normal(size=(B, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        b0, b1, b2 = ortho_basis(jnp.asarray(nrm, jnp.float32))
        hit = jnp.asarray(rng.random(B) < 0.8)

        ntheta = nphi = 4
        key = jax.random.key(3)
        occ, _stats = pallas_bvh_ao_occlusion(
            sc, P, b0, b1, b2, hit, key, ntheta, nphi
        )

        # cone path: padded arrays; uniforms drawn at the TRUE wavefront
        # width (pad-independent stream) and zero-padded like
        # _stratified_dirs(nreal=B)
        from lucille_tpu.accel.pallas_bvh import RAY_BLOCK

        Bpad = -(-B // RAY_BLOCK) * RAY_BLOCK
        hit_w = jnp.zeros((Bpad,), hit.dtype).at[:B].set(hit)
        pad3 = lambda a: jnp.zeros((Bpad, 3), a.dtype).at[:B].set(a)
        Pp, b0p, b1p, b2p = pad3(P), pad3(b0), pad3(b1), pad3(b2)
        u = np.zeros((2, Bpad), np.float32)
        u[:, :B] = np.asarray(
            jax.random.uniform(key, (2, B), dtype=jnp.float32)
        )
        v1w = sc.tri_v0 + sc.tri_e1
        v2w = sc.tri_v0 + sc.tri_e2
        occ_ref = np.zeros(Bpad, np.float32)
        b0n, b1n, b2n = np.asarray(b0p), np.asarray(b1p), np.asarray(b2p)
        hs = np.asarray(hit_w)
        for s in range(ntheta * nphi):
            sh0 = (s * _R2_A1) % 1.0
            sh1 = (s * _R2_A2) % 1.0
            u0 = (u[0] + sh0) % 1.0
            u1 = (u[1] + sh1) % 1.0
            fi, fj = s % ntheta, s // ntheta
            z0 = (fi + u0) / ntheta
            z1 = (fj + u1) / nphi
            cos_t = np.sqrt(z0)
            phi = 2 * np.pi * z1
            lx = np.cos(phi) * cos_t
            ly = np.sin(phi) * cos_t
            lz = np.sqrt(np.maximum(1 - z0, 0))
            d = lx[:, None] * b0n + ly[:, None] * b1n + lz[:, None] * b2n
            occd = occlusion_test_reference(
                jnp.asarray(Pp), jnp.asarray(d), sc.tri_v0, v1w, v2w
            )
            occ_ref += np.asarray(occd) & hs
        got = np.asarray(occ)
        # the kernel uses the MT formulation, the oracle signed-volume:
        # they agree except within float rounding of hit boundaries
        assert np.abs(got - occ_ref[:B]).max() <= 1.0
        assert np.abs(got - occ_ref[:B]).mean() < 0.1

    def test_ao_radiance_uses_pbvh_kernel(self):
        """ao_radiance on a pbvh scene matches the plain scan AO path on a
        bruteforce scene at the image level (different RNG streams:
        tolerance is Monte-Carlo noise)."""
        from lucille_tpu.transport.ao import ao_radiance

        v0, v1, v2 = _random_soup(600, seed=8)
        sc_bvh = _scene(v0, v1, v2, "bvh")
        sc_bf = _scene(v0, v1, v2, "bruteforce")
        rng = np.random.default_rng(2)
        B = 128
        org = jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32)
        d = rng.normal(size=(B, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dirn = jnp.asarray(d, jnp.float32)
        r1, a1 = ao_radiance(sc_bvh, org, dirn, jax.random.key(0), 4, 4)
        r2, a2 = ao_radiance(sc_bf, org, dirn, jax.random.key(0), 4, 4)
        np.testing.assert_array_equal(
            np.asarray(a1["hit"]), np.asarray(a2["hit"])
        )
        h = np.asarray(a1["hit"])
        if h.any():
            diff = np.abs(np.asarray(r1)[h] - np.asarray(r2)[h])
            assert diff.mean() < 0.15  # MC noise at 16 samples


def _rays(B, seed=21):
    rng = np.random.default_rng(seed)
    org = jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32)
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, jnp.asarray(d, jnp.float32)


@pytest.fixture(params=[32, 64, 128])
def bvh_ray_block(request, monkeypatch):
    """Run a test at several packet widths (the constant is read when the
    kernel is traced, so compiled traces of other widths are dropped)."""
    from lucille_tpu.accel import pallas_bvh

    monkeypatch.setattr(pallas_bvh, "RAY_BLOCK", request.param)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


class TestPacketWalkParity:
    """The packet walks against the brute-force oracle at several packet
    widths, on wavefronts that are not a multiple of the width."""

    def test_closest_matches_bruteforce(self, bvh_ray_block):
        from lucille_tpu.accel.bruteforce import brute_closest_hit
        from lucille_tpu.accel.pallas_bvh import pallas_bvh_closest_hit

        v0, v1, v2 = _random_soup(500, seed=31)
        sc = _scene(v0, v1, v2, "bvh")
        org, dirn = _rays(300, seed=32)
        r1 = brute_closest_hit(sc, org, dirn)
        r2 = pallas_bvh_closest_hit(sc, org, dirn)
        h = np.asarray(r1["hit"])
        np.testing.assert_array_equal(h, np.asarray(r2["hit"]))
        np.testing.assert_array_equal(
            np.asarray(r1["tri"])[h], np.asarray(r2["tri"])[h]
        )
        np.testing.assert_allclose(
            np.asarray(r1["t"])[h], np.asarray(r2["t"])[h], rtol=1e-5
        )
        assert float(r2["ntrav"]) > 0

    def test_any_hit_matches_bruteforce(self, bvh_ray_block):
        from lucille_tpu.accel.bruteforce import brute_any_hit
        from lucille_tpu.accel.pallas_bvh import pallas_bvh_any_hit

        v0, v1, v2 = _random_soup(500, seed=33)
        sc = _scene(v0, v1, v2, "bvh")
        org, dirn = _rays(300, seed=34)
        tmax = jnp.asarray(np.random.default_rng(35).uniform(1, 12, 300),
                           jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(brute_any_hit(sc, org, dirn, tmax=tmax)),
            np.asarray(pallas_bvh_any_hit(sc, org, dirn, tmax=tmax)),
        )


class TestPlainWalk:
    """accel/traverse.py's per-ray walks: the XLA baseline of the packet
    walks must answer exactly what brute force answers."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_walk_closest_matches_bruteforce(self, seed):
        from lucille_tpu.accel.bruteforce import brute_closest_hit
        from lucille_tpu.accel.traverse import walk_closest_hit

        v0, v1, v2 = _random_soup(400, seed=40 + seed)
        sc = _scene(v0, v1, v2, "bvh")
        org, dirn = _rays(256, seed=50 + seed)
        r1 = brute_closest_hit(sc, org, dirn)
        r2 = walk_closest_hit(sc, org, dirn)
        h = np.asarray(r1["hit"])
        np.testing.assert_array_equal(h, np.asarray(r2["hit"]))
        np.testing.assert_array_equal(
            np.asarray(r1["tri"])[h], np.asarray(r2["tri"])[h]
        )

    def test_walk_any_hit_matches_bruteforce(self):
        from lucille_tpu.accel.bruteforce import brute_any_hit
        from lucille_tpu.accel.traverse import walk_any_hit

        v0, v1, v2 = _random_soup(400, seed=42)
        sc = _scene(v0, v1, v2, "bvh")
        org, dirn = _rays(256, seed=52)
        for tmax in (None, 3.0):
            np.testing.assert_array_equal(
                np.asarray(brute_any_hit(sc, org, dirn, tmax=tmax)),
                np.asarray(walk_any_hit(sc, org, dirn, tmax=tmax)),
            )

    def test_walk_tag_routes_through_dispatch(self):
        """A tile-BVH scene retagged "walk" answers through the per-ray
        walk — the plain frame the packet walks are measured against."""
        import dataclasses

        from lucille_tpu.accel.dispatch import any_hit, closest_hit

        v0, v1, v2 = _random_soup(300, seed=43)
        sc = _scene(v0, v1, v2, "bvh")
        sw = dataclasses.replace(sc, accel="walk")
        org, dirn = _rays(128, seed=53)
        np.testing.assert_array_equal(
            np.asarray(closest_hit(sc, org, dirn)["hit"]),
            np.asarray(closest_hit(sw, org, dirn)["hit"]),
        )
        np.testing.assert_array_equal(
            np.asarray(any_hit(sc, org, dirn)), np.asarray(any_hit(sw, org, dirn))
        )


class TestWindowSemantics:
    def test_tmax_respected(self):
        from lucille_tpu.accel.pallas_bvh import pallas_bvh_any_hit

        v0 = np.array([[-1.0, -1.0, 5.0]])
        v1 = np.array([[1.0, -1.0, 5.0]])
        v2 = np.array([[0.0, 1.0, 5.0]])
        sc = _scene(v0, v1, v2, "bvh")
        org = jnp.zeros((1, 3), jnp.float32)
        dirn = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
        assert bool(pallas_bvh_any_hit(sc, org, dirn)[0])
        assert not bool(pallas_bvh_any_hit(sc, org, dirn, tmax=4.0)[0])
        assert bool(pallas_bvh_any_hit(sc, org, dirn, tmax=6.0)[0])

    def test_closest_tmax_window(self):
        from lucille_tpu.accel.pallas_bvh import pallas_bvh_closest_hit

        v0 = np.array([[-1.0, -1.0, 5.0], [-1.0, -1.0, 2.0]])
        v1 = np.array([[1.0, -1.0, 5.0], [1.0, -1.0, 2.0]])
        v2 = np.array([[0.0, 1.0, 5.0], [0.0, 1.0, 2.0]])
        sc = _scene(v0, v1, v2, "bvh")
        org = jnp.zeros((1, 3), jnp.float32)
        dirn = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
        r = pallas_bvh_closest_hit(sc, org, dirn)
        assert bool(r["hit"][0]) and abs(float(r["t"][0]) - 2.0) < 1e-4
        r = pallas_bvh_closest_hit(sc, org, dirn, tmax=1.0)
        assert not bool(r["hit"][0])
        # tmin skips the nearer triangle
        r = pallas_bvh_closest_hit(sc, org, dirn, tmin=3.0)
        assert bool(r["hit"][0]) and abs(float(r["t"][0]) - 5.0) < 1e-4

    def test_all_miss_wavefront(self):
        from lucille_tpu.accel.pallas_bvh import (
            pallas_bvh_any_hit,
            pallas_bvh_closest_hit,
        )

        v0, v1, v2 = _random_soup(200, seed=44)
        sc = _scene(v0, v1, v2, "bvh")
        B = 70
        org = jnp.broadcast_to(jnp.asarray([0.0, 50.0, 0.0]), (B, 3))
        dirn = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (B, 3))
        assert not np.asarray(pallas_bvh_closest_hit(sc, org, dirn)["hit"]).any()
        assert not np.asarray(pallas_bvh_any_hit(sc, org, dirn)).any()


class TestConeTiledSunsky:
    def test_unit_sky_reduces_to_plain_ao(self):
        """pallas_bvh_ao_sky with sky_rgb == 1 must reproduce the plain
        cone-tiled occlusion EXACTLY (same kernel, same streams):
        col = (nsamples - occ) on every hit lane."""
        import jax
        import jax.numpy as jnp

        from lucille_tpu.accel.pallas_bvh import (
            pallas_bvh_ao_occlusion,
            pallas_bvh_ao_sky,
        )
        from lucille_tpu.transport.ao import ortho_basis

        class UnitSky:
            def sky_rgb(self, d):
                return jnp.ones((d.shape[0], 3), jnp.float32)

        v0, v1, v2 = _random_soup(900, seed=13)
        sc = _scene(v0, v1, v2, accel="bvh")
        B = 300
        rng = np.random.default_rng(5)
        P = jnp.asarray(rng.uniform(-4, 4, (B, 3)), jnp.float32)
        N = rng.normal(size=(B, 3))
        N /= np.linalg.norm(N, axis=-1, keepdims=True)
        b0, b1, b2 = ortho_basis(jnp.asarray(N, jnp.float32))
        hit = jnp.asarray(rng.uniform(size=B) < 0.75)
        key = jax.random.key(2)

        occ, _ = pallas_bvh_ao_occlusion(sc, P, b0, b1, b2, hit, key, 8, 8)
        col = pallas_bvh_ao_sky(sc, P, b0, b1, b2, hit, key, 8, 8, UnitSky())
        expect = (64.0 - np.asarray(occ)) * np.asarray(hit)
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(col)[:, c], expect)
