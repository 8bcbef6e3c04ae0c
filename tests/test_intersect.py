"""Intersection core tests: Moller-Trumbore, BVH build invariants, and
BVH-vs-bruteforce parity (the brute-force path is the oracle)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lucille_tpu.accel.bvh import build_bvh

AO_SCENE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scenes", "ao_objects.rib",
)


def _random_soup(n, seed=0, spread=5.0, size=0.3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3))
    v0 = c + rng.normal(0, size, (n, 3))
    v1 = c + rng.normal(0, size, (n, 3))
    v2 = c + rng.normal(0, size, (n, 3))
    return v0, v1, v2


def _scene_from_tris(v0, v1, v2, accel):
    from lucille_tpu.ri.types import AttributeState, GeomData, SceneDescription
    from lucille_tpu.scene.compile import compile_scene

    n = len(v0)
    pos = np.concatenate([v0, v1, v2])
    idx = np.stack(
        [np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], axis=-1
    ).astype(np.int32)
    desc = SceneDescription()
    desc.geoms.append(GeomData(positions=pos, indices=idx, attrs=AttributeState()))
    desc.options.accel_method = accel  # scene carries the dispatch tag
    return compile_scene(desc, build_bvh=(accel == "bvh")).device_put()


class TestBVHBuild:
    def test_invariants(self):
        v0, v1, v2 = _random_soup(300)
        b = build_bvh(v0, v1, v2, leaf_size=8)
        m = len(b.skip)
        assert sorted(b.order.tolist()) == list(range(300))
        leaf = b.count > 0
        assert b.count[leaf].max() <= 8
        assert b.count[leaf].sum() == 300
        # skip-link walk covers every node exactly once
        i, visited = 0, 0
        while i < m:
            visited += 1
            i = i + 1 if b.count[i] == 0 else int(b.skip[i])
        assert visited == m
        # leaves tile [0, N) contiguously in DFS order
        spans = sorted(
            (int(f), int(f + c)) for f, c in zip(b.first[leaf], b.count[leaf])
        )
        pos = 0
        for a, e in spans:
            assert a == pos
            pos = e
        assert pos == 300

    def test_parent_contains_children(self):
        v0, v1, v2 = _random_soup(200, seed=3)
        b = build_bvh(v0, v1, v2)
        for i in range(len(b.skip)):
            if b.count[i] == 0:
                left = i + 1
                right = int(b.skip[left])
                for ch in (left, right):
                    assert (b.bbmin[i] <= b.bbmin[ch] + 1e-4).all()
                    assert (b.bbmax[i] >= b.bbmax[ch] - 1e-4).all()

    def test_single_triangle(self):
        v0, v1, v2 = _random_soup(1)
        b = build_bvh(v0, v1, v2)
        assert len(b.skip) == 1
        assert b.count[0] == 1


class TestParity:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_closest_hit_bvh_matches_bruteforce(self, seed):
        """The tile-BVH packet walk (interpret mode on the CPU) against
        the brute-force oracle."""
        from lucille_tpu.accel import brute_closest_hit
        from lucille_tpu.accel.pallas_bvh import (
            pallas_bvh_closest_hit as bvh_closest_hit,
        )

        v0, v1, v2 = _random_soup(400, seed=seed)
        sc_bvh = _scene_from_tris(v0, v1, v2, "bvh")
        sc_bf = _scene_from_tris(v0, v1, v2, "bruteforce")

        rng = np.random.default_rng(seed + 10)
        B = 512
        org = jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32)
        d = rng.normal(size=(B, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dirn = jnp.asarray(d, jnp.float32)

        r1 = brute_closest_hit(sc_bf, org, dirn)
        r2 = bvh_closest_hit(sc_bvh, org, dirn)
        h1 = np.asarray(r1["hit"])
        h2 = np.asarray(r2["hit"])
        np.testing.assert_array_equal(h1, h2)
        np.testing.assert_allclose(
            np.asarray(r1["t"])[h1], np.asarray(r2["t"])[h2], rtol=1e-4
        )

    @pytest.mark.parametrize("seed", [0, 5])
    def test_mxu_matmul_matches_bruteforce(self, seed):
        """The matmul formulation is algebraically identical to direct
        Moller-Trumbore; verify hits, t, u/v and triangle ids."""
        from lucille_tpu.accel.bruteforce import brute_closest_hit
        from lucille_tpu.accel.mxu import mxu_any_hit, mxu_closest_hit
        from lucille_tpu.accel.bruteforce import brute_any_hit

        v0, v1, v2 = _random_soup(300, seed=seed)
        sc = _scene_from_tris(v0, v1, v2, "bruteforce")
        rng = np.random.default_rng(seed + 20)
        B = 512
        org = jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32)
        d = rng.normal(size=(B, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dirn = jnp.asarray(d, jnp.float32)
        r1 = brute_closest_hit(sc, org, dirn)
        r2 = mxu_closest_hit(sc, org, dirn)
        h = np.asarray(r1["hit"])
        np.testing.assert_array_equal(h, np.asarray(r2["hit"]))
        np.testing.assert_allclose(
            np.asarray(r1["t"])[h], np.asarray(r2["t"])[h], rtol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(r1["u"])[h], np.asarray(r2["u"])[h], atol=1e-4
        )
        o1 = np.asarray(brute_any_hit(sc, org, dirn))
        o2 = np.asarray(mxu_any_hit(sc, org, dirn))
        np.testing.assert_array_equal(o1, o2)

    def test_any_hit_parity(self):
        from lucille_tpu.accel import brute_any_hit
        from lucille_tpu.accel.pallas_bvh import (
            pallas_bvh_any_hit as bvh_any_hit,
        )

        v0, v1, v2 = _random_soup(300, seed=7)
        sc_bvh = _scene_from_tris(v0, v1, v2, "bvh")
        sc_bf = _scene_from_tris(v0, v1, v2, "bruteforce")
        rng = np.random.default_rng(42)
        B = 512
        org = jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32)
        d = rng.normal(size=(B, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dirn = jnp.asarray(d, jnp.float32)
        o1 = np.asarray(brute_any_hit(sc_bf, org, dirn))
        o2 = np.asarray(bvh_any_hit(sc_bvh, org, dirn))
        np.testing.assert_array_equal(o1, o2)

    def test_tmax_respected(self):
        from lucille_tpu.accel import brute_any_hit

        # one triangle at z=5, ray from origin down +z
        v0 = np.array([[-1.0, -1.0, 5.0]])
        v1 = np.array([[1.0, -1.0, 5.0]])
        v2 = np.array([[0.0, 1.0, 5.0]])
        sc = _scene_from_tris(v0, v1, v2, "bruteforce")
        org = jnp.zeros((1, 3), jnp.float32)
        dirn = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
        assert bool(brute_any_hit(sc, org, dirn)[0])
        assert not bool(brute_any_hit(sc, org, dirn, tmax=4.0)[0])

    def test_known_hit_distance(self):
        from lucille_tpu.accel import brute_closest_hit

        v0 = np.array([[-1.0, -1.0, 3.0]])
        v1 = np.array([[1.0, -1.0, 3.0]])
        v2 = np.array([[0.0, 2.0, 3.0]])
        sc = _scene_from_tris(v0, v1, v2, "bruteforce")
        org = jnp.zeros((1, 3), jnp.float32)
        dirn = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
        r = brute_closest_hit(sc, org, dirn)
        assert bool(r["hit"][0])
        assert float(r["t"][0]) == pytest.approx(3.0, rel=1e-5)


class TestReferenceScene:
    def test_ao_scene_parity(self):
        from lucille_tpu.accel import brute_closest_hit
        from lucille_tpu.accel.pallas_bvh import (
            pallas_bvh_closest_hit as bvh_closest_hit,
        )
        from lucille_tpu.ri.api import RiState
        from lucille_tpu.rib.parser import parse_rib_file
        from lucille_tpu.scene.compile import compile_scene

        s = RiState()
        parse_rib_file(AO_SCENE, s)
        s.scene.options.accel_method = "bvh"
        sc_bvh = compile_scene(s.scene).device_put()
        s.scene.options.accel_method = "bruteforce"
        sc_bf = compile_scene(s.scene).device_put()
        xs, ys = np.meshgrid(np.linspace(0, 640, 32), np.linspace(0, 480, 24))
        org, dirn = s.camera.generate_rays(
            jnp.asarray(xs.ravel(), jnp.float32), jnp.asarray(ys.ravel(), jnp.float32)
        )
        r1 = brute_closest_hit(sc_bf, org, dirn)
        r2 = bvh_closest_hit(sc_bvh, org, dirn)
        np.testing.assert_array_equal(np.asarray(r1["hit"]), np.asarray(r2["hit"]))
        h = np.asarray(r1["hit"])
        assert 0.2 < h.mean() < 0.7  # scene is framed
        np.testing.assert_allclose(
            np.asarray(r1["t"])[h], np.asarray(r2["t"])[h], rtol=1e-4
        )


class TestPallasKernel:
    def test_interpret_mode_parity(self):
        """Dense closest-hit kernel vs the brute-force oracle (interpret
        mode on the CPU; on the GPU the same kernel compiles through
        Triton and chip_smoke.py checks it at full width)."""
        from lucille_tpu.accel.bruteforce import brute_closest_hit
        from lucille_tpu.accel.pallas_isect import RAY_BLOCK, pallas_closest_hit

        v0, v1, v2 = _random_soup(300, seed=2)
        sc = _scene_from_tris(v0, v1, v2, "bruteforce")
        rng = np.random.default_rng(31)
        B = RAY_BLOCK * 2
        org = jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32)
        d = rng.normal(size=(B, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dirn = jnp.asarray(d, jnp.float32)
        r1 = brute_closest_hit(sc, org, dirn)
        r2 = pallas_closest_hit(sc, org, dirn)
        h = np.asarray(r1["hit"])
        np.testing.assert_array_equal(h, np.asarray(r2["hit"]))
        np.testing.assert_allclose(
            np.asarray(r1["t"])[h], np.asarray(r2["t"])[h], rtol=1e-4
        )


def _rays(B, seed, spread=8.0):
    rng = np.random.default_rng(seed)
    org = jnp.asarray(rng.uniform(-spread, spread, (B, 3)), jnp.float32)
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, jnp.asarray(d, jnp.float32)


@pytest.fixture(params=[(32, 8), (64, 32), (128, 16)], ids=lambda p: f"rb{p[0]}-tc{p[1]}")
def dense_shape(request, monkeypatch):
    """Run a test at several (rays per program, triangles per tile): the
    constants are read when the kernel is traced, so compiled traces of
    other shapes are dropped."""
    from lucille_tpu.accel import pallas_isect

    rb, tc = request.param
    monkeypatch.setattr(pallas_isect, "RAY_BLOCK", rb)
    monkeypatch.setattr(pallas_isect, "TC", tc)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


class TestDenseKernels:
    """The dense Triton kernels against brute force across block shapes,
    ragged wavefronts, triangle counts that are not a tile multiple, t
    windows and live-lane compaction."""

    def test_closest_matches_bruteforce(self, dense_shape):
        from lucille_tpu.accel.bruteforce import brute_closest_hit
        from lucille_tpu.accel.pallas_isect import pallas_closest_hit

        v0, v1, v2 = _random_soup(203, seed=60)  # not a tile multiple
        sc = _scene_from_tris(v0, v1, v2, "pallas")
        org, dirn = _rays(301, seed=61)  # not a block multiple
        r1 = brute_closest_hit(sc, org, dirn)
        r2 = pallas_closest_hit(sc, org, dirn)
        h = np.asarray(r1["hit"])
        assert h.any()
        np.testing.assert_array_equal(h, np.asarray(r2["hit"]))
        np.testing.assert_array_equal(
            np.asarray(r1["tri"])[h], np.asarray(r2["tri"])[h]
        )
        np.testing.assert_allclose(
            np.asarray(r1["t"])[h], np.asarray(r2["t"])[h], rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(r1["u"])[h], np.asarray(r2["u"])[h], atol=1e-5
        )

    def test_any_hit_matches_bruteforce(self, dense_shape):
        from lucille_tpu.accel.bruteforce import brute_any_hit
        from lucille_tpu.accel.pallas_isect import pallas_any_hit

        v0, v1, v2 = _random_soup(203, seed=62)
        sc = _scene_from_tris(v0, v1, v2, "pallas")
        org, dirn = _rays(301, seed=63)
        tmax = jnp.asarray(np.random.default_rng(64).uniform(1, 12, 301),
                           jnp.float32)
        for tm in (None, tmax):
            np.testing.assert_array_equal(
                np.asarray(brute_any_hit(sc, org, dirn, tmax=tm)),
                np.asarray(pallas_any_hit(sc, org, dirn, tmax=tm)),
            )

    def test_t_window(self):
        """tmin and tmax select the triangle at t=5 over the one at t=2."""
        from lucille_tpu.accel.pallas_isect import (
            pallas_any_hit,
            pallas_closest_hit,
        )

        v0 = np.array([[-1.0, -1.0, 5.0], [-1.0, -1.0, 2.0]])
        v1 = np.array([[1.0, -1.0, 5.0], [1.0, -1.0, 2.0]])
        v2 = np.array([[0.0, 1.0, 5.0], [0.0, 1.0, 2.0]])
        sc = _scene_from_tris(v0, v1, v2, "pallas")
        org = jnp.zeros((1, 3), jnp.float32)
        dirn = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
        assert float(pallas_closest_hit(sc, org, dirn)["t"][0]) == pytest.approx(2.0)
        r = pallas_closest_hit(sc, org, dirn, tmin=3.0)
        assert float(r["t"][0]) == pytest.approx(5.0)
        assert not bool(pallas_closest_hit(sc, org, dirn, tmax=1.5)["hit"][0])
        assert not bool(pallas_any_hit(sc, org, dirn, tmax=1.5)[0])
        assert bool(pallas_any_hit(sc, org, dirn, tmin=3.0, tmax=6.0)[0])
        assert not bool(pallas_any_hit(sc, org, dirn, tmin=3.0, tmax=4.0)[0])

    def test_compacted_live_lanes_match(self):
        """With an active mask (enough tiles for compaction to engage),
        live lanes get exactly the uncompacted answers."""
        from lucille_tpu.accel.pallas_isect import (
            COMPACT_MIN_TILES,
            TC,
            pallas_any_hit,
            pallas_closest_hit,
        )

        v0, v1, v2 = _random_soup(TC * COMPACT_MIN_TILES + 7, seed=65)
        sc = _scene_from_tris(v0, v1, v2, "pallas")
        org, dirn = _rays(333, seed=66)
        live = np.random.default_rng(67).random(333) < 0.3
        full = pallas_closest_hit(sc, org, dirn)
        comp = pallas_closest_hit(sc, org, dirn, active=jnp.asarray(live))
        np.testing.assert_array_equal(
            np.asarray(full["hit"])[live], np.asarray(comp["hit"])[live]
        )
        np.testing.assert_array_equal(
            np.asarray(full["tri"])[live], np.asarray(comp["tri"])[live]
        )
        occ_full = np.asarray(pallas_any_hit(sc, org, dirn))
        occ_comp = np.asarray(
            pallas_any_hit(sc, org, dirn, active=jnp.asarray(live))
        )
        np.testing.assert_array_equal(occ_full[live], occ_comp[live])

    def test_empty_scene_never_hits(self):
        from lucille_tpu.accel.pallas_isect import (
            pallas_any_hit,
            pallas_closest_hit,
        )
        from lucille_tpu.ri.types import SceneDescription
        from lucille_tpu.scene.compile import compile_scene

        desc = SceneDescription()
        desc.options.accel_method = "pallas"
        sc = compile_scene(desc).device_put()
        assert sc.n_tris == 0 and sc.accel == "pallas"
        org, dirn = _rays(70, seed=68)
        assert not np.asarray(pallas_closest_hit(sc, org, dirn)["hit"]).any()
        assert not np.asarray(pallas_any_hit(sc, org, dirn)).any()


class TestUniformGrid:
    """The working grid accelerator (the reference's ri_ugrid_intersect is
    a stub returning 0, ugrid.c:376-385 — so brute force is the oracle)."""

    def test_build_covers_all_triangles(self):
        from lucille_tpu.accel.ugrid import build_ugrid

        v0, v1, v2 = _random_soup(200, seed=11)
        g = build_ugrid(v0, v1, v2)
        assert g.cell_start[-1] == len(g.tri_idx)
        assert set(np.unique(g.tri_idx)) == set(range(200))
        # offsets are monotone (valid CSR)
        assert (np.diff(g.cell_start) >= 0).all()

    @pytest.mark.parametrize("seed", [0, 3])
    def test_closest_hit_matches_bruteforce(self, seed):
        from lucille_tpu.accel.bruteforce import brute_closest_hit
        from lucille_tpu.accel.dispatch import closest_hit

        v0, v1, v2 = _random_soup(300, seed=seed)
        sc_g = _scene_from_tris(v0, v1, v2, "grid")
        assert sc_g.accel == "ugrid" and sc_g.grid_res > 0
        sc_bf = _scene_from_tris(v0, v1, v2, "bruteforce")

        rng = np.random.default_rng(seed + 20)
        B = 512
        org = jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32)
        d = rng.normal(size=(B, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dirn = jnp.asarray(d, jnp.float32)

        r1 = brute_closest_hit(sc_bf, org, dirn)
        r2 = closest_hit(sc_g, org, dirn)
        h1 = np.asarray(r1["hit"])
        h2 = np.asarray(r2["hit"])
        np.testing.assert_array_equal(h1, h2)
        np.testing.assert_allclose(
            np.asarray(r1["t"])[h1], np.asarray(r2["t"])[h2], rtol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(r1["tri"])[h1], np.asarray(r2["tri"])[h2]
        )
        assert int(r2["ntrav"]) > 0  # grid actually walked cells

    def test_any_hit_and_tmax(self):
        from lucille_tpu.accel.bruteforce import brute_any_hit
        from lucille_tpu.accel.dispatch import any_hit

        v0, v1, v2 = _random_soup(250, seed=5)
        sc_g = _scene_from_tris(v0, v1, v2, "grid")
        sc_bf = _scene_from_tris(v0, v1, v2, "bruteforce")
        rng = np.random.default_rng(6)
        B = 512
        org = jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32)
        d = rng.normal(size=(B, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dirn = jnp.asarray(d, jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(brute_any_hit(sc_bf, org, dirn)),
            np.asarray(any_hit(sc_g, org, dirn)),
        )
        tmax = jnp.full((B,), 3.0)
        np.testing.assert_array_equal(
            np.asarray(brute_any_hit(sc_bf, org, dirn, tmax=tmax)),
            np.asarray(any_hit(sc_g, org, dirn, tmax=tmax)),
        )

    def test_render_with_grid_option(self):
        """RIB Option "raytrace" "accel_method" ["grid"] end-to-end."""
        from lucille_tpu.rib.parser import parse_rib
        from lucille_tpu.ri.api import RiState
        from lucille_tpu.render.renderer import Renderer

        state = RiState()
        parse_rib(
            """
            Display "g.hdr" "file" "rgb"
            Format 32 24 1
            PixelSamples 1 1
            Option "raytrace" "accel_method" ["grid"]
            Projection "perspective" "fov" [45]
            Orientation "rh"
            ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 -1 -6 1]
            WorldBegin
            PointsPolygons [4] [0 1 2 3] "P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
            PointsPolygons [3] [0 1 2] "P" [-1 0 -1  1 0 -1  0 2 0]
            WorldEnd
            """,
            state,
        )
        r = Renderer(state.scene, tile_size=16)
        assert r.scene.accel == "ugrid"
        img = r.render_frame()
        assert img.shape == (24, 32, 3)
        assert float(img.max()) > 0.0
