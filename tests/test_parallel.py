"""Multi-device tests on the virtual 8-CPU mesh (SURVEY.md section 4:
distributed logic must be testable without a pod, like the reference's
single-task MPI no-op fallback)."""

import numpy as np
import pytest

import jax


def _tiny_scene(width=64, height=32):
    from lucille_tpu.ri.api import RiState
    from lucille_tpu.rib.parser import parse_rib

    s = RiState()
    parse_rib(
        """
        Display "t.hdr" "file" "rgb"
        PixelSamples 1 1
        Projection "perspective" "fov" [45]
        Orientation "rh"
        ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 -1 -8 1]
        WorldBegin
        PointsPolygons [4] [0 1 2 3] "P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
        PointsPolygons [3] [0 1 2] "P" [-1 0 -1  1 0 -1  0 2 0]
        WorldEnd
        """,
        s,
    )
    s.Format(width, height)
    s.options.gather_nsamples = 4
    return s


class TestMesh:
    def test_eight_devices_available(self):
        assert len(jax.devices()) >= 8

    def test_make_mesh(self):
        from lucille_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(8)
        assert mesh.devices.size == 8

    def test_make_mesh_raises_with_too_few_devices(self):
        """No silent swap to another backend's devices: asking for more
        devices than exist is an error."""
        from lucille_tpu.parallel.mesh import make_mesh

        with pytest.raises(ValueError, match="need 16 devices"):
            make_mesh(16)
        with pytest.raises(ValueError):
            make_mesh(4, devices=jax.devices()[:2])

    def test_sharded_render_matches_single_device(self):
        from lucille_tpu.parallel.mesh import make_mesh, render_frame_sharded

        s = _tiny_scene()
        img8, rays8 = render_frame_sharded(s.scene, make_mesh(8), tile=16)
        img1, rays1 = render_frame_sharded(s.scene, make_mesh(1), tile=16)
        # same tile keys => identical sampling on any mesh size
        np.testing.assert_allclose(img8, img1, atol=1e-6)
        assert rays8 == rays1
        assert img8.shape == (32, 64, 3)
        assert img8.mean() > 0.01

    def test_uneven_tile_count_pads(self):
        # 64x48 with 16px tiles -> 4x3 = 12 tiles over 8 devices (pad to 16)
        from lucille_tpu.parallel.mesh import make_mesh, render_frame_sharded

        s = _tiny_scene(64, 48)
        img, nrays = render_frame_sharded(s.scene, make_mesh(8), tile=16)
        assert img.shape == (48, 64, 3)
        assert nrays > 0


class TestUnifiedRenderer:
    """The mesh path IS the production Renderer: same
    tile kernel, so mesh and no-mesh frames must be bit-identical."""

    def _render(self, method, mesh=None, **render_kwargs):
        from lucille_tpu.parallel.mesh import make_mesh
        from lucille_tpu.render.renderer import Renderer

        s = _tiny_scene()
        s.options.render_method = method
        s.options.max_ray_depth = 2
        r = Renderer(
            s.scene,
            tile_size=16,
            mesh=make_mesh(mesh) if mesh else None,
        )
        img = r.render_frame(**render_kwargs)
        return img, r

    def test_ao_mesh_matches_single(self):
        img0, r0 = self._render("ao")
        img8, r8 = self._render("ao", mesh=8)
        np.testing.assert_array_equal(img0, img8)
        assert r0.stats.nrays == r8.stats.nrays

    def test_pathtrace_mesh_matches_single(self):
        img0, _ = self._render("pathtrace")
        img8, _ = self._render("pathtrace", mesh=8)
        np.testing.assert_array_equal(img0, img8)
        assert img8.mean() > 0.01

    def test_mesh_sizes_agree(self):
        img2, _ = self._render("ao", mesh=2)
        img8, _ = self._render("ao", mesh=8)
        np.testing.assert_array_equal(img2, img8)

    def test_checkpoint_resume_on_mesh(self, tmp_path):
        import os

        ckpt = str(tmp_path / "frame.ckpt.npz")
        # render fully once to have the reference image + a checkpoint
        # file captured mid-frame by aborting via an exception in tile_cb
        img_full, _ = self._render("ao", mesh=8)

        class Stop(Exception):
            pass

        count = [0]

        def bomb(x0, y0, t):
            count[0] += 1
            if count[0] == 3:
                raise Stop()

        with pytest.raises(Stop):
            self._render("ao", mesh=8, tile_cb=bomb, checkpoint=ckpt)
        assert os.path.exists(ckpt)
        img_rec, _ = self._render(
            "ao", mesh=8, checkpoint=ckpt, recover=True
        )
        np.testing.assert_array_equal(img_full, img_rec)
        assert not os.path.exists(ckpt)  # completed frame removes it

    @pytest.mark.parametrize(
        "n_gpus,pid,want", [(4, 5, [1]), (4, 0, [0]), (1, 3, None), (0, 1, None)]
    )
    def test_one_card_per_process(self, monkeypatch, n_gpus, pid, want):
        """Processes sharing a host each claim one card, chosen from the
        process id; a one-card (or CPU) host passes no restriction."""
        from lucille_tpu.parallel import distributed

        seen = {}
        monkeypatch.setattr(distributed, "_local_gpu_count", lambda: n_gpus)
        monkeypatch.setattr(
            jax.distributed, "initialize", lambda **kw: seen.update(kw)
        )
        try:
            assert distributed.initialize_distributed(
                "localhost:1234", 8, pid
            )
        finally:
            distributed._initialized = False
        assert seen.get("local_device_ids") == want
        assert seen["process_id"] == pid and seen["num_processes"] == 8

    def test_visible_gpu_count_from_env(self, monkeypatch):
        from lucille_tpu.parallel import distributed

        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,2, 3")
        assert distributed._local_gpu_count() == 3
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        assert distributed._local_gpu_count() == 0

    def test_distributed_single_process_noop(self):
        from lucille_tpu.parallel.distributed import (
            barrier,
            initialize_distributed,
            is_primary_host,
            process_count,
        )

        assert initialize_distributed() is False
        assert initialize_distributed(num_processes=1) is False
        assert process_count() == 1
        assert is_primary_host()
        barrier()  # no-op, must not hang


class TestDistributedRecover:
    """--recover under multi-process: host 0 reads the checkpoint file and
    broadcasts (image, alpha, done) so every process skips IDENTICAL
    tiles (renderer.py broadcast branch; MPI_Bcast analog parallel.c:150).
    Simulated without a pod by monkeypatching process_count/index and
    capture/replay of broadcast_from_primary."""

    def test_all_processes_skip_same_tiles(self, tmp_path, monkeypatch):
        import os

        from lucille_tpu.render.renderer import Renderer

        ckpt = str(tmp_path / "frame.ckpt.npz")

        def fresh():
            s = _tiny_scene()
            s.options.render_method = "ao"
            return Renderer(s.scene, tile_size=16)

        full = fresh().render_frame()

        # interrupted single-process run -> partial checkpoint on "host 0"
        count = [0]

        def crash(x0, y0, t):
            count[0] += 1
            if count[0] >= 3:
                raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            fresh().render_frame(tile_cb=crash, checkpoint=ckpt)
        ckpt_done = np.load(ckpt)["done"]
        assert 0 < ckpt_done.sum() < ckpt_done.shape[0]

        import lucille_tpu.parallel.distributed as dist

        monkeypatch.setattr(dist, "process_count", lambda: 2)
        captured = []

        # ---- host 0: reads the file, broadcast captures its state
        monkeypatch.setattr(dist, "process_index", lambda: 0)
        monkeypatch.setattr(
            dist, "broadcast_from_primary",
            lambda tree: (captured.append(tree), tree)[1],
        )
        r0 = fresh()
        img0 = r0.render_frame(checkpoint=ckpt, recover=True)
        assert len(captured) == 1
        np.testing.assert_array_equal(
            captured[0][2].astype(bool), ckpt_done
        )
        np.testing.assert_allclose(img0, full, atol=1e-6)

        # ---- host 1: NO local checkpoint file (separate filesystem);
        # replayed broadcast supplies host-0's recovery state
        monkeypatch.setattr(dist, "process_index", lambda: 1)
        monkeypatch.setattr(
            dist, "broadcast_from_primary", lambda tree: captured[0]
        )
        r1 = fresh()
        img1 = r1.render_frame(
            checkpoint=str(tmp_path / "host1-local.npz"), recover=True
        )
        np.testing.assert_allclose(img1, full, atol=1e-6)
        # identical skip set => identical work: both computed only the
        # not-done tiles, so the traced-ray counters agree exactly
        assert r0.stats.nrays == r1.stats.nrays
        assert not os.path.exists(str(tmp_path / "host1-local.npz"))


class TestGraftEntry:
    def test_entry_compiles(self):
        import __graft_entry__ as g

        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert out[0].shape == (1024, 3)

    def test_dryrun_multichip(self, capsys):
        import __graft_entry__ as g

        g.dryrun_multichip(8)
        out = capsys.readouterr().out
        assert "dryrun_multichip [ao] OK" in out
        assert "dryrun_multichip [pathtrace] OK" in out
