import numpy as np
import jax

from conftest import scene_path
from raytracingrenderer_tpu.config import RenderConfig
from raytracingrenderer_tpu.interactive import InteractiveSession, run_scripted
from raytracingrenderer_tpu.scene.loader import load_scene
from raytracingrenderer_tpu.scene.types import Camera


class TestInteractive:
    """Reference main-loop parity (Main.cpp:74-139): movement clears the
    film and the render re-converges from the new camera; P/L save."""

    def _scene(self):
        sc = load_scene(scene_path("cornell"))
        c = sc.camera
        return sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                         c.world_to_cam, 32, 32, c.origin,
                                         c.a_film))

    def test_move_clears_and_reconverges(self):
        cfg = RenderConfig(max_depth=2, mis=True, jitter=True)
        s = InteractiveSession(self._scene(), scene_path("cornell"), cfg)
        s.step(2)
        assert s.spp == 2
        img_before = np.asarray(s.film.buffer).copy()
        s.key("w")                     # move -> rt.clear()
        assert s.spp == 0
        assert float(np.abs(np.asarray(s.film.buffer)).sum()) == 0.0
        s.step(2)
        assert s.spp == 2
        img_after = np.asarray(s.film.buffer)
        # camera moved: the re-converged image differs
        assert not np.allclose(img_before, img_after)
        assert np.isfinite(img_after).all() and img_after.mean() > 0

    def test_yaw_changes_view(self):
        cfg = RenderConfig(max_depth=2, mis=True, jitter=False)
        s = InteractiveSession(self._scene(), scene_path("cornell"), cfg)
        s.step(1)
        a = np.asarray(s.film.buffer).copy()
        s.key("left")
        s.step(1)
        b = np.asarray(s.film.buffer)
        assert not np.allclose(a, b)

    def test_scripted_session_saves(self, tmp_path):
        cfg = RenderConfig(max_depth=2, mis=True, jitter=True)
        out = str(tmp_path / "shot")
        s = run_scripted(self._scene(), scene_path("cornell"), cfg,
                         keys="w,p,l,esc", output=out)
        assert not s.running               # esc quit
        assert (tmp_path / "shot.hdr").exists()
        assert (tmp_path / "shot.png").exists()
        from raytracingrenderer_tpu.io.hdr import read_hdr
        img = read_hdr(str(tmp_path / "shot.hdr"))
        assert np.isfinite(img).all()
