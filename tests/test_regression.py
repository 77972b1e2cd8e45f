"""Image regression against the independent numpy path tracer.

`tests/oracle_pt.py` shares no code with the renderer; on the generated
cornell box (diffuse walls, one area light) both estimate the same
radiance, so their images must agree up to Monte-Carlo noise.
"""
import numpy as np
import pytest

from conftest import scene_path
from oracle_pt import render_mean
from raytracingrenderer_tpu.config import RenderConfig
from raytracingrenderer_tpu.imaging import film as film_mod
from raytracingrenderer_tpu.render import render
from raytracingrenderer_tpu.scene.loader import load_scene
from raytracingrenderer_tpu.scene.types import Camera


def _at(sc, res):
    c = sc.camera
    return sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                     c.world_to_cam, res, res, c.origin,
                                     c.a_film))


class TestCornellOracle:
    @pytest.fixture(scope="class")
    def images(self):
        sc = _at(load_scene(scene_path("cornell")), 32)
        # the oracle's estimator: NEE without MIS, pixel centres
        cfg = RenderConfig(mis=False, jitter=False, max_depth=4)
        ours = np.asarray(film_mod.to_hdr(render(sc, cfg, spp=64)))
        oracle = render_mean(sc, spp=64, max_depth=4, seed=0)
        return ours, oracle

    def test_mean_matches_oracle(self, images):
        ours, oracle = images
        assert ours.mean() == pytest.approx(oracle.mean(), rel=0.03)

    def test_image_correlates_with_oracle(self, images):
        ours, oracle = images
        # 4x4 box-downsampled luminance, emitter pixels excluded
        ds = lambda a: a.mean(-1).reshape(8, 4, 8, 4).mean(axis=(1, 3))
        o, r = ds(ours), ds(oracle)
        keep = r < 1.0
        assert np.corrcoef(o[keep], r[keep])[0, 1] > 0.95
