"""Scene loader tests on generated scenes: counts, materials, camera parity."""
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import scene_path
from raytracingrenderer_tpu.core.vec import V3
from raytracingrenderer_tpu.scene import camera as cam_mod
from raytracingrenderer_tpu.scene.loader import load_scene
from raytracingrenderer_tpu.scene.types import (MAT_CONDUCTOR, MAT_DIFFUSE,
                                                MAT_GLASS, MAT_PLASTIC)


@pytest.fixture(scope="module")
def cornell():
    return load_scene(scene_path("cornell"))


class TestCornell:
    def test_counts(self, cornell):
        assert cornell.triangles.count == 36       # SURVEY §2.8
        assert cornell.materials.count == 8
        assert cornell.num_lights == 2             # light quad = 2 tris
        assert cornell.camera.width == 1024

    def test_light_table(self, cornell):
        le = np.asarray(cornell.lights.le.stacked())
        np.testing.assert_allclose(le, [[17, 12, 4]] * 2)
        assert np.asarray(cornell.lights.area).sum() == pytest.approx(
            0.1786, abs=1e-3)

    def test_gn_agrees_with_vertex_normals(self, cornell):
        t = cornell.triangles
        dot = np.asarray(t.gn.dot(t.n0))
        assert (dot >= 0).all()  # Triangle::gNormal canonicalization

    def test_materials_all_diffuse(self, cornell):
        assert (np.asarray(cornell.materials.mtype) == MAT_DIFFUSE).all()
        alb = np.asarray(cornell.materials.albedo.stacked())
        # wall colours from the constant PNGs
        assert np.isclose(alb, [0.7215686, 0.7098039, 0.6784314],
                          atol=1e-3).all(axis=1).any()
        assert np.isclose(alb, [0.63, 0.065, 0.05], atol=0.01).all(
            axis=1).any()  # red wall

    def test_camera_ray_center_hits_scene(self, cornell):
        o, d = cam_mod.generate_rays(
            cornell.camera, jnp.asarray([512.0]), jnp.asarray([512.0]))
        # camera at (0,1,6.8) looking toward -z
        assert float(o.z[0]) == pytest.approx(6.8)
        assert float(d.z[0]) < -0.99

    def test_project_roundtrip(self, cornell):
        cam = cornell.camera
        px = jnp.asarray([100.5, 512.0, 900.0])
        py = jnp.asarray([200.5, 512.0, 100.0])
        o, d = cam_mod.generate_rays(cam, px, py)
        p = o + d * 3.0
        x, y, ok = cam_mod.project_onto_camera(cam, p)
        assert np.asarray(ok).all()
        np.testing.assert_allclose(np.asarray(x), np.asarray(px), atol=0.1)
        np.testing.assert_allclose(np.asarray(y), np.asarray(py), atol=0.1)

    def test_point_behind_camera_invalid(self, cornell):
        p = V3(jnp.asarray([0.0]), jnp.asarray([1.0]), jnp.asarray([20.0]))
        _, _, ok = cam_mod.project_onto_camera(cornell.camera, p)
        assert not bool(ok[0])


class TestInterior:
    def test_small_variant(self):
        sc = load_scene(scene_path("interior"))
        assert 2000 < sc.triangles.count < 5000
        mt = set(np.asarray(sc.materials.mtype).tolist())
        assert {MAT_DIFFUSE, MAT_CONDUCTOR, MAT_PLASTIC} <= mt
        assert 2 <= sc.num_lights // 2 <= 4          # 2-tri rectangles
        assert sc.bvh is not None and sc.bvh.depth >= 2

    def test_full_scale(self, tmp_path):
        """The chip's scene: >= 300k triangles after flattening, ~850
        instances, every material class but Oren-Nayar/mirror."""
        from raytracingrenderer_tpu.scene import synth
        sc = load_scene(synth.interior(str(tmp_path / "interior")),
                        build_bvh=False)
        assert 300_000 <= sc.triangles.count < 360_000
        assert sc.materials.count > 800
        mt = set(np.asarray(sc.materials.mtype).tolist())
        assert {MAT_DIFFUSE, MAT_CONDUCTOR, MAT_GLASS, MAT_PLASTIC} <= mt
        assert sc.num_lights == 6
        assert (sc.camera.width, sc.camera.height) == (1920, 1080)

    def test_same_seed_same_files(self, tmp_path):
        import filecmp
        import os
        from raytracingrenderer_tpu.scene import synth
        a = synth.interior(str(tmp_path / "a"), triangles=3000, seed=4)
        b = synth.interior(str(tmp_path / "b"), triangles=3000, seed=4)
        c = synth.interior(str(tmp_path / "c"), triangles=3000, seed=5)
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b))
        _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
        assert not mismatch and not errors
        with open(os.path.join(a, "scene.json")) as fa, \
                open(os.path.join(c, "scene.json")) as fc:
            assert fa.read() != fc.read()
