"""I/O tests (HDR, PNG, GEM) on generated scene assets."""
import numpy as np
import pytest

from conftest import scene_path
from raytracingrenderer_tpu.io.hdr import read_hdr, write_hdr
from raytracingrenderer_tpu.io.png import read_png_float, write_png, read_png
from raytracingrenderer_tpu.scene.gem import load_gem


class TestHdr:
    def test_read_envmap(self):
        img = read_hdr(scene_path("cornell-env", "sky.hdr"))
        assert img.shape == (64, 128, 3)
        assert img.dtype == np.float32
        assert img.max() > 10.0  # the sun survives RGBE

    def test_roundtrip_exact(self, tmp_path):
        # an RGBE-representable image (decoded once) round-trips exactly
        img = read_hdr(scene_path("cornell-env", "sky.hdr"))
        p = str(tmp_path / "x.hdr")
        write_hdr(p, img)
        np.testing.assert_array_equal(read_hdr(p), img)

    def test_roundtrip_synthetic(self, tmp_path):
        rng = np.random.default_rng(0)
        img = (rng.random((17, 33, 3)) * 100).astype(np.float32)
        p = str(tmp_path / "y.hdr")
        write_hdr(p, img)
        got = read_hdr(p)
        # RGBE quantizes all three channels on the max channel's exponent
        # with a truncating 8-bit mantissa in [128,256): worst-case error
        # is maxchannel/128 per pixel, not a per-channel rtol.
        bound = img.max(axis=-1, keepdims=True) / 128.0 + 1e-4
        assert (np.abs(got - img) <= bound).all()


class TestPng:
    def test_constant_color_textures(self):
        p = read_png_float(scene_path("cornell", "0.725_0.71_0.68_1.0.png"))
        np.testing.assert_allclose(p[..., :3].reshape(-1, 3).mean(0),
                                   [0.7215686, 0.7098039, 0.6784314],
                                   atol=1e-3)
        assert p[..., :3].std(axis=(0, 1)).max() < 1e-6  # spatially const

    def test_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 256, (20, 31, 3), dtype=np.uint8)
        p = str(tmp_path / "x.png")
        write_png(p, img)
        np.testing.assert_array_equal(read_png(p), img)


class TestGem:
    def test_cornell_box_counts(self):
        # SURVEY §2.8: cornell-box totals 36 triangles
        # (5 rect walls*2 + light rect*2 + 2 cubes*12)
        rect = load_gem(scene_path("cornell", "Rectangle.gem"))
        cube = load_gem(scene_path("cornell", "Cube.gem"))
        assert sum(len(m.indices) // 3 for m in rect) == 2
        assert sum(len(m.indices) // 3 for m in cube) == 12

    def test_vertex_attributes(self):
        m = load_gem(scene_path("cornell", "Rectangle.gem"))[0]
        assert m.positions.shape == (6, 3)
        assert m.normals.shape == (6, 3)
        assert m.uvs.shape == (6, 2)
        # unit rectangle in xy plane
        np.testing.assert_allclose(np.abs(m.positions[:, :2]).max(), 1.0)
        np.testing.assert_allclose(
            np.linalg.norm(m.normals, axis=1), 1.0, atol=1e-5)

    def test_interior_counts(self):
        # the loader's flattened count is the sum over instances of each
        # instance's mesh
        import json
        with open(scene_path("interior", "scene.json")) as f:
            desc = json.load(f)
        total = 0
        for inst in desc["instances"]:
            for m in load_gem(scene_path("interior", inst["filename"])):
                total += len(m.indices) // 3
        assert 2000 < total < 5000
