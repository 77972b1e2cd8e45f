"""CLI end-to-end: flag-compatible entry point (reference Main.cpp
CLI: -scene/-outputFilename/-SPP) plus the profiling report wiring."""
import logging
import os

import numpy as np

from conftest import scene_path
from raytracingrenderer_tpu.cli import main
from raytracingrenderer_tpu.io.hdr import read_hdr


class TestCli:
    def test_render_writes_hdr_with_profile(self, tmp_path, caplog):
        out = str(tmp_path / "out.hdr")
        rc = main(["-scene", scene_path("cornell"), "-outputFilename",
                   out, "-SPP", "2", "-maxDepth", "2", "-width", "32",
                   "-height", "32", "-profile"])
        assert rc == 0
        img = read_hdr(out)
        assert img.shape == (32, 32, 3)
        assert np.isfinite(img).all() and img.mean() > 0.01

    def test_checkpoint_resume_cli(self, tmp_path):
        out = str(tmp_path / "o.hdr")
        ck = str(tmp_path / "f.npz")
        assert main(["-scene", scene_path("cornell"), "-outputFilename",
                     out, "-SPP", "2", "-maxDepth", "2", "-width", "16",
                     "-height", "16", "-checkpoint", ck]) == 0
        assert os.path.exists(ck)
        # resume adds more spp on top of the checkpoint
        assert main(["-scene", scene_path("cornell"), "-outputFilename",
                     out, "-SPP", "2", "-maxDepth", "2", "-width", "16",
                     "-height", "16", "-checkpoint", ck]) == 0
