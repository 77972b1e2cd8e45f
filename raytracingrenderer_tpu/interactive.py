"""Interactive render session: fly camera -> film clear -> re-render.

Headless equivalent of the reference's main loop
(RTBase/Main.cpp:74-139): WASD/QE/arrow input moves the
`viewcamera` and clears the accumulated film (rt.clear()), each idle
tick adds one progressive spp, P saves HDR and L saves PNG.  The D3D11
window is replaced by PNG previews; keys arrive either scripted (CLI
`-keys w,a,left`) or line-by-line on stdin (`-interactive`).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import jax
import numpy as np

from .config import RenderConfig
from .imaging import film as film_mod
from .render import render, specialize_config
from .scene.controls import FlyCamera
from .scene.types import Scene
from .utils.log import get_logger

MOVE_KEYS = frozenset("wsadqe") | {"left", "right"}


def fly_camera_for(scene: Scene, scene_dir: str) -> FlyCamera:
    """Build the fly camera from the scene.json from/to/up spec (the
    reference seeds RTCamera the same way, SceneLoader.h:268-276)."""
    with open(os.path.join(scene_dir, "scene.json")) as f:
        desc = json.load(f)

    def vec(key, default):
        v = desc.get(key)
        if v is None:
            return np.asarray(default, np.float64)
        return np.asarray([float(p) for p in str(v).split()[:3]],
                          np.float64)

    cam = scene.camera
    return FlyCamera(vec("from", (0, 0, 0)), vec("to", (0, 0, 1)),
                     vec("up", (0, 1, 0)), np.asarray(cam.p),
                     cam.width, cam.height)


class InteractiveSession:
    """Camera moves clear the film; steps accumulate progressive spp."""

    def __init__(self, scene: Scene, scene_dir: str,
                 cfg: Optional[RenderConfig] = None):
        self.cfg = specialize_config(cfg or RenderConfig(), scene)
        self.fly = fly_camera_for(scene, scene_dir)
        self.scene = scene._replace(camera=self.fly.camera())
        self.film = film_mod.new_film(self.fly.height, self.fly.width)
        self.log = get_logger("interactive")
        self.running = True
        self.saves = []

    @property
    def spp(self) -> int:
        return int(self.film.spp)

    def key(self, k: str, output: str = "out") -> None:
        """One input event (reference Main.cpp:84-131)."""
        k = k.strip().lower()
        if k in MOVE_KEYS:
            self.fly.key(k)
            self.scene = self.scene._replace(camera=self.fly.camera())
            # camera moved -> restart accumulation (rt.clear())
            self.film = film_mod.new_film(self.fly.height, self.fly.width)
        elif k == "p":
            from .io.hdr import write_hdr
            path = f"{output}.hdr"
            write_hdr(path, np.asarray(film_mod.to_hdr(self.film)))
            self.saves.append(path)
            self.log.info("saved %s (%d spp)", path, self.spp)
        elif k == "l":
            from .io.png import write_png
            path = f"{output}.png"
            write_png(path, np.asarray(film_mod.tonemap(self.film)))
            self.saves.append(path)
            self.log.info("saved %s (%d spp)", path, self.spp)
        elif k in ("esc", "escape", "quit"):
            self.running = False

    def step(self, spp: int = 1) -> film_mod.Film:
        """Accumulate `spp` more progressive samples at the current
        camera (one per idle frame in the reference)."""
        self.film = render(self.scene, self.cfg, spp=spp, film=self.film)
        return self.film


def run_scripted(scene: Scene, scene_dir: str, cfg: RenderConfig,
                 keys: str, spp_per_tick: int = 1,
                 output: str = "out") -> InteractiveSession:
    """Scripted session: render a tick, apply a key, repeat."""
    s = InteractiveSession(scene, scene_dir, cfg)
    s.step(spp_per_tick)
    for k in keys.split(","):
        if not s.running:
            break
        s.key(k, output=output)
        if s.running and k.strip().lower() in MOVE_KEYS:
            s.step(spp_per_tick)
    return s


def run_stdin(scene: Scene, scene_dir: str, cfg: RenderConfig,
              output: str = "out") -> InteractiveSession:
    """Line-oriented interactive loop: each line is a key (w/s/a/d/q/e/
    left/right/p/l/esc); empty line = render one more spp."""
    import sys
    s = InteractiveSession(scene, scene_dir, cfg)
    s.step(1)
    s.log.info("interactive: keys w/s/a/d/q/e/left/right, p=save hdr, "
               "l=save png, esc=quit, empty=+1 spp")
    for line in sys.stdin:
        if not s.running:
            break
        k = line.strip()
        if k:
            s.key(k, output=output)
        if s.running:
            s.step(1)
            s.log.info("spp %d", s.spp)
    return s
