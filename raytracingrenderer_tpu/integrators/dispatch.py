"""Integrator dispatch: name -> progressive render loop.

The reference switches integrators by (un)commenting lines in
RayTracer::render (RTBase/Renderer.h:876-885); here it
is a config field.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import jax

from ..config import RenderConfig
from ..imaging import film as film_mod
from ..sampling import rng
from ..scene.types import Scene


def render_with(scene: Scene, cfg: RenderConfig, spp: int,
                film: Optional[film_mod.Film] = None,
                on_sample: Optional[Callable] = None) -> film_mod.Film:
    cam = scene.camera
    if film is None:
        film = film_mod.new_film(cam.height, cam.width)
    base = jax.random.PRNGKey(cfg.seed)

    if cfg.integrator == "adaptive":
        from .adaptive import adaptive_render
        return adaptive_render(scene, cfg, total_spp=spp, film=film,
                               on_sample=on_sample)

    if cfg.integrator in ("direct", "albedo", "normals"):
        from . import aov
        fn = {"direct": aov.direct_image, "albedo": aov.albedo_image,
              "normals": aov.normals_image}[cfg.integrator]
        pass_fn = jax.jit(lambda sc, f, k: film_mod.add_sample_image(
            f, fn(sc, k, cfg)))
    elif cfg.integrator == "lighttrace":
        from .lighttracer import light_trace_pass
        n_paths = cam.height * cam.width
        pass_fn = jax.jit(functools.partial(
            _lt_pass, cfg=cfg, n_paths=n_paths), static_argnames=())
    elif cfg.integrator == "vpl":
        from .vpl import vpl_pass
        pass_fn = jax.jit(lambda sc, f, k: vpl_pass(sc, f, k, cfg))
    else:
        raise ValueError(f"unknown integrator {cfg.integrator!r}")

    start = int(film.spp)
    for s in range(start, start + spp):
        film = pass_fn(scene, film, rng.spp_key(base, s))
        if on_sample is not None:
            on_sample(s, film)
    return film


def _lt_pass(scene, film, key, cfg, n_paths):
    from .lighttracer import light_trace_pass
    return light_trace_pass(scene, film, key, cfg, n_paths)
