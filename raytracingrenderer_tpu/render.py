"""Render driver: progressive per-sample frames accumulated into a Film.

Data-parallel replacement of the reference's mutex-guarded tile queue
(RTBase/Renderer.h:795-885): instead of threads popping
32x32 tiles, every sample pass renders the full pixel grid as one flat
ray batch in a single jitted dispatch (optionally sharded over a device
mesh — see parallel/).  Progressive accumulation (1 spp per pass,
Film::incrementSPP semantics) is preserved so interactive/checkpointed
use works the same way.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import RenderConfig
from .core.vec import V3
from .imaging import film as film_mod
from .integrators import path as path_mod
from .sampling import rng
from .scene.camera import generate_rays
from .scene.types import Scene


_MAX_CHUNK = 32  # samples per device dispatch in the batch path


def specialize_config(cfg: RenderConfig, scene: Scene) -> RenderConfig:
    """Fill cfg.mat_types with the material types the scene actually
    uses (host-side, once per render) so jit compiles only those BSDF
    lobes — the array analogue of devirtualizing the reference's BSDF*
    dispatch (Materials.h:94-116).

    Compiling all 7 lobe families through the fwd+bwd bounce scan costs
    minutes of XLA time (vs seconds specialized), so every API entry
    point must pass through here.  No-op if the scene is already traced
    (mtype is abstract) — then the caller had to specialize earlier.
    """
    if cfg.mat_types is not None:
        return cfg
    if isinstance(scene.materials.mtype, jax.core.Tracer):
        return cfg
    import dataclasses
    types = tuple(sorted(set(
        np.asarray(scene.materials.mtype).tolist())))
    # layered-coat sentinel: the coat lobe (materials/bsdf.py COAT)
    # compiles only when some material actually carries a coating
    if bool(np.asarray(scene.materials.coat_thickness).max() > 0.0):
        from .materials.bsdf import COAT
        types = types + (COAT,)
    return dataclasses.replace(cfg, mat_types=types)


def pixel_grid(height: int, width: int):
    """Flat pixel index arrays (x, y) in raster order."""
    ys, xs = jnp.mgrid[0:height, 0:width]
    return (xs.reshape(-1).astype(jnp.float32),
            ys.reshape(-1).astype(jnp.float32))


def sample_image(scene: Scene, key: jax.Array, cfg: RenderConfig
                 ) -> jax.Array:
    """One radiance sample per pixel -> (H, W, 3).  jit-able; cfg static."""
    cfg = specialize_config(cfg, scene)  # no-op under trace / if filled
    cam = scene.camera
    xs, ys = pixel_grid(cam.height, cam.width)
    if cfg.jitter:
        jx = rng.uniform(key, 0, rng.PIXEL_JITTER_X, xs.shape)
        jy = rng.uniform(key, 0, rng.PIXEL_JITTER_Y, ys.shape)
    else:
        # reference renders pixel centres only (Renderer.h:806-808)
        jx = jy = 0.5
    o, d = generate_rays(cam, xs + jx, ys + jy)
    radiance = path_mod.trace_radiance(scene, o, d, key, cfg)
    return radiance.stacked().reshape(cam.height, cam.width, 3)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _render_pass(scene: Scene, film: film_mod.Film, key: jax.Array,
                 cfg: RenderConfig):
    img = sample_image(scene, key, cfg)
    return film_mod.add_sample_image(film, img)


@jax.jit
def _add_image_jit(film: film_mod.Film, img: jax.Array):
    return film_mod.add_sample_image(film, img)


@functools.partial(jax.jit, static_argnames=("cfg", "n"))
def _render_chunk(scene: Scene, film: film_mod.Film, base: jax.Array,
                  start: jax.Array, cfg: RenderConfig, n: int):
    """`n` sample passes in ONE device dispatch (lax.scan over spp).

    Folding the spp loop onto the device removes the per-pass host
    round-trip — the analogue of the reference keeping its whole
    tile queue inside one thread-pool invocation (Renderer.h:836-853).
    """
    def step(f, s):
        img = sample_image(scene, rng.spp_key(base, s), cfg)
        return film_mod.add_sample_image(f, img), None

    film, _ = jax.lax.scan(step, film, start + jnp.arange(n))
    return film


def _use_wavefront(scene: Scene, cfg: RenderConfig) -> bool:
    """Auto policy for the compacting wavefront integrator: worth its
    host-loop dispatches once per-bounce device time dominates (BVH-scale
    scenes)."""
    if cfg.wavefront is not None:
        return cfg.wavefront
    if isinstance(scene.triangles.p0.x, jax.core.Tracer):
        return False
    from .parallel.scene_shard import ShardedBVH
    return (scene.bvh is not None
            and not isinstance(scene.bvh, ShardedBVH)
            and scene.triangles.count > 4096)


def render(scene: Scene, cfg: Optional[RenderConfig] = None,
           spp: Optional[int] = None,
           film: Optional[film_mod.Film] = None,
           on_sample: Optional[Callable] = None) -> film_mod.Film:
    """Progressive render: `spp` passes of 1 sample/pixel.

    `film` may carry a previous render's accumulation (checkpoint/resume —
    the film is the resumable unit, as in the reference where the film
    survives across frames, Imaging.h:253-261)."""
    cfg = cfg or RenderConfig()
    cfg = specialize_config(cfg, scene)
    spp = spp if spp is not None else cfg.spp
    cam = scene.camera
    if film is None:
        film = film_mod.new_film(cam.height, cam.width)
    base = jax.random.PRNGKey(cfg.seed)
    start = int(np.asarray(film.spp))
    if _use_wavefront(scene, cfg):
        from .integrators.wavefront import sample_image_wavefront
        for s in range(start, start + spp):
            key = rng.spp_key(base, s)
            img = sample_image_wavefront(scene, key, cfg)
            film = _add_image_jit(film, img)
            film.buffer.block_until_ready()
            if on_sample is not None:
                on_sample(s, film)
        return film
    if on_sample is not None:
        # Progressive path: one dispatch per sample so the caller sees
        # every accumulation step (preview / checkpoint cadence).
        for s in range(start, start + spp):
            key = rng.spp_key(base, s)
            film = _render_pass(scene, film, key, cfg)
            film.buffer.block_until_ready()
            on_sample(s, film)
        return film
    # Batch path: greedy power-of-two chunks, each a single device
    # dispatch scanning over samples (at most log2(MAX_CHUNK)+1 distinct
    # compilations, cached across calls).
    s = start
    remaining = spp
    while remaining > 0:
        n = min(_MAX_CHUNK, 1 << (remaining.bit_length() - 1))
        film = _render_chunk(scene, film, base, jnp.int32(s), cfg, n)
        s += n
        remaining -= n
    return film
