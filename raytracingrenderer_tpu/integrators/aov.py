"""Debug/AOV integrators: direct lighting, albedo, view normals.

Parity with reference RayTracer::direct/albedo/viewNormals
(RTBase/Renderer.h:393-407,558-581), vectorized.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.vec import V3, vwhere
from ..geometry import intersect
from ..lights import lights as lights_mod
from ..sampling import rng
from ..scene.camera import generate_rays
from ..scene.types import Scene
from .common import compute_direct, shading_data
from ..render import pixel_grid


def _primary(scene: Scene, key, cfg: RenderConfig):
    cam = scene.camera
    xs, ys = pixel_grid(cam.height, cam.width)
    if cfg.jitter:
        jx = rng.uniform(key, 0, rng.PIXEL_JITTER_X, xs.shape)
        jy = rng.uniform(key, 0, rng.PIXEL_JITTER_Y, ys.shape)
    else:
        jx = jy = 0.5
    o, d = generate_rays(cam, xs + jx, ys + jy)
    hit = intersect.closest_hit(scene, o, d)
    return o, d, hit


def direct_image(scene: Scene, key, cfg: RenderConfig) -> jax.Array:
    """One-bounce direct lighting (Renderer.h:393-407)."""
    cam = scene.camera
    o, d, hit = _primary(scene, key, cfg)
    sh = shading_data(scene, hit, o, d)
    n = o.x.shape[0]
    found = hit.valid
    is_light = found & sh.mp.is_emissive
    out = vwhere(is_light & (d.dot(sh.gn_raw) < 0.0), sh.mp.emission,
                 V3.zeros(n))
    r_pick = rng.uniform(key, 0, rng.LIGHT_PICK, (n,))
    r1 = rng.uniform(key, 0, rng.LIGHT_POS_U, (n,))
    r2 = rng.uniform(key, 0, rng.LIGHT_POS_V, (n,))
    r3 = rng.uniform(key, 0, rng.LIGHT_AUX, (n,))
    out = out + compute_direct(scene, sh, found & ~is_light,
                               r_pick, r1, r2, cfg.mis, r3=r3,
                               power=cfg.power_lights)
    return out.stacked().reshape(cam.height, cam.width, 3)


def albedo_image(scene: Scene, key, cfg: RenderConfig) -> jax.Array:
    """Albedo AOV: emissive -> Le, else f(., up)*pi-ish diffuse colour;
    miss -> background (Renderer.h:558-571)."""
    cam = scene.camera
    o, d, hit = _primary(scene, key, cfg)
    sh = shading_data(scene, hit, o, d)
    n = o.x.shape[0]
    col = vwhere(sh.mp.is_emissive, sh.mp.emission, sh.mp.albedo)
    bg = lights_mod.eval_background(scene, d)
    out = vwhere(hit.valid, col, bg)
    return out.stacked().reshape(cam.height, cam.width, 3)


def normals_image(scene: Scene, key, cfg: RenderConfig) -> jax.Array:
    """|shading normal| as RGB; black on miss (Renderer.h:572-581)."""
    cam = scene.camera
    o, d, hit = _primary(scene, key, cfg)
    sh = shading_data(scene, hit, o, d)
    out = vwhere(hit.valid,
                 V3(jnp.abs(sh.sn.x), jnp.abs(sh.sn.y), jnp.abs(sh.sn.z)),
                 V3.zeros(o.x.shape[0]))
    return out.stacked().reshape(cam.height, cam.width, 3)
