"""Isolated cornell boundary probe: direct light only (max_depth=0),
shadow pixels on STATIC geometry (primary hit stable across +-eps and
not on the moving box).  This is the measurement quoted in
docs/BOUNDARY_r5.md: estimated boundary +0.0199 +- 0.0041 vs true
(FD - interior) +0.0147 +- 0.0035 at 56 keys, E=16 — statistical
agreement on a real scene after RIS edge selection + shared-edge
deduplication landed.  Run from the repo root (CPU, ~15 min)."""
import dataclasses
import os
import functools

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from raytracingrenderer_tpu.config import RenderConfig
from raytracingrenderer_tpu.geometry import intersect
from raytracingrenderer_tpu.render import pixel_grid, sample_image
from raytracingrenderer_tpu.scene.camera import generate_rays
from raytracingrenderer_tpu.scene import synth
from raytracingrenderer_tpu.scene.loader import load_scene
from raytracingrenderer_tpu.scene.types import Camera

RES = 48
sc = load_scene(synth.cornell(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".scenes", "cornell")))
c = sc.camera
sc = sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                               c.world_to_cam, RES, RES, c.origin,
                               c.a_film))
base = dataclasses.replace(
    RenderConfig(max_depth=0, mis=False, jitter=False, rr=False),
    geom_grads=True)
tris = sc.triangles
occluder = jnp.asarray(np.asarray(tris.mat_id) == 6)


def shifted(dx):
    p0 = tris.p0
    p0 = type(p0)(p0.x + jnp.where(occluder, dx, 0.0), p0.y, p0.z)
    return sc._replace(triangles=tris._replace(p0=p0))


eps = 0.05
key0 = jax.random.PRNGKey(3)

rend = jax.jit(lambda dx, key, cfg: sample_image(shifted(dx), key, cfg),
               static_argnames=("cfg",))
d_img = np.abs(np.asarray(rend(eps, key0, base))
               - np.asarray(rend(-eps, key0, base))).mean(-1)
moving = d_img > np.percentile(d_img, 88)

xs, ys = pixel_grid(RES, RES)


def prim(dx):
    s2 = shifted(dx)
    o, d = generate_rays(s2.camera, xs + 0.5, ys + 0.5)
    return np.asarray(intersect.closest_hit(s2, o, d).tri).reshape(RES, RES)


ids0 = prim(0.0)
stable = (prim(eps) == ids0) & (prim(-eps) == ids0)
on_box = np.asarray(occluder)[np.clip(ids0, 0, None)] & (ids0 >= 0)
mask = jnp.asarray(moving & stable & ~on_box)
print("mask:", int(mask.sum()), "of moving", moving.sum(), flush=True)


def loss(dx, key, cfg):
    img = rend(dx, key, cfg)
    return jnp.sum(jnp.where(mask[..., None], img, 0.0)) / (jnp.sum(mask) * 3.0)


lj = jax.jit(loss, static_argnames=("cfg",))
gj = jax.jit(jax.grad(loss), static_argnames=("cfg",))
K = 56
fd, gi = [], []
for s in range(K):
    k = jax.random.PRNGKey(3 + s)
    fd.append((float(lj(eps, k, base)) - float(lj(-eps, k, base))) / (2 * eps))
    gi.append(float(gj(0.0, k, base)))
print(f"FD {np.mean(fd):+.5f} +-{np.std(fd)/np.sqrt(K):.5f}   "
      f"interior {np.mean(gi):+.5f}", flush=True)
for ns in (16,):
    cfg = dataclasses.replace(base, boundary_grads=True,
                              boundary_samples=ns)
    gb = [float(gj(0.0, jax.random.PRNGKey(3 + s), cfg)) for s in range(K)]
    print(f"E={ns}: +bnd {np.mean(gb):+.5f} +-{np.std(gb)/np.sqrt(K):.5f} "
          f"(boundary part {np.mean(gb)-np.mean(gi):+.5f})  "
          f"true bnd {np.mean(fd)-np.mean(gi):+.5f}", flush=True)
