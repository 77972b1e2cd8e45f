"""Round-5: validate the edge-sampling NEE boundary estimator
(integrators/boundary.py) against the r4 bias probe
(docs/BOUNDARY_BIAS_r4.md): translate cornell-box's tall box along x
and compare jax.grad WITH cfg.boundary_grads against central finite
differences with common random numbers.

The r4 probe's "shadow-edge crop" (top-decile |dI/dx| pixels) is in
fact dominated by the box's PRIMARY image silhouette — pixels whose
primary hit flips between box and wall as the box moves.  That is a
camera-visibility boundary, out of the NEE estimator's scope and not
even a well-defined continuum derivative at jitter=False pixel centres
(the point-sampled image is a staircase in dx).  This probe therefore
also reports a `shadow-only` split: moving pixels whose primary hit is
STABLE across +-eps — their |dI/dx| is the moving SHADOW, the exact
boundary class the estimator handles.  (The estimator's formula itself
is validated to 0.4% against FD on a clean single-occluder analytic
scene — see docs/BOUNDARY_r5.md.)
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from raytracingrenderer_tpu.config import RenderConfig
from raytracingrenderer_tpu.geometry import intersect
from raytracingrenderer_tpu.render import pixel_grid, sample_image
from raytracingrenderer_tpu.scene.camera import generate_rays
from raytracingrenderer_tpu.scene import synth
from raytracingrenderer_tpu.scene.loader import load_scene
from raytracingrenderer_tpu.scene.types import Camera

RES = 48
N_KEYS = 8


def main():
    sc = load_scene(synth.cornell(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".scenes", "cornell")))
    c = sc.camera
    sc = sc._replace(camera=Camera(c.p, c.p_inv, c.cam_to_world,
                                   c.world_to_cam, RES, RES, c.origin,
                                   c.a_film))
    base = dataclasses.replace(
        RenderConfig(max_depth=2, mis=False, jitter=False, rr=False),
        geom_grads=True)
    tris = sc.triangles
    occluder = jnp.asarray(np.asarray(tris.mat_id) == 6)  # tall box

    def shifted(dx):
        p0 = tris.p0
        p0 = type(p0)(p0.x + jnp.where(occluder, dx, 0.0), p0.y, p0.z)
        return sc._replace(triangles=tris._replace(p0=p0))

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def render_dx(dx, key, cfg):
        return sample_image(shifted(dx), key, cfg)

    eps = 0.02
    key0 = jax.random.PRNGKey(3)
    d_img = np.abs(np.asarray(render_dx(eps, key0, base)) - np.asarray(
        render_dx(-eps, key0, base))).mean(-1)
    moving = np.asarray(d_img > np.percentile(d_img, 90))

    def primary_ids(dx):
        sc2 = shifted(dx)
        xs, ys = pixel_grid(RES, RES)
        o, d = generate_rays(sc2.camera, xs + 0.5, ys + 0.5)
        return np.asarray(intersect.closest_hit(sc2, o, d).tri
                          ).reshape(RES, RES)

    ids0 = primary_ids(0.0)
    stable = (primary_ids(eps) == ids0) & (primary_ids(-eps) == ids0)
    shadow = moving & stable
    print(f"mask sizes: moving {moving.sum()} shadow-only "
          f"{shadow.sum()}", flush=True)

    # primal must be bit-unchanged by the injector
    cfg_b = dataclasses.replace(base, boundary_grads=True,
                                boundary_samples=4)
    i0 = np.asarray(render_dx(0.0, key0, base))
    i1 = np.asarray(render_dx(0.0, key0, cfg_b))
    print("primal identical:", bool((i0 == i1).all()), flush=True)

    for name, mask in (("shadow-only crop", jnp.asarray(shadow)),
                       ("r4 crop (incl. primary sil.)",
                        jnp.asarray(moving)),
                       ("full image", jnp.ones((RES, RES), bool))):
        def loss(dx, key, cfg, mask=mask):
            img = render_dx_loss(dx, key, cfg, mask)
            return img

        @functools.partial(jax.jit, static_argnames=("cfg",))
        def render_dx_loss(dx, key, cfg, mask=mask):
            img = sample_image(shifted(dx), key, cfg)
            return jnp.sum(jnp.where(mask[..., None], img, 0.0)) \
                / (jnp.sum(mask) * 3.0)

        gfn = jax.jit(jax.grad(render_dx_loss), static_argnames=("cfg",))
        fd, gi = [], []
        for s in range(N_KEYS):
            k = jax.random.PRNGKey(3 + s)
            fd.append((float(render_dx_loss(eps, k, base))
                       - float(render_dx_loss(-eps, k, base)))
                      / (2 * eps))
            gi.append(float(gfn(0.0, k, base)))
        g_fd, g_int = float(np.mean(fd)), float(np.mean(gi))
        line = (f"{name:30s}: interior {g_int:+.5f}  FD {g_fd:+.5f} "
                f"(+-{np.std(fd)/np.sqrt(N_KEYS):.5f})")
        for ns in (4, 16):
            cfg = dataclasses.replace(base, boundary_grads=True,
                                      boundary_samples=ns)
            gb = [float(gfn(0.0, jax.random.PRNGKey(3 + s), cfg))
                  for s in range(N_KEYS)]
            g_b = float(np.mean(gb))
            rel = abs(g_fd - g_b) / max(abs(g_fd), 1e-12)
            line += (f" | E={ns}: {g_b:+.5f} "
                     f"(+-{np.std(gb)/np.sqrt(N_KEYS):.5f}) "
                     f"rel {rel:.0%}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
