"""Batched pinhole camera ray generation and projection.

Semantics match reference Camera (RTBase/Scene.h:10-70):
`generate_rays` maps pixel coords -> world rays through P^-1 then the
view->world matrix; `project_onto_camera` is the light-tracing adjoint.
All functions are batched over flat pixel arrays.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core import matrix
from ..core.vec import V3
from .types import Camera


def generate_rays(cam: Camera, px: jax.Array, py: jax.Array
                  ) -> Tuple[V3, V3]:
    """Pixel coords (float, e.g. x+0.5) -> (origin, unit direction) batches.

    Reference Scene.h:43-54: NDC x'=2(x/w)-1, y'=2(1-y/h)-1, dir =
    normalize(cam_to_world.mulVec(P^-1.mulPoint([x', y', 1]))).
    """
    xp = (px / cam.width) * 2.0 - 1.0
    yp = (1.0 - py / cam.height) * 2.0 - 1.0
    d = V3(xp, yp, jnp.ones_like(xp))
    d = matrix.apply_point(cam.p_inv, d)
    d = matrix.apply_vec(cam.cam_to_world, d).normalize()
    o = V3(jnp.broadcast_to(cam.origin.x, d.x.shape),
           jnp.broadcast_to(cam.origin.y, d.y.shape),
           jnp.broadcast_to(cam.origin.z, d.z.shape))
    return o, d


def project_onto_camera(cam: Camera, p: V3
                        ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """World point batch -> (x_pixel, y_pixel, valid).

    Reference Scene.h:55-70 plus a front-of-camera check (w > 0): the
    perspective divide flips points behind the eye into frame otherwise.
    """
    pv = matrix.apply_point(cam.world_to_cam, p)
    M = jnp.asarray(cam.p)
    q = matrix.apply_point(M, pv)
    w = M[3, 0] * pv.x + M[3, 1] * pv.y + M[3, 2] * pv.z + M[3, 3]
    inv_w = 1.0 / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    sx = (q.x * inv_w + 1.0) * 0.5
    sy = (q.y * inv_w + 1.0) * 0.5
    valid = (w > 0.0) & (sx >= 0.0) & (sx <= 1.0) & (sy >= 0.0) & (sy <= 1.0)
    x = sx * cam.width
    y = (1.0 - sy) * cam.height
    return x, y, valid


def view_direction(cam: Camera) -> V3:
    """Unit forward axis of the camera (reference Camera::viewDirection)."""
    d = matrix.apply_point(cam.p_inv, V3.of(0.0, 0.0, 1.0))
    return matrix.apply_vec(cam.cam_to_world, d).normalize()


def cos_theta_to_pixel(cam: Camera, dir_to_pixel: V3) -> jax.Array:
    """cos of angle between camera forward axis and a unit direction —
    the cos^4 term of light-tracing importance W=1/(A_film cos^4)."""
    fwd = view_direction(cam)
    return dir_to_pixel.dot(fwd)
