"""Fresnel terms (dielectric + conductor).

Capability parity with reference ShadingHelper
(RTBase/Materials.h:37-92).  The dielectric form here is
the exact Fresnel equation (the reference's perpendicular term carries a
typo in its denominator, Materials.h:73 — we implement the physics, per
SURVEY.md §7 "behavior-aware, not bug-faithful").
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.vec import V3


def fresnel_dielectric(cos_i: jax.Array, eta_i, eta_t
                       ) -> Tuple[jax.Array, jax.Array]:
    """Unpolarized Fresnel reflectance for |cos_i| at an eta_i->eta_t
    interface.  Returns (R, cos_t); R = 1 on total internal reflection.
    """
    cos_i = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)
    eta = eta_i / eta_t
    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    # double-where: sqrt'(0) = inf would turn the zero cotangent of a
    # totally reflected lane into NaN (rough dielectric refraction reads
    # cos_t even where it reflects)
    c2 = 1.0 - sin2_t
    cos_t = jnp.where(tir, 0.0, jnp.sqrt(jnp.where(tir, 1.0, c2)))
    r_s = (eta_i * cos_i - eta_t * cos_t) / jnp.maximum(
        eta_i * cos_i + eta_t * cos_t, 1e-12)
    r_p = (eta_t * cos_i - eta_i * cos_t) / jnp.maximum(
        eta_t * cos_i + eta_i * cos_t, 1e-12)
    r = 0.5 * (r_s * r_s + r_p * r_p)
    return jnp.where(tir, 1.0, jnp.clip(r, 0.0, 1.0)), cos_t


def fresnel_conductor(cos_i: jax.Array, eta: V3, k: V3) -> V3:
    """Approximate unpolarized conductor Fresnel (complex IOR eta + i*k),
    same approximation family as reference fresnelCondutor
    (Materials.h:78-91)."""
    c = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)
    c2 = c * c
    s2 = 1.0 - c2
    n2k2 = eta * eta + k * k
    two_eta_c = eta * (2.0 * c)
    r_p2 = (n2k2 * c2 - two_eta_c + s2) / (n2k2 * c2 + two_eta_c + s2)
    r_s2 = (n2k2 - two_eta_c + c2) / (n2k2 + two_eta_c + c2)
    from ..core.vec import vclamp
    return vclamp((r_p2 + r_s2) * 0.5, 0.0, 1.0)


def refract_dir(wo: V3, cos_t: jax.Array, eta: jax.Array) -> V3:
    """Refracted direction in the local frame for wo with wo.z of either
    sign; eta = eta_i/eta_t.  Transmitted ray leaves through the opposite
    hemisphere (reference GlassBSDF wt + z-flip, Materials.h:266-275)."""
    sign = jnp.sign(wo.z)
    return V3(-eta * wo.x, -eta * wo.y, -sign * cos_t)
