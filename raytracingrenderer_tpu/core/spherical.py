"""Spherical <-> Cartesian conversions, z-up.

Parity with reference SphericalCoordinates (RTBase/Core.h:544-560).
"""
from __future__ import annotations

import jax.numpy as jnp

from .vec import V3


def spherical_to_world(theta, phi) -> V3:
    st = jnp.sin(theta)
    return V3(st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta))


def world_to_theta(v: V3):
    return jnp.arccos(jnp.clip(v.z, -1.0, 1.0))


def world_to_phi(v: V3):
    p = jnp.arctan2(v.y, v.x)
    return jnp.where(p < 0.0, p + 2.0 * jnp.pi, p)
