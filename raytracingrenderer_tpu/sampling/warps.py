"""Analytic sampling warps and their PDFs.

Capability parity with reference SamplingDistributions
(RTBase/Sampling.h:29-69): uniform/cosine hemisphere and
uniform sphere warps, all vectorized over flat batches.  Additionally the
GGX (Trowbridge-Reitz) half-vector warp the reference declares but never
implements (Materials.h:40-54) — needed by the microfacet BSDFs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.spherical import spherical_to_world
from ..core.vec import V3

INV_PI = 1.0 / jnp.pi
INV_2PI = 0.5 / jnp.pi
INV_4PI = 0.25 / jnp.pi


def uniform_hemisphere(r1, r2) -> V3:
    theta = jnp.arccos(jnp.clip(r1, 0.0, 1.0))
    phi = 2.0 * jnp.pi * r2
    return spherical_to_world(theta, phi)


def uniform_hemisphere_pdf(wi: V3):
    return jnp.where(wi.z >= 0.0, INV_2PI, 0.0)


def cosine_hemisphere(r1, r2) -> V3:
    theta = jnp.arccos(jnp.sqrt(jnp.clip(r1, 0.0, 1.0)))
    phi = 2.0 * jnp.pi * r2
    return spherical_to_world(theta, phi)


def cosine_hemisphere_pdf(wi: V3):
    return jnp.where(wi.z >= 0.0, wi.z * INV_PI, 0.0)


def uniform_sphere(r1, r2) -> V3:
    theta = jnp.arccos(jnp.clip(1.0 - 2.0 * r1, -1.0, 1.0))
    phi = 2.0 * jnp.pi * r2
    return spherical_to_world(theta, phi)


def uniform_sphere_pdf(wi: V3):
    return jnp.full(jnp.shape(wi.x), INV_4PI)


def uniform_triangle(r1, r2):
    """Barycentric (alpha, beta, gamma) for area-uniform triangle sampling.

    Same warp as reference Triangle::sample (Geometry.h:107-119):
    alpha = 1-sqrt(r1), beta = r2*sqrt(r1).
    """
    sq = jnp.sqrt(jnp.clip(r1, 0.0, 1.0))
    alpha = 1.0 - sq
    beta = r2 * sq
    return alpha, beta, 1.0 - alpha - beta


def ggx_sample_half(r1, r2, alpha) -> V3:
    """Sample the GGX normal distribution (half-vector about +z).

    theta_h = atan(alpha * sqrt(r1 / (1 - r1))); pdf_h = D(h) cos(theta_h).
    """
    r1 = jnp.clip(r1, 0.0, 1.0 - 1e-7)
    tan2 = (alpha * alpha) * r1 / (1.0 - r1)
    cos_t = jax.lax.rsqrt(1.0 + tan2)
    # lower clamp: sqrt'(0) = inf would turn the (zero) d/d-alpha chain
    # term into NaN at r1 = 0 under reverse mode (inf * 0)
    sin_t = jnp.sqrt(jnp.clip(1.0 - cos_t * cos_t, 1e-20, 1.0))
    phi = 2.0 * jnp.pi * r2
    return V3(sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t)


def ggx_d(h: V3, alpha):
    """GGX microfacet distribution D(h), h in local (z-up) space."""
    a2 = alpha * alpha
    c2 = h.z * h.z
    denom = c2 * (a2 - 1.0) + 1.0
    d = a2 / jnp.maximum(jnp.pi * denom * denom, 1e-12)
    return jnp.where(h.z > 0.0, d, 0.0)


def ggx_lambda(w: V3, alpha):
    """Smith Lambda for GGX; w local."""
    c2 = jnp.clip(w.z * w.z, 1e-12, 1.0)
    tan2 = (1.0 - c2) / c2
    return 0.5 * (jnp.sqrt(1.0 + alpha * alpha * tan2) - 1.0)


def ggx_g(wi: V3, wo: V3, alpha):
    """Smith height-correlated masking-shadowing G(wi, wo)."""
    return 1.0 / (1.0 + ggx_lambda(wi, alpha) + ggx_lambda(wo, alpha))


def ggx_half_pdf(h: V3, alpha):
    return ggx_d(h, alpha) * jnp.maximum(h.z, 0.0)
