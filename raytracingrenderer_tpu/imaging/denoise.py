"""Edge-aware denoiser: a-trous wavelet filter with optional AOV guides.

Fills the role of the reference's vendored Intel OIDN binary
(RTBase/Renderer.h:752-793, beauty-only "RT" filter) with
a JAX-native edge-avoiding a-trous filter (Dammertz et al. 2010):
multi-scale 5x5 B3-spline convolutions whose weights fall off with
colour (and optionally albedo/normal) differences.  Runs on device as
part of the jitted pipeline — no host round-trip, differentiable.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

_KERNEL = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _atrous_pass(img, guide_col, albedo, normal, step: int,
                 sigma_col: float, sigma_alb: float, sigma_nrm: float):
    h, w, _ = img.shape
    acc = jnp.zeros_like(img)
    wsum = jnp.zeros((h, w, 1))
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            kw = float(_KERNEL[dy + 2] * _KERNEL[dx + 2])
            sh = jnp.roll(img, (-dy * step, -dx * step), axis=(0, 1))
            cg = jnp.roll(guide_col, (-dy * step, -dx * step), axis=(0, 1))
            d2 = ((guide_col - cg) ** 2).sum(-1, keepdims=True)
            wt = kw * jnp.exp(-d2 / sigma_col)
            if albedo is not None:
                ag = jnp.roll(albedo, (-dy * step, -dx * step),
                              axis=(0, 1))
                a2 = ((albedo - ag) ** 2).sum(-1, keepdims=True)
                wt = wt * jnp.exp(-a2 / sigma_alb)
            if normal is not None:
                ng = jnp.roll(normal, (-dy * step, -dx * step),
                              axis=(0, 1))
                n2 = ((normal - ng) ** 2).sum(-1, keepdims=True)
                wt = wt * jnp.exp(-n2 / sigma_nrm)
            acc = acc + sh * wt
            wsum = wsum + wt
    return acc / jnp.maximum(wsum, 1e-8)


def denoise(img: jax.Array, albedo: Optional[jax.Array] = None,
            normal: Optional[jax.Array] = None, passes: int = 4,
            sigma_col: float = 0.5, sigma_alb: float = 0.01,
            sigma_nrm: float = 0.1) -> jax.Array:
    """Denoise an HDR (H, W, 3) image; guides are optional AOVs from
    integrators.aov (albedo_image / normals_image)."""
    img = jnp.asarray(img)
    out = img
    for p in range(passes):
        out = _atrous_pass(out, out, albedo, normal, 1 << p,
                           sigma_col * (2.0 ** -p), sigma_alb, sigma_nrm)
    return out
