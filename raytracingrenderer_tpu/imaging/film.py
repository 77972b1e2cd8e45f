"""Film: progressive accumulation buffer + reconstruction filters + tonemap.

Capability parity with reference Film/ImageFilter
(RTBase/Imaging.h:132-272): the film is a (H, W, 3)
radiance-sum array plus an spp counter; camera samples accumulate
per-pixel; light-tracing splats scatter-add anywhere with a filter
footprint.  `tonemap` is exposure*x/spp then gamma 1/2.2 clamp;
`to_hdr` divides by spp (Film::save semantics).

The film is a pytree and the natural checkpoint/resume unit (SURVEY.md §5):
(buffer, spp) fully determines a resumable render.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Film(NamedTuple):
    buffer: jax.Array  # (H, W, 3) radiance sum
    spp: jax.Array     # scalar f32


def new_film(height: int, width: int) -> Film:
    return Film(buffer=jnp.zeros((height, width, 3), jnp.float32),
                spp=jnp.zeros((), jnp.float32))


def add_sample_image(film: Film, img: jax.Array, inc_spp: float = 1.0
                     ) -> Film:
    """Accumulate one full-frame sample image (H, W, 3)."""
    return Film(film.buffer + img, film.spp + inc_spp)


def splat(film: Film, x: jax.Array, y: jax.Array, rgb: jax.Array,
          filter_size: int = 0, filter_name: str = "gaussian") -> Film:
    """Scatter-add point samples at continuous pixel coords (x, y).

    filter_size 0 = single-pixel box (the reference's active BoxFilter
    config, Renderer.h:50); >0 = normalized kernel ("box", "gaussian",
    "mitchell" — imaging/filters.py) over the (2s+1)^2 footprint
    (Film::splat, Imaging.h:209-232).
    """
    h, w = film.buffer.shape[:2]
    px = jnp.floor(x).astype(jnp.int32)
    py = jnp.floor(y).astype(jnp.int32)
    if filter_size == 0:
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        px = jnp.clip(px, 0, w - 1)
        py = jnp.clip(py, 0, h - 1)
        rgb = jnp.where(inside[:, None], rgb, 0.0)
        buf = film.buffer.at[py, px].add(rgb)
        return Film(buf, film.spp)
    from . import filters as filt_mod
    kernel = {"box": filt_mod.box, "gaussian": filt_mod.gaussian,
              "mitchell": filt_mod.mitchell}[filter_name]
    s = filter_size
    offsets = np.arange(-s, s + 1)
    wsum = jnp.zeros_like(x)
    taps = []
    for dy in offsets:
        for dx in offsets:
            cx = px + dx
            cy = py + dy
            wt = kernel(cx.astype(jnp.float32) + 0.5 - x,
                        cy.astype(jnp.float32) + 0.5 - y, s)
            taps.append((cx, cy, wt))
            wsum = wsum + wt
    wsum = jnp.maximum(wsum, 1e-12)
    buf = film.buffer
    for cx, cy, wt in taps:
        inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        wn = jnp.where(inside, wt / wsum, 0.0)
        buf = buf.at[jnp.clip(cy, 0, h - 1),
                     jnp.clip(cx, 0, w - 1)].add(rgb * wn[:, None])
    return Film(buf, film.spp)


def to_hdr(film: Film) -> jax.Array:
    """Radiance image = buffer / spp (Film::save, Imaging.h:262-271)."""
    return film.buffer / jnp.maximum(film.spp, 1.0)


def tonemap(film: Film, exposure: float = 1.0) -> jax.Array:
    """LDR uint8-ready floats: (exposure*x/spp)^(1/2.2) clamped
    (Film::tonemap, Imaging.h:233-242)."""
    img = to_hdr(film) * exposure
    return jnp.clip(jnp.power(jnp.maximum(img, 0.0), 1.0 / 2.2), 0.0, 1.0)
