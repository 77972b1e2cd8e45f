"""Bilinear texture sampling over a padded texture atlas.

Reference parity: Texture::sample (RTBase/Imaging.h:72-95):
u' = |u|*w, v' = |v|*h, bilinear over floor neighbours with integer-mod
wrap (no half-texel offset).  Batched over flat (u, v, tex_id) arrays with
gather lookups; constant textures never reach here (folded into material
albedo at load time).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vec import V3
from ..scene.types import TextureAtlas


def _gather_texel(atlas: TextureAtlas, tid, x, y) -> V3:
    t = atlas.data[tid, y, x]  # (..., 3) advanced-index gather
    return V3(t[..., 0], t[..., 1], t[..., 2])


def has_textures(atlas: TextureAtlas) -> bool:
    """Static (shape-derived) presence test — an empty atlas has a
    zero-length leading axis, so jit traces texture-free scenes without
    any gather work at all (the 4x bilinear gather otherwise costs more
    than BVH traversal per bounce)."""
    return atlas.data.shape[0] > 0


def sample(atlas: TextureAtlas, tid: jax.Array, u: jax.Array,
           v: jax.Array) -> V3:
    """Bilinear RGB sample; tid may be -1 (returns white, like the
    reference's 1x1 default texture)."""
    if not has_textures(atlas):
        one = jnp.ones(jnp.broadcast_shapes(jnp.shape(tid), jnp.shape(u)))
        return V3(one, one, one)
    safe_tid = jnp.maximum(tid, 0)
    h = atlas.hw[safe_tid, 0]
    w = atlas.hw[safe_tid, 1]
    uu = jnp.abs(u) * w.astype(jnp.float32)
    vv = jnp.abs(v) * h.astype(jnp.float32)
    x0 = jnp.floor(uu)
    y0 = jnp.floor(vv)
    fu = uu - x0
    fv = vv - y0
    x0 = x0.astype(jnp.int32) % w
    y0 = y0.astype(jnp.int32) % h
    if atlas.quad is not None:
        # one 16-float row gather carries the whole 2x2 footprint
        wmax = atlas.data.shape[2]
        flat = (safe_tid * (atlas.data.shape[1] * wmax) + y0 * wmax + x0)
        rows = jnp.take(atlas.quad, flat, axis=0)
        s00 = V3(rows[..., 0], rows[..., 1], rows[..., 2])
        s10 = V3(rows[..., 3], rows[..., 4], rows[..., 5])
        s01 = V3(rows[..., 6], rows[..., 7], rows[..., 8])
        s11 = V3(rows[..., 9], rows[..., 10], rows[..., 11])
    else:
        x1 = (x0 + 1) % w
        y1 = (y0 + 1) % h
        s00 = _gather_texel(atlas, safe_tid, x0, y0)
        s10 = _gather_texel(atlas, safe_tid, x1, y0)
        s01 = _gather_texel(atlas, safe_tid, x0, y1)
        s11 = _gather_texel(atlas, safe_tid, x1, y1)
    out = (s00 * ((1 - fu) * (1 - fv)) + s10 * (fu * (1 - fv))
           + s01 * ((1 - fu) * fv) + s11 * (fu * fv))
    white = V3(jnp.ones_like(out.x), jnp.ones_like(out.y),
               jnp.ones_like(out.z))
    return out.where(tid >= 0, white)


def sample_alpha(atlas: TextureAtlas, tid: jax.Array, u: jax.Array,
                 v: jax.Array) -> jax.Array:
    """Bilinear alpha sample (reference Imaging.h:96-118); 1.0 where the
    texture has no alpha plane or tid is -1."""
    if not has_textures(atlas):
        return jnp.ones(jnp.broadcast_shapes(jnp.shape(tid), jnp.shape(u)))
    safe_tid = jnp.maximum(tid, 0)
    h = atlas.hw[safe_tid, 0]
    w = atlas.hw[safe_tid, 1]
    uu = jnp.abs(u) * w.astype(jnp.float32)
    vv = jnp.abs(v) * h.astype(jnp.float32)
    x0 = jnp.floor(uu)
    y0 = jnp.floor(vv)
    fu = uu - x0
    fv = vv - y0
    x0 = x0.astype(jnp.int32) % w
    y0 = y0.astype(jnp.int32) % h
    if atlas.quad is not None:
        wmax = atlas.data.shape[2]
        flat = (safe_tid * (atlas.data.shape[1] * wmax) + y0 * wmax + x0)
        rows = jnp.take(atlas.quad, flat, axis=0)
        a00, a10, a01, a11 = (rows[..., 12], rows[..., 13],
                              rows[..., 14], rows[..., 15])
    else:
        x1 = (x0 + 1) % w
        y1 = (y0 + 1) % h
        a = atlas.alpha
        a00, a10, a01, a11 = (a[safe_tid, y0, x0], a[safe_tid, y0, x1],
                              a[safe_tid, y1, x0], a[safe_tid, y1, x1])
    out = (a00 * (1 - fu) * (1 - fv)
           + a10 * fu * (1 - fv)
           + a01 * (1 - fu) * fv
           + a11 * fu * fv)
    return jnp.where(tid >= 0, out, 1.0)
