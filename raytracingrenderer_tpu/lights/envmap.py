"""Lat-long environment map: evaluation + luminance-CDF importance sampling.

Direction<->uv convention matches reference EnvironmentMap::evaluate
(RTBase/Lights.h:150-157): y-up, u = atan2(z,x)/2pi,
v = acos(y)/pi.  The reference leaves luminance-weighted importance
sampling as an unfinished TODO (Lights.h:158-161,194-199) and falls back
to uniform-sphere sampling; here a Walker/Vose alias table over the
sin-weighted texel luminances is built at load time (native C++ with a
numpy fallback) and sampled on device in O(1), where a searchsorted
inverse CDF costs ~log2(H*W) dependent gather rounds.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.vec import V3
from ..scene.types import EnvMap

TWO_PI = 2.0 * np.pi
INV_2PI = 1.0 / TWO_PI
INV_PI = 1.0 / np.pi


def build_envmap(data: np.ndarray) -> EnvMap:
    """Precompute CDF tables from (H, W, 3) radiance (host-side)."""
    data = np.asarray(data, np.float32)
    h, w, _ = data.shape
    lum = (0.2126 * data[..., 0] + 0.7152 * data[..., 1]
           + 0.0722 * data[..., 2]).astype(np.float64)
    # Weight each texel by the average of the bilinear reconstruction
    # over its cell (mean of its 4 corner texels, wrap like the sampler)
    # so pdf and evaluate() describe the same signal — a point-sampled
    # pdf under a bilinear evaluate() spikes the estimator at hard edges.
    lum_cell = 0.25 * (lum + np.roll(lum, -1, axis=1)
                       + np.roll(lum, -1, axis=0)
                       + np.roll(np.roll(lum, -1, axis=0), -1, axis=1))
    # sin(theta) weight per row; reference totalIntegratedPower uses
    # sin(i/H * pi) (Lights.h:171-184) but texel centres are better.
    st = np.sin((np.arange(h) + 0.5) / h * np.pi)
    weights = lum_cell * st[:, None] + 1e-12
    total = weights.sum()
    p_texel = weights / total                             # (H, W)
    prob, alias = _alias_table(p_texel.reshape(-1))
    # density over (u,v) in [0,1]^2
    pdf2d = p_texel * (h * w)
    # Reference-parity power estimate (Lights.h:171-184): sin-weighted mean
    # of luminance * 4pi (the reference uses sin(i/H*pi)).
    st_ref = np.sin(np.arange(h) / h * np.pi)
    mean_power = float((lum * st_ref[:, None]).mean() * 4.0 * np.pi)
    alias_row = np.stack([prob, alias.astype(np.float32)], axis=1)
    texel_row = np.concatenate(
        [data.reshape(-1, 3), pdf2d.reshape(-1, 1)], axis=1)
    return EnvMap(
        data=jnp.asarray(data),
        alias_row=jnp.asarray(alias_row, jnp.float32),
        texel_row=jnp.asarray(texel_row, jnp.float32),
        pdf2d=jnp.asarray(pdf2d, jnp.float32),
        mean_power=jnp.asarray(mean_power, jnp.float32),
    )


def _alias_table(p: np.ndarray):
    """Walker/Vose alias table of a normalized pmf (native C++ builder
    when available; numpy/python fallback for small tables/tests)."""
    n = len(p)
    p = np.asarray(p, np.float64)
    p = p / p.sum()
    from ..geometry.bvh_native import _load
    lib = _load()
    if lib is not None:
        import ctypes
        prob = np.empty(n, np.float32)
        alias = np.empty(n, np.int32)
        lib.alias_build(
            np.ascontiguousarray(p).ctypes.data_as(
                ctypes.POINTER(ctypes.c_double)), n,
            prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return prob, alias
    # python fallback (Vose)
    scaled = p * n
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    return prob, alias


def dir_to_uv(wi: V3) -> Tuple[jax.Array, jax.Array]:
    u = jnp.arctan2(wi.z, wi.x)
    u = jnp.where(u < 0.0, u + TWO_PI, u) * INV_2PI
    v = jnp.arccos(jnp.clip(wi.y, -1.0, 1.0)) * INV_PI
    return u, v


def uv_to_dir(u: jax.Array, v: jax.Array) -> V3:
    phi = u * TWO_PI
    theta = v * jnp.pi
    st = jnp.sin(theta)
    return V3(st * jnp.cos(phi), jnp.cos(theta), st * jnp.sin(phi))


def evaluate(env: EnvMap, wi: V3) -> V3:
    """Radiance along wi; bilinear with wrap, reference Texture::sample
    semantics (floor-grid, no half-texel offset, Imaging.h:72-95)."""
    u, v = dir_to_uv(wi)
    h, w = env.data.shape[0], env.data.shape[1]
    uu = u * w
    vv = v * h
    x0f = jnp.floor(uu)
    y0f = jnp.floor(vv)
    fu = uu - x0f
    fv = vv - y0f
    x0 = x0f.astype(jnp.int32) % w
    y0 = y0f.astype(jnp.int32) % h
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h

    def tex(y, x):
        t = env.data[y, x]
        return V3(t[..., 0], t[..., 1], t[..., 2])

    return (tex(y0, x0) * ((1 - fu) * (1 - fv))
            + tex(y0, x1) * (fu * (1 - fv))
            + tex(y1, x0) * ((1 - fu) * fv)
            + tex(y1, x1) * (fu * fv))


def sample_le(env: EnvMap, r1: jax.Array, r2: jax.Array,
              r3: jax.Array = None) -> Tuple[V3, jax.Array, V3]:
    """Importance-sample a direction; returns (wi, solid-angle pdf, and
    the sampled texel's radiance).

    Alias-method texel pick in O(1): r1 picks the slot, r3 drives the
    accept-or-alias test (its conditional remainder stratifies u inside
    the texel), r2 supplies v.  r3 is a SEPARATE uniform: folding the
    slot index and the accept fraction into one float32 leaves only
    (24 - log2(H*W)) mantissa bits for the fraction — at 512x1024 the
    accept probabilities quantize to 1/32 steps, a systematic sampling
    bias against the pdf table (advisor r2 finding).  Legacy callers
    without r3 fall back to the folded form.  Exactly TWO row gathers
    run per sample — [prob, alias] at the slot and [R, G, B, pdf] at
    the texel — one packed row each instead of one gather per field.
    The returned radiance is the texel point sample the pdf
    table describes — NEE pairs it with that pdf, while escaped rays
    keep bilinear `evaluate`.
    """
    h, w = env.data.shape[0], env.data.shape[1]
    n = h * w
    scaled = r1 * n
    j = jnp.clip(scaled.astype(jnp.int32), 0, n - 1)
    if r3 is None:
        rp = scaled - j.astype(jnp.float32)  # folded in-slot uniform
    else:
        rp = r3                              # full-precision uniform
    arow = env.alias_row[j]                  # gather 1: [prob, alias]
    pj = arow[:, 0]
    take = rp < pj
    idx = jnp.where(take, j, arow[:, 1].astype(jnp.int32))
    # conditional remainder is uniform on the chosen branch
    du = jnp.where(take, rp / jnp.maximum(pj, 1e-12),
                   (rp - pj) / jnp.maximum(1.0 - pj, 1e-12))
    du = jnp.clip(du, 0.0, 1.0)
    y = idx // w
    x = idx % w
    dv = r2

    u = (x.astype(jnp.float32) + du) / w
    v = (y.astype(jnp.float32) + dv) / h
    wi = uv_to_dir(u, v)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - wi.y * wi.y, 1e-12))
    trow = env.texel_row[idx]                # gather 2: [R, G, B, pdf]
    pdf = trow[:, 3] / (2.0 * jnp.pi * jnp.pi * sin_theta)
    le = V3(trow[:, 0], trow[:, 1], trow[:, 2])
    return wi, pdf, le


def sample(env: EnvMap, r1: jax.Array, r2: jax.Array
           ) -> Tuple[V3, jax.Array]:
    """(wi, pdf) form of sample_le."""
    wi, pdf, _ = sample_le(env, r1, r2)
    return wi, pdf


def with_data(env: EnvMap, data: jax.Array) -> EnvMap:
    """Replace the radiance (keeping the sampling tables detached) —
    the differentiable-parameter update path (diff._merge_scene).  The
    packed texel rows carry the SAME radiance leaves so NEE gradients
    flow; the pdf column and alias table stay the fixed distribution."""
    texel_row = jnp.concatenate(
        [data.reshape(-1, 3), env.texel_row[:, 3:4]], axis=1)
    return env._replace(data=data, texel_row=texel_row)


def pdf(env: EnvMap, wi: V3) -> jax.Array:
    """Solid-angle pdf of `sample` for an arbitrary direction — the PDF
    the reference's assignment comment asks for (Lights.h:158-161)."""
    u, v = dir_to_uv(wi)
    h, w = env.data.shape[0], env.data.shape[1]
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - wi.y * wi.y, 1e-12))
    return env.pdf2d[y, x] / (2.0 * jnp.pi * jnp.pi * sin_theta)
