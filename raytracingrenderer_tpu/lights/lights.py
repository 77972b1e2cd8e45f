"""Unified light sampling over the light table + background.

Vectorized equivalent of reference Scene::sampleLight + Light::sample
(RTBase/Scene.h:131-140, Lights.h:17-133): uniform light
selection (pmf = 1/N over area lights + background-if-powered), area
lights sampled uniformly by area, environment maps by luminance CDF
(lights/envmap.py).  Everything returns solid-angle-unified quantities so
the integrator's NEE/MIS code is light-kind agnostic.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.vec import V3, vwhere
from ..sampling import warps
from ..scene.types import BG_CONST, BG_ENVMAP, Scene
from . import envmap as envmap_mod


class LightSample(NamedTuple):
    """One NEE candidate per lane."""
    wi: V3            # unit direction from shading point toward the light
    dist: jax.Array   # distance to the light point (BIG for infinite)
    emitted: V3       # radiance toward the shading point
    pdf_solid: jax.Array  # selection-inclusive pdf in solid angle (MIS)
    g_over_pdf: jax.Array # geometry/pdf weight: contribution = f*Le*this
    valid: jax.Array

INF_DIST = 1e30


def background_enabled(scene: Scene) -> bool:
    """Static: does the background participate as a light?  (reference
    registers it iff totalIntegratedPower > 0, Scene.h:142-160)."""
    bg = scene.background
    if bg.kind == BG_ENVMAP:
        return True
    if bg.kind == BG_CONST:
        import numpy as np
        return bool(np.asarray(bg.colour.lum()) > 0.0)
    return False


def num_lights(scene: Scene) -> int:
    return scene.num_lights + (1 if background_enabled(scene) else 0)


def eval_background(scene: Scene, d: V3) -> V3:
    """Radiance for escaped rays (reference background->evaluate)."""
    bg = scene.background
    if bg.kind == BG_ENVMAP:
        return envmap_mod.evaluate(bg.envmap, d)
    if bg.kind == BG_CONST:
        shape = jnp.shape(d.z)
        return V3(jnp.broadcast_to(bg.colour.x, shape),
                  jnp.broadcast_to(bg.colour.y, shape),
                  jnp.broadcast_to(bg.colour.z, shape))
    return V3.zeros(jnp.shape(d.z))


def background_pdf(scene: Scene, d: V3) -> jax.Array:
    """Solid-angle pdf that `sample_one` would pick direction d via the
    background (selection pmf NOT included)."""
    bg = scene.background
    if bg.kind == BG_ENVMAP:
        return envmap_mod.pdf(bg.envmap, d)
    return jnp.full(jnp.shape(d.z), warps.INV_4PI)


def selection_pmf(scene: Scene, power: bool):
    """Light-selection pmfs: (pmf_area (L,) or None, pmf_bg scalar).

    power=False: the reference's uniform 1/N (Scene::sampleLight,
    Scene.h:131-140).  power=True: proportional to each light's
    totalIntegratedPower in the REFERENCE'S OWN convention —
    AreaLight = Lum(Le)*area (Lights.h:60-63), BackgroundColour =
    Lum*4pi (Lights.h:115-118), EnvironmentMap = sin-weighted mean
    luminance * 4pi (Lights.h:171-184; precomputed as
    EnvMap.mean_power).  The reference computes these powers but never
    uses them for selection; power weighting is the many-light upgrade
    its uniform pmf leaves on the table (SURVEY §2.6), and any pmf>0
    on contributing lights keeps the estimator unbiased.
    """
    n_area = scene.num_lights
    has_bg = background_enabled(scene)
    n_total = n_area + (1 if has_bg else 0)
    if n_total == 0:
        return None, jnp.float32(0.0)
    if not power:
        u = jnp.float32(1.0 / n_total)
        return (jnp.full(n_area, u) if n_area else None), u
    w_area = scene.lights.power if n_area else jnp.zeros(0)
    if has_bg:
        bg = scene.background
        if bg.kind == BG_ENVMAP:
            w_bg = bg.envmap.mean_power
        else:
            w_bg = bg.colour.lum() * 4.0 * jnp.pi
    else:
        w_bg = jnp.float32(0.0)
    total = jnp.maximum(jnp.sum(w_area) + w_bg, 1e-30)
    return ((w_area / total) if n_area else None,
            jnp.asarray(w_bg / total, jnp.float32))


def sample_one(scene: Scene, x: V3, sn: V3, r_pick, r1, r2,
               r3=None, geom_grads: bool = False,
               power: bool = False) -> LightSample:
    """Pick one light per lane (uniformly, or power-weighted with
    `power` — see selection_pmf) and sample a direction to it.

    Area lights follow reference AreaLight::sample (uniform by area, pdf
    1/area, one-sided emission via the cos_light clamp in the G term);
    the background uses CDF importance sampling in place of the
    reference's uniform-sphere TODO.

    With `geom_grads`, emitter geometry is gathered from the
    (differentiable) triangle SoA via LightTable.tri instead of the
    table's detached copy, so vertex-position gradients flow through
    the NEE geometry term (cos/d² and the sampled point itself) — the
    dominant transport for a moving light.  Values are bit-identical
    (the table is copied from the SoA at load).
    """
    n_area = scene.num_lights
    has_bg = background_enabled(scene)
    n_total = n_area + (1 if has_bg else 0)
    shape = jnp.shape(x.x)
    if n_total == 0:
        z = jnp.zeros(shape)
        return LightSample(V3.zeros(shape), z, V3.zeros(shape), z, z,
                           jnp.zeros(shape, bool))
    if power:
        pmf_tab, pmf_bg = selection_pmf(scene, True)
        concat = [pmf_tab] if n_area else []
        if has_bg:
            concat.append(pmf_bg[None])
        pmf_all = jnp.concatenate(concat)
        cdf = jnp.cumsum(pmf_all)
        pick = jnp.clip(
            jnp.searchsorted(cdf, r_pick, side="right").astype(jnp.int32),
            0, n_total - 1)
        # clamp: f32 cumsum roundoff can land r_pick >= cdf[-1], where
        # the clip above selects a possibly-zero-pmf tail entry; an
        # unclamped pmf makes g_over_pdf_a inf, and 0*inf in the vjp
        # leaks NaN under geom_grads (advisor r4 — same transpose
        # hazard the d2 clamp below guards)
        pmf_pick = jnp.maximum(pmf_all[pick], 1e-12)
        pmf_b = jnp.maximum(pmf_bg, 1e-30)
    else:
        # uniform (reference Scene::sampleLight): keep the original
        # pick arithmetic so existing streams/goldens are bit-stable
        pick = jnp.minimum((r_pick * n_total).astype(jnp.int32),
                           n_total - 1)
        pmf_pick = jnp.full(shape, 1.0 / n_total)
        pmf_b = jnp.float32(1.0 / n_total)
    is_area = pick < n_area if n_area else jnp.zeros(shape, bool)

    if n_area:
        li = jnp.minimum(pick, n_area - 1)
        lt = scene.lights
        a, b, g = warps.uniform_triangle(r1, r2)
        # point = v0*alpha + v1*beta + v2*gamma = p0 + e1*beta + e2*gamma
        # (emitter geometry lives in the light table — no triangle-SoA
        # gathers on the NEE path — except under geom_grads, see above)
        if geom_grads:
            ti = lt.tri[li]
            tr = scene.triangles
            p0g, e1g, e2g = tr.p0.gather(ti), tr.e1.gather(ti), \
                tr.e2.gather(ti)
            ln = tr.gn.gather(ti)
        else:
            p0g, e1g, e2g = lt.p0.gather(li), lt.e1.gather(li), \
                lt.e2.gather(li)
            ln = lt.gn.gather(li)
        p = p0g + e1g * b + e2g * g
        le = lt.le.gather(li)
        area = lt.area[li]
        to_l = p - x
        # upper clip: missed lanes carry x ~ BIG_T, whose length_sq
        # overflows to inf — every downstream div's transpose would
        # then emit 0*inf = NaN once geom_grads connects the pdfs to
        # the autodiff graph (the lanes are invalid, only the vjp sees
        # them)
        d2 = jnp.clip(to_l.length_sq(), 1e-12, 1e18)
        dist = jnp.sqrt(d2)
        wi_a = to_l * (1.0 / dist)
        cos_s = jnp.maximum(wi_a.dot(sn), 0.0)
        cos_l = jnp.maximum(-wi_a.dot(ln), 0.0)
        # contribution = f * Le * G / (pmf * pdf_area); G = cos_s*cos_l/d2
        g_term = cos_s * cos_l / d2
        g_over_pdf_a = g_term * area / pmf_pick
        # solid-angle pdf incl. selection (convertPDFAreaToSolidAngle,
        # Renderer.h:411-422)
        pos_l = cos_l > 0.0
        pdf_solid_a = jnp.where(
            pos_l, pmf_pick / jnp.maximum(area, 1e-12) * d2
            / jnp.where(pos_l, jnp.maximum(cos_l, 1e-9), 1.0), 0.0)
        valid_a = g_term > 0.0
    else:
        wi_a = V3.zeros(shape)
        dist = jnp.zeros(shape)
        le = V3.zeros(shape)
        g_over_pdf_a = jnp.zeros(shape)
        pdf_solid_a = jnp.zeros(shape)
        valid_a = jnp.zeros(shape, bool)

    if has_bg:
        bg = scene.background
        if bg.kind == BG_ENVMAP:
            # the sampled texel's radiance arrives with the same gather
            # as its pdf — no separate bilinear lookup (see sample_le)
            wi_b, pdf_b, le_b = envmap_mod.sample_le(bg.envmap, r1, r2, r3)
        else:
            wi_b = warps.uniform_sphere(r1, r2)
            pdf_b = warps.uniform_sphere_pdf(wi_b)
            le_b = eval_background(scene, wi_b)
        cos_sb = jnp.maximum(wi_b.dot(sn), 0.0)
        g_over_pdf_b = cos_sb / jnp.maximum(pdf_b, 1e-12) / pmf_b
        pdf_solid_b = pmf_b * pdf_b
        valid_b = (cos_sb > 0.0) & (pdf_b > 0.0)
    else:
        wi_b = V3.zeros(shape)
        le_b = V3.zeros(shape)
        g_over_pdf_b = jnp.zeros(shape)
        pdf_solid_b = jnp.zeros(shape)
        valid_b = jnp.zeros(shape, bool)

    wi = vwhere(is_area, wi_a, wi_b)
    return LightSample(
        wi=wi,
        dist=jnp.where(is_area, dist, INF_DIST),
        emitted=vwhere(is_area, le, le_b),
        pdf_solid=jnp.where(is_area, pdf_solid_a, pdf_solid_b),
        g_over_pdf=jnp.where(is_area, g_over_pdf_a, g_over_pdf_b),
        valid=jnp.where(is_area, valid_a, valid_b))


def hit_light_pdf_solid(scene: Scene, light_id, x: V3, hit_p: V3,
                        light_gn: V3, power: bool = False) -> jax.Array:
    """pdf (solid angle, selection-inclusive) that NEE would have sampled
    the point we hit by BSDF sampling — the MIS counterweight.  `power`
    must match sample_one's selection mode or MIS weights are wrong."""
    n_total = num_lights(scene)
    if n_total == 0 or scene.num_lights == 0:
        return jnp.zeros(jnp.shape(x.x))
    li = jnp.maximum(light_id, 0)
    if power:
        pmf_tab, _ = selection_pmf(scene, True)
        pmf = pmf_tab[li]
    else:
        pmf = 1.0 / n_total
    area = scene.lights.area[li]
    to_l = hit_p - x
    d2 = jnp.maximum(to_l.length_sq(), 1e-12)
    wi = to_l * jax.lax.rsqrt(d2)
    cos_l = jnp.maximum(-wi.dot(light_gn), 0.0)
    pdf = pmf * d2 / jnp.maximum(area * cos_l, 1e-12)
    return jnp.where((light_id >= 0) & (cos_l > 1e-9), pdf, 0.0)
