"""Instant radiosity: VPL generation + camera-ray gather.

Wavefront re-design of reference traceVPLs/VPLTracePath/
computeVPLsContribution (RTBase/Renderer.h:81-218):
pass 1 traces a fixed-size batch of light paths whose diffuse vertices
deposit VPLs into a static-shape table (MAX_VPL paths x (max_depth+1)
slots, invalid slots masked); pass 2 shoots camera rays and gathers
sum(Le_vpl * f_vpl * f_recv * G * V) with a lax.scan over VPL slots —
each iteration is one full-width shadow-ray batch, so the
O(pixels x VPLs) loop stays data-parallel.

Unlike the reference (which evaluates both path ends with real
directions, Renderer.h:126-157, but drops the direction pdf at the
first vertex, Renderer.h:174), each VPL stores its incident direction
and material parameters so the VPL-side BRDF is evaluated with the TRUE
gather direction at gather time — exact for every lobe, not just
Lambert.  Infinite lights (constant background / environment map)
deposit emitter VPLs on the scene bounding sphere
(samplePositionFromLight, Lights.h:119-126,185-193) whose radiance is
evaluated per receiver direction at gather time.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import EPSILON, MAX_VPL, RenderConfig
from ..core.frame import Frame
from ..core.vec import V3, vwhere
from ..geometry import intersect
from ..imaging import film as film_mod
from ..lights import lights as lights_api
from ..materials import bsdf as bsdf_mod
from ..sampling import rng, warps
from ..scene.camera import generate_rays
from ..scene.types import Scene
from ..render import pixel_grid
from .common import shading_data

# VPL kinds
VPL_SURFACE = 0   # path vertex: stored mp + wo give the true BRDF
VPL_EMITTER = 1   # on an area light: le is the emitted radiance
VPL_BG = 2        # on the bounding sphere: env radiance evaluated
                  # per receiver direction at gather time


class VPLs(NamedTuple):
    x: V3        # position
    n: V3        # normal (shading normal for surface VPLs, inward
                 # sphere normal for background VPLs)
    wo: V3       # world direction toward the previous path vertex
    le: V3       # carried radiance/scale (already /pdfs/N, NO vpl-side
                 # BRDF — that is evaluated at gather time)
    mp: bsdf_mod.MatParams  # material at the vertex (surface VPLs)
    kind: jax.Array
    valid: jax.Array


def _dummy_mp(n: int) -> bsdf_mod.MatParams:
    z = jnp.zeros(n)
    return bsdf_mod.MatParams(
        mtype=jnp.zeros(n, jnp.int32), albedo=V3.zeros(n), eta=V3.zeros(n),
        k=V3.zeros(n), int_ior=z, ext_ior=z, alpha=z, sigma=z,
        emission=V3.zeros(n), is_emissive=jnp.zeros(n, bool),
        coat_thickness=z, coat_sigma_a=V3.zeros(n), coat_int_ior=z,
        coat_ext_ior=z)


def trace_vpls(scene: Scene, key, cfg: RenderConfig,
               n_paths: int = MAX_VPL) -> VPLs:
    n_area = scene.num_lights
    has_bg = lights_api.background_enabled(scene)
    n_total = n_area + (1 if has_bg else 0)
    n = n_paths
    slots = cfg.max_depth + 2  # light vertex + bounces
    if n_total == 0:
        z = V3.zeros((slots * n,))
        return VPLs(z, z, z, z, _dummy_mp(slots * n),
                    jnp.zeros(slots * n, jnp.int32),
                    jnp.zeros(slots * n, bool))

    pmf = 1.0 / n_total
    r_pick = rng.uniform(key, 0, rng.LIGHT_PICK, (n,))
    pick = jnp.minimum((r_pick * n_total).astype(jnp.int32), n_total - 1)
    is_bg = (pick >= n_area) if has_bg else jnp.zeros(n, bool)
    r1 = rng.uniform(key, 0, rng.LIGHT_POS_U, (n,))
    r2 = rng.uniform(key, 0, rng.LIGHT_POS_V, (n,))

    if n_area:
        li = jnp.minimum(pick, n_area - 1)
        lt = scene.lights
        _, b, g = warps.uniform_triangle(r1, r2)
        p_a = lt.p0.gather(li) + lt.e1.gather(li) * b \
            + lt.e2.gather(li) * g
        ln_a = lt.gn.gather(li)
        pdf_pos_a = 1.0 / jnp.maximum(lt.area[li], 1e-12)
        le_a = lt.le.gather(li)
    else:
        p_a = V3.zeros(n)
        ln_a = V3.full(n, 0.0, 0.0, 1.0)
        pdf_pos_a = jnp.ones(n)
        le_a = V3.zeros(n)

    if has_bg:
        sph = warps.uniform_sphere(r1, r2)
        c, r = scene.bounds.centre, jnp.maximum(scene.bounds.radius, 1e-6)
        p = vwhere(is_bg,
                   V3(c.x + sph.x * r, c.y + sph.y * r, c.z + sph.z * r),
                   p_a)
        ln = vwhere(is_bg, -sph, ln_a)
        pdf_pos = jnp.where(is_bg, 1.0 / (4.0 * jnp.pi * r * r), pdf_pos_a)
    else:
        p, ln, pdf_pos = p_a, ln_a, pdf_pos_a
    inv_np = 1.0 / n_paths
    scale0 = inv_np / jnp.maximum(pmf * pdf_pos, 1e-12)

    # VPL 0: on the light itself (radiance toward the receiver; the env
    # variant stores the scale only — radiance is direction-dependent)
    vpl_x = [p]
    vpl_n = [ln]
    vpl_wo = [ln]
    vpl_le = [vwhere(is_bg, V3(scale0, scale0, scale0), le_a * scale0)]
    vpl_mp = [_dummy_mp(n)]
    vpl_kind = [jnp.where(is_bg, VPL_BG, VPL_EMITTER).astype(jnp.int32)]
    vpl_ok = [jnp.ones(n, bool)]

    r3 = rng.uniform(key, 0, rng.BSDF_U, (n,))
    r4 = rng.uniform(key, 0, rng.BSDF_V, (n,))
    wl = warps.cosine_hemisphere(r3, r4)
    wi = Frame.from_normal(ln).to_world(wl)
    pdf_dir = warps.cosine_hemisphere_pdf(wl)
    if has_bg:
        le = vwhere(is_bg, lights_api.eval_background(scene, -wi), le_a)
    else:
        le = le_a
    # flux-ish carried term: Le cos / (pmf pdf_pos pdf_dir N)
    carried = le * (wl.z * inv_np
                    / jnp.maximum(pmf * pdf_pos * pdf_dir, 1e-12))

    o = p + wi * EPSILON
    d = wi
    beta = V3.full(n, 1.0, 1.0, 1.0)
    alive = jnp.ones(n, bool)
    for depth in range(cfg.max_depth + 1):
        hit = intersect.closest_hit(scene, o, d)
        found = hit.valid & alive
        sh = shading_data(scene, hit, o, d)
        specular = bsdf_mod.is_specular(sh.mp.mtype)
        deposit = found & ~sh.mp.is_emissive & ~specular
        # Deposited VPL carries the incident flux estimate (beta *
        # carried) plus the vertex's wo + material; the TRUE BRDF toward
        # the receiver is evaluated at gather time (vpl_pass).
        vpl_x.append(sh.x)
        vpl_n.append(sh.sn)
        vpl_wo.append(-d)
        vpl_le.append(beta * carried)
        vpl_mp.append(sh.mp)
        vpl_kind.append(jnp.full(n, VPL_SURFACE, jnp.int32))
        vpl_ok.append(deposit)

        rr_p = jnp.minimum(beta.lum(), cfg.rr_cap)
        r_rr = rng.uniform(key, depth + 1, rng.RR, (n,))
        survive = deposit & (r_rr < rr_p)
        beta = vwhere(survive, beta / jnp.maximum(rr_p, 1e-9), beta)
        b1 = rng.uniform(key, depth + 1, rng.BSDF_U, (n,))
        b2 = rng.uniform(key, depth + 1, rng.BSDF_V, (n,))
        bl = rng.uniform(key, depth + 1, rng.BSDF_LOBE, (n,))
        wi2, colour, pdf, ok = bsdf_mod.sample(sh.mp, sh.wo_local, b1, b2,
                                               bl, cfg.mat_types)
        weight = colour * (jnp.abs(wi2.z) / jnp.maximum(pdf, 1e-9))
        alive = survive & ok & (weight.max_comp() > 0.0)
        beta = vwhere(alive, beta * weight, beta)
        w_world = sh.frame.to_world(wi2)
        o = vwhere(alive, sh.x + w_world * EPSILON, o)
        d = vwhere(alive, w_world, d)

    cat = lambda vs: jnp.concatenate(vs)  # noqa: E731
    catv = lambda vs: V3(cat([v.x for v in vs]), cat([v.y for v in vs]),
                         cat([v.z for v in vs]))  # noqa: E731
    return VPLs(
        x=catv(vpl_x), n=catv(vpl_n), wo=catv(vpl_wo), le=catv(vpl_le),
        mp=jax.tree_util.tree_map(lambda *ls: cat(list(ls)), *vpl_mp),
        kind=cat(vpl_kind), valid=cat(vpl_ok))


def vpl_pass(scene: Scene, film: film_mod.Film, key,
             cfg: RenderConfig) -> film_mod.Film:
    """One instant-radiosity frame (both passes)."""
    vpls = trace_vpls(scene, rng.decision_key(key, 0, 15), cfg)
    cam = scene.camera
    xs, ys = pixel_grid(cam.height, cam.width)
    o, d = generate_rays(cam, xs + 0.5, ys + 0.5)
    hit = intersect.closest_hit(scene, o, d)
    sh = shading_data(scene, hit, o, d)
    shade = hit.valid & ~sh.mp.is_emissive \
        & ~bsdf_mod.is_specular(sh.mp.mtype)
    npix = o.x.shape[0]

    def gather_one(acc, slot):
        vx = vpls.x.gather(slot)
        vn = vpls.n.gather(slot)
        vwo = vpls.wo.gather(slot)
        vle = vpls.le.gather(slot)
        vkind = vpls.kind[slot]
        vmp = jax.tree_util.tree_map(lambda a: a[slot], vpls.mp)
        ok = vpls.valid[slot]
        to_v = V3(vx.x - sh.x.x, vx.y - sh.x.y, vx.z - sh.x.z)
        d2 = to_v.length_sq()
        near = d2 < 1e-4  # reference skips near VPLs (Renderer.h:135)
        dir_ = to_v * jax.lax.rsqrt(jnp.maximum(d2, 1e-12))
        cos_v = vn.dot(-dir_)
        cos_x = sh.sn.dot(dir_)
        cand = shade & ok & ~near & (cos_v > 0.0) & (cos_x > 0.0)
        g_term = jnp.where(cand, cos_v * cos_x / jnp.maximum(d2, 1e-12),
                           0.0)
        dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
        occ = intersect.occluded(
            scene, sh.x + dir_ * EPSILON, dir_,
            jnp.where(cand, dist - 2.0 * EPSILON, -1.0))
        f = bsdf_mod.evaluate(sh.mp, sh.wo_local, sh.frame.to_local(dir_),
                              cfg.mat_types)
        # VPL-side radiance: surface VPLs evaluate the stored material
        # with the TRUE directions (stored wo -> receiver); emitter VPLs
        # pass radiance through; background VPLs evaluate the env along
        # the receiver's line of sight.
        vframe = Frame.from_normal(vn)
        f_vpl = bsdf_mod.evaluate(vmp, vframe.to_local(vwo),
                                  vframe.to_local(-dir_), cfg.mat_types)
        is_surf = vkind == VPL_SURFACE
        le_eff = vwhere(is_surf, vle * f_vpl, vle)
        if lights_api.background_enabled(scene):
            le_eff = vwhere(vkind == VPL_BG,
                            vle * lights_api.eval_background(scene, dir_),
                            le_eff)
        contrib = le_eff * f * jnp.where(occ, 0.0, g_term)
        return acc + contrib, None

    n_slots = vpls.valid.shape[0]
    acc = V3.zeros(npix)
    acc, _ = jax.lax.scan(gather_one, acc,
                          jnp.arange(n_slots, dtype=jnp.int32))
    # direct emission for camera rays that hit lights
    acc = acc + vwhere(hit.valid & sh.mp.is_emissive
                       & (d.dot(sh.gn_raw) < 0.0), sh.mp.emission,
                       V3.zeros(npix))
    # camera rays that escape see the background directly
    if lights_api.background_enabled(scene):
        acc = acc + vwhere(~hit.valid, lights_api.eval_background(scene, d),
                           V3.zeros(npix))
    img = acc.stacked().reshape(cam.height, cam.width, 3)
    return film_mod.add_sample_image(film, img)
