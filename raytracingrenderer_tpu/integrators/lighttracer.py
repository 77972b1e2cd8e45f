"""Light tracer (adjoint transport): light paths splatted to the camera.

Wavefront re-design of reference lightTracer/connectToCamera/
lightTracePath (RTBase/Renderer.h:220-326): a batch of
light paths advances through a lax.scan over bounces; every vertex
connects to the camera with importance W_e = 1/(A_film cos^4 theta) and
geometry G, and contributions scatter-add into the film.  The reference
runs this single-threaded because film splats race (SURVEY.md §3.3);
here the scatter-add is race-free by construction and shards cleanly
(per-shard partial films psum-reduced).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import EPSILON, RenderConfig
from ..core.frame import Frame
from ..core.vec import V3, vwhere
from ..geometry import intersect
from ..imaging import film as film_mod
from ..materials import bsdf as bsdf_mod
from ..sampling import rng, warps
from ..scene import camera as camera_mod
from ..scene.types import Scene
from .common import shading_data


def _connect(scene: Scene, film_buf, p: V3, n: V3, col: V3, active):
    """Project p onto the camera; splat col * W_e * G where visible
    (reference connectToCamera, Renderer.h:234-259)."""
    cam = scene.camera
    x, y, proj_ok = camera_mod.project_onto_camera(cam, p)
    to_cam = V3(cam.origin.x - p.x, cam.origin.y - p.y, cam.origin.z - p.z)
    dist2 = jnp.maximum(to_cam.length_sq(), 1e-12)
    dir_ = to_cam * jax.lax.rsqrt(dist2)
    cos_s = n.dot(dir_)
    fwd = camera_mod.view_direction(cam)
    cos_cam = fwd.dot(-dir_)
    ok = active & proj_ok & (cos_s > 0.0) & (cos_cam > 0.0)
    g = cos_s * cos_cam / dist2
    w_e = 1.0 / (cam.a_film * jnp.maximum(cos_cam ** 4, 1e-9))
    contrib = col * (g * w_e)
    dist = jnp.sqrt(dist2)
    occ = intersect.occluded(scene, p + dir_ * EPSILON, dir_,
                             jnp.where(ok, dist - 2.0 * EPSILON, -1.0))
    ok = ok & ~occ
    rgb = jnp.where(ok[:, None], contrib.stacked(), 0.0)
    return film_mod.splat(film_mod.Film(film_buf, jnp.float32(0)),
                          x, y, rgb).buffer


def light_trace_pass(scene: Scene, film: film_mod.Film, key,
                     cfg: RenderConfig, n_paths: int,
                     mesh=None) -> film_mod.Film:
    """One pass of n_paths light paths; increments film spp by 1 (the
    reference shoots width*height paths per frame, Renderer.h:222-229).

    With `mesh`, the path axis is sharded across its `rays` axis and the
    film stays replicated: XLA partitions the whole bounce scan SPMD and
    reduces the per-shard scatter-add partials with an inserted psum —
    the sharded-film-accumulation design SURVEY §2.11 calls for (the
    reference must run this single-threaded because its splats race,
    Renderer.h:223-229)."""
    from ..lights import lights as lights_api
    n_area = scene.num_lights
    has_bg = lights_api.background_enabled(scene)
    n_total = n_area + (1 if has_bg else 0)
    buf = film.buffer
    if n_total == 0:
        return film_mod.Film(buf, film.spp + 1.0)
    n = n_paths
    pmf = 1.0 / n_total

    # ---- sample light position + direction ---------------------------
    # Uniform pick over area lights + background (Scene::sampleLight pmf
    # semantics, Scene.h:131-140).
    r_pick = rng.uniform(key, 0, rng.LIGHT_PICK, (n,))
    pick = jnp.minimum((r_pick * n_total).astype(jnp.int32), n_total - 1)
    is_bg = (pick >= n_area) if has_bg else jnp.zeros(n, bool)
    r1 = rng.uniform(key, 0, rng.LIGHT_POS_U, (n,))
    r2 = rng.uniform(key, 0, rng.LIGHT_POS_V, (n,))

    if n_area:
        li = jnp.minimum(pick, n_area - 1)
        lt = scene.lights
        a, b, g = warps.uniform_triangle(r1, r2)
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
        # Infinite lights emit from the scene bounding sphere: position
        # uniform on the sphere, inward normal (reference
        # samplePositionFromLight, Lights.h:119-126,185-193 — with the
        # pdf the BackgroundColour variant inverts by mistake).
        sph = warps.uniform_sphere(r1, r2)
        c, r = scene.bounds.centre, jnp.maximum(scene.bounds.radius, 1e-6)
        p_b = V3(c.x + sph.x * r, c.y + sph.y * r, c.z + sph.z * r)
        ln_b = -sph
        pdf_pos_b = jnp.broadcast_to(
            1.0 / (4.0 * jnp.pi * r * r), (n,))
        p = vwhere(is_bg, p_b, p_a)
        ln = vwhere(is_bg, ln_b, ln_a)
        pdf_pos = jnp.where(is_bg, pdf_pos_b, pdf_pos_a)
    else:
        p, ln, pdf_pos = p_a, ln_a, pdf_pos_a

    # cosine-sampled emission direction about the (inward, for infinite
    # lights) normal — AreaLight::sampleDirectionFromLight semantics,
    # upgraded from the reference's uniform sphere for the background.
    r3 = rng.uniform(key, 0, rng.BSDF_U, (n,))
    r4 = rng.uniform(key, 0, rng.BSDF_V, (n,))
    wl = warps.cosine_hemisphere(r3, r4)
    lf = Frame.from_normal(ln)
    wi = lf.to_world(wl)
    pdf_dir = warps.cosine_hemisphere_pdf(wl)

    # emitted radiance along wi: area lights are constant; the env is
    # directional — a ray entering along wi carries the radiance a
    # camera ray escaping along -wi would see.
    if has_bg:
        le = vwhere(is_bg, lights_api.eval_background(scene, -wi), le_a)
    else:
        le = le_a

    # radiance-over-pdf carried along the path (lightTrace_init,
    # Renderer.h:260-286)
    le_over = le * (wl.z / jnp.maximum(pmf * pdf_dir * pdf_pos, 1e-12))
    # connect the light vertex itself (emitted radiance toward camera);
    # for the background this paints the directly-visible environment.
    cam = scene.camera
    dir_c = V3(cam.origin.x - p.x, cam.origin.y - p.y,
               cam.origin.z - p.z).normalize()
    if has_bg:
        le_cam = vwhere(is_bg, lights_api.eval_background(scene, -dir_c),
                        le_a)
    else:
        le_cam = le_a
    buf = _connect(scene, buf, p, ln,
                   le_cam * (1.0 / jnp.maximum(pmf * pdf_pos, 1e-12)),
                   jnp.ones(n, bool))

    state = dict(o=p + wi * EPSILON, d=wi,
                 throughput=V3.full(n, 1.0, 1.0, 1.0),
                 alive=jnp.ones(n, bool), buf=buf)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import RAY_AXIS
        ray_s = NamedSharding(mesh, P(RAY_AXIS))
        rep = NamedSharding(mesh, P())
        state = {k: (jax.lax.with_sharding_constraint(v, rep)
                     if k == "buf" else jax.tree_util.tree_map(
                         lambda a: jax.lax.with_sharding_constraint(
                             a, ray_s), v))
                 for k, v in state.items()}

    def bounce(state, depth):
        o, d, beta = state["o"], state["d"], state["throughput"]
        alive = state["alive"]
        buf = state["buf"]
        hit = intersect.closest_hit(scene, o, d)
        found = hit.valid & alive
        sh = shading_data(scene, hit, o, d)
        specular = bsdf_mod.is_specular(sh.mp.mtype)
        connectable = found & ~sh.mp.is_emissive & ~specular

        to_cam = V3(scene.camera.origin.x - sh.x.x,
                    scene.camera.origin.y - sh.x.y,
                    scene.camera.origin.z - sh.x.z).normalize()
        f = bsdf_mod.evaluate(sh.mp, sh.wo_local,
                              sh.frame.to_local(to_cam),
                              cfg.mat_types)
        col = beta * f * le_over
        buf = _connect(scene, buf, sh.x, sh.sn, col, connectable)

        # RR + BSDF continue (lightTracePath, Renderer.h:303-324)
        rr_p = jnp.minimum(beta.lum(), cfg.rr_cap)
        r_rr = rng.uniform(key, depth + 1, rng.RR, (n,))
        survive = connectable & (r_rr < rr_p)
        beta = vwhere(survive, beta / jnp.maximum(rr_p, 1e-9), beta)
        b1 = rng.uniform(key, depth + 1, rng.BSDF_U, (n,))
        b2 = rng.uniform(key, depth + 1, rng.BSDF_V, (n,))
        bl = rng.uniform(key, depth + 1, rng.BSDF_LOBE, (n,))
        wi2, colour, pdf, ok = bsdf_mod.sample(sh.mp, sh.wo_local, b1, b2,
                                               bl, cfg.mat_types)
        weight = colour * (jnp.abs(wi2.z) / jnp.maximum(pdf, 1e-9))
        alive_next = survive & ok & (weight.max_comp() > 0.0)
        beta = vwhere(alive_next, beta * weight, beta)
        w_world = sh.frame.to_world(wi2)
        return dict(o=vwhere(alive_next, sh.x + w_world * EPSILON, o),
                    d=vwhere(alive_next, w_world, d),
                    throughput=beta, alive=alive_next, buf=buf), None

    state, _ = jax.lax.scan(bounce, state,
                            jnp.arange(cfg.max_depth + 1, dtype=jnp.int32))
    return film_mod.Film(state["buf"], film.spp + 1.0)
