"""Shared integrator pieces: shading-data construction and NEE.

Vectorized equivalents of reference Scene::calculateShadingData
(RTBase/Scene.h:174-203) and RayTracer::computeDirect /
computeDirectMIS (Renderer.h:423-557).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import EPSILON
from ..core.frame import Frame
from ..core.vec import V3, vwhere
from ..geometry.intersect import Hit, occluded
from ..lights import lights as lights_mod
from ..materials import bsdf as bsdf_mod
from ..scene.types import Scene


class Shading(NamedTuple):
    x: V3              # hit position
    sn: V3             # shading normal (two-sided-flipped where the
                       # material is two-sided)
    gn: V3             # geometric normal (same flip rule)
    gn_raw: V3         # canonical geometric normal (no flip) — emission
                       # sidedness keys off this (AreaLight::evaluate is
                       # one-sided, Lights.h:40-47)
    frame: Frame
    wo_local: V3
    uv_u: jax.Array
    uv_v: jax.Array
    mp: bsdf_mod.MatParams
    light_id: jax.Array  # light-table row if the hit triangle is emissive


def pack_attrs(tris, m) -> jax.Array:
    """(T, 44) per-triangle attribute matrix: shading normals, geometric
    normal, uvs, light id, and the triangle's material row pre-joined.

    One packed row fetch per hit replaces ~30 separate small gathers.
    Built from the SoA
    each trace; it is loop-invariant so XLA hoists it out of the bounce
    scan, and at (T, 44) f32 it is small besides.  Scene-sharded mode
    precomputes this at load and shards it over the mesh
    (parallel/scene_shard.py), which is why it is a free function of
    (triangles, materials) rather than of the scene.
    """
    f32 = lambda a: a.astype(jnp.float32)
    mat_rows = jnp.stack([
        f32(m.mtype), m.albedo.x, m.albedo.y, m.albedo.z,
        f32(m.albedo_tex), m.emission.x, m.emission.y, m.emission.z,
        f32(m.is_emissive), m.eta.x, m.eta.y, m.eta.z,
        m.k.x, m.k.y, m.k.z, m.int_ior, m.ext_ior, m.alpha, m.sigma,
        m.coat_thickness, m.coat_sigma_a.x, m.coat_sigma_a.y,
        m.coat_sigma_a.z, m.coat_int_ior, m.coat_ext_ior,
    ], axis=-1)                       # (M, 25)
    per_tri_mat = mat_rows[tris.mat_id]   # (T, 25)
    tri_rows = jnp.stack([
        tris.n0.x, tris.n0.y, tris.n0.z,
        tris.n1.x, tris.n1.y, tris.n1.z,
        tris.n2.x, tris.n2.y, tris.n2.z,
        tris.gn.x, tris.gn.y, tris.gn.z,
        tris.uv0[:, 0], tris.uv0[:, 1],
        tris.uv1[:, 0], tris.uv1[:, 1],
        tris.uv2[:, 0], tris.uv2[:, 1],
        f32(tris.light_id),
    ], axis=-1)                       # (T, 19)
    return jnp.concatenate([tri_rows, per_tri_mat], axis=-1)


def shading_data(scene: Scene, hit: Hit, o: V3, d: V3,
                 geom_grads: bool = False) -> Shading:
    """Interpolate attributes at the hit (reference Scene.h:174-203:
    barycentric normal/uv, two-sided flip toward wo, frame build).

    With `geom_grads`, the hit solution (t, beta, gamma) is re-solved
    differentiably from the (detached) triangle id via Moller-Trumbore
    on the UN-detached vertex arrays and attached straight-through: the
    primal keeps the kernel's values bit-exactly, while gradients see
    d(t,b,g)/d(vertex positions) — the hit-point reparameterization that
    makes positions, frames, and NEE geometry terms differentiable
    w.r.t. scene geometry (interior term only; silhouette boundary
    integrals are a documented descope, diff.py)."""
    from ..ops.gather import gather_rows
    from ..parallel.scene_shard import ShardedBVH, gather_attrs_sharded
    tri = jnp.maximum(hit.tri, 0)
    beta = hit.u
    gamma = hit.v
    t_hit = hit.t
    sharded_attrs = (isinstance(scene.bvh, ShardedBVH)
                     and scene.bvh.attrs is not None)
    if geom_grads and sharded_attrs:
        # scene-sharded mode keeps only a 1-row triangle stub on device;
        # vertex-position gradients need the replicated SoA
        raise NotImplementedError(
            "geom_grads requires a replicated triangle SoA "
            "(scene_shards=0)")
    if geom_grads:
        from ..geometry.intersect import _mt_test
        t_r, u_r, v_r, ok = _mt_test(scene.triangles, tri, o, d)
        # reattach only on real hits: missed lanes (tri clamped to 0)
        # would otherwise feed garbage-lane derivatives into the vjp
        val = (hit.tri >= 0) & ok
        att = lambda a, r: a + jnp.where(
            val, r - jax.lax.stop_gradient(r), 0.0)
        t_hit = att(t_hit, t_r)
        beta = att(beta, u_r)
        gamma = att(gamma, v_r)
    alpha = 1.0 - beta - gamma
    if sharded_attrs:
        # attribute tables sharded by primitive: gather-by-owner + psum
        rows = gather_attrs_sharded(scene.bvh, tri)
    else:
        rows = gather_rows(pack_attrs(scene.triangles, scene.materials),
                           tri)                     # (N, 44)
    col = lambda i: rows[:, i]
    v3 = lambda i: V3(rows[:, i], rows[:, i + 1], rows[:, i + 2])
    n = (v3(0) * alpha + v3(3) * beta + v3(6) * gamma).normalize()
    u_attr = col(12) * alpha + col(14) * beta + col(16) * gamma
    v_attr = col(13) * alpha + col(15) * beta + col(17) * gamma
    uv = jnp.stack([u_attr, v_attr], axis=-1)
    # tris.gn is canonicalized at load time to agree with vertex normal 0
    # (reference Triangle::gNormal semantics).
    gn = v3(9)
    light_id = col(18).astype(jnp.int32)
    # missed lanes carry the BIG_T sentinel (~f32 max): o + d*BIG_T can
    # overflow to inf, and a single inf here NaNs the whole vjp via
    # 0*inf in downstream mask transposes — clamp at the source (hit
    # lanes are unaffected: real t is scene-scale)
    x = o + d * jnp.minimum(t_hit, 1e12)
    wo = -d
    b = 19  # material columns base
    tid = col(b + 4).astype(jnp.int32)
    from ..imaging import texture as tex_mod
    tex_col = tex_mod.sample(scene.textures, tid, uv[:, 0], uv[:, 1])
    albedo = vwhere(tid >= 0, tex_col, v3(b + 1))
    mp = bsdf_mod.MatParams(
        mtype=col(b).astype(jnp.int32),
        albedo=albedo,
        eta=v3(b + 9),
        k=v3(b + 12),
        int_ior=col(b + 15),
        ext_ior=col(b + 16),
        alpha=jnp.maximum(col(b + 17), bsdf_mod.MIN_ALPHA),
        sigma=col(b + 18),
        emission=v3(b + 5),
        is_emissive=col(b + 8) > 0.5,
        coat_thickness=col(b + 19),
        coat_sigma_a=v3(b + 20),
        coat_int_ior=col(b + 23),
        coat_ext_ior=col(b + 24))
    two = bsdf_mod.is_two_sided(mp.mtype)
    flip_s = two & (wo.dot(n) < 0.0)
    flip_g = two & (wo.dot(gn) < 0.0)
    sn = vwhere(flip_s, -n, n)
    gn_raw = gn
    gn = vwhere(flip_g, -gn, gn)
    frame = Frame.from_normal(sn)
    return Shading(x=x, sn=sn, gn=gn, gn_raw=gn_raw, frame=frame,
                   wo_local=frame.to_local(wo),
                   uv_u=uv[:, 0], uv_v=uv[:, 1], mp=mp,
                   light_id=light_id)


def balance_heuristic(pdf_a, pdf_b):
    """Reference Renderer.h:408-410.

    Double-where guard: max(den, 1e-20) is NOT enough once gradients
    flow through the pdfs (geom_grads) — the division's transpose
    computes pdf_a/den², and (1e-20)² underflows f32 to 0 → NaN on
    dead lanes."""
    den = pdf_a + pdf_b
    ok = den > 1e-12
    return jnp.where(ok, pdf_a / jnp.where(ok, den, 1.0), 0.0)


def compute_direct(scene: Scene, sh: Shading, active, r_pick, r1, r2,
                   mis: bool, types=None, r3=None,
                   geom_grads: bool = False,
                   saved_occ=None, return_occ: bool = False,
                   power: bool = False):
    """One-light one-sample NEE; with `mis` the light-strategy term is
    balance-weighted against the BSDF pdf (computeDirectMIS light half,
    Renderer.h:474-512).  The BSDF-strategy half lives in the bounce loop
    (emission weighting), unlike the reference's extra scout ray.

    `saved_occ` replays a previously computed occlusion mask instead of
    re-tracing shadow rays (the wavefront host-chained backward saves
    exactly the traversal results, mirroring the scan-mode remat policy
    save_only_these_names("ray_occ")); `return_occ` exposes the mask so
    the forward pass can record it."""
    ls = lights_mod.sample_one(scene, sh.x, sh.sn, r_pick, r1, r2, r3,
                               geom_grads=geom_grads, power=power)
    specular = bsdf_mod.is_specular(sh.mp.mtype)
    cand = active & ls.valid & ~specular
    wi_local = sh.frame.to_local(ls.wi)
    f = bsdf_mod.evaluate(sh.mp, sh.wo_local, wi_local, types)
    contrib = f * ls.emitted * ls.g_over_pdf
    if mis:
        pdf_b = bsdf_mod.pdf_fn(sh.mp, sh.wo_local, wi_local, types)
        contrib = contrib * balance_heuristic(ls.pdf_solid, pdf_b)
    worth = cand & (contrib.max_comp() > 0.0)
    if saved_occ is not None:
        occ = jax.lax.stop_gradient(saved_occ)
    else:
        # Shadow ray (reference Scene::visible: epsilon pullback both
        # ends).  Segment occlusion is symmetric, so finite-light lanes
        # trace FROM the light toward the surface: NEE shadow origins
        # then cluster on the (small) emitters instead of scattering
        # over every surface in the scene, so neighbouring lanes walk
        # similar nodes.  Infinite lights (env) keep the surface-out
        # direction.
        finite = ls.dist < lights_mod.INF_DIST
        max_t = jnp.where(finite, ls.dist - 2.0 * EPSILON, 1e30)
        shadow_o = vwhere(finite,
                          sh.x + ls.wi * (ls.dist - EPSILON),
                          sh.x + ls.wi * EPSILON)
        shadow_d = vwhere(finite, -ls.wi, ls.wi)
        # mask inactive lanes by zero-length rays to save traversal work
        occ = occluded(
            scene, shadow_o,
            vwhere(worth, shadow_d, V3.full(jnp.shape(r1), 0.0, 0.0, 1.0)),
            jnp.where(worth, max_t, -1.0))
    lit = worth & ~occ
    out = vwhere(lit, contrib, V3.zeros(jnp.shape(r1)))
    return (out, occ) if return_occ else out
