"""Wavefront path tracer: NEE (+MIS) with Russian roulette as lax.scan.

Data-parallel re-design of reference RayTracer::pathTrace
(RTBase/Renderer.h:328-392): the per-pixel recursion
becomes a bounce-major lax.scan over flat ray batches with alive masks —
RR, depth cutoff and emissive termination are masking, matching the
reference's control flow:

  depth 0..max_depth   : emissive-hit add -> NEE -> RR -> BSDF continue
  depth max_depth+1    : emissive-hit add -> NEE -> stop (Renderer.h:349)

Differences by design (SURVEY.md §7 "behavior-aware, not bug-faithful"):
- MIS between light and BSDF strategies is on by default (the reference
  implements computeDirectMIS but ships non-MIS computeDirect); the
  cfg.mis=False mode reproduces the reference's canHitLight semantics
  exactly.
- Escaped rays multiply the background radiance by the path throughput
  (the reference forgets the throughput on its miss path, Renderer.h:390).
- Emission is one-sided (consistent with AreaLight::evaluate and the NEE
  cos_light clamp; the reference's emissive-hit path is two-sided).

Every random decision is keyed by the ray's PIXEL id (rng.uniform_ids),
not its lane position, so the same state dict drives both this scan-mode
integrator and the compacting wavefront integrator (wavefront.py) with
bit-identical estimates.

The whole estimator is differentiable w.r.t. scene parameters: hit
structure (triangle ids, barycentrics) is stop-gradiented discrete
structure; radiometric quantities flow.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import EPSILON, RenderConfig
from ..core.vec import V3, vwhere
from ..geometry import intersect
from ..lights import lights as lights_mod
from ..materials import bsdf as bsdf_mod
from ..sampling import rng
from ..scene.types import Scene
from .common import Shading, balance_heuristic, compute_direct, shading_data


def init_state(o: V3, d: V3) -> dict:
    """Fresh per-ray bounce state for a batch of primary rays."""
    n = o.x.shape[0]
    return dict(
        o=o, d=d,
        ids=jnp.arange(n, dtype=jnp.uint32),
        throughput=V3.full(n, 1.0, 1.0, 1.0),
        radiance=V3.zeros(n),
        alive=jnp.ones(n, bool),
        # canHitLight=True on the primary ray and after specular bounces
        # (Renderer.h:336-344,391)
        can_hit_light=jnp.ones(n, bool),
        prev_pdf=jnp.zeros(n),  # solid-angle pdf of the previous BSDF draw
    )


def bounce_step(scene: Scene, state: dict, depth, key: jax.Array,
                cfg: RenderConfig, saved=None, return_saved: bool = False):
    """One bounce over the whole (possibly compacted) ray batch.

    `depth` may be a traced scalar.

    `saved` = {"hit": Hit, "occ": bool array} replays recorded traversal
    results instead of walking the BVH — the host-chained wavefront
    backward (wavefront_diff.py) records them in its forward and
    replays here, so reverse-mode never re-traverses (the same
    save-only-traversal policy the scan-mode remat uses).
    `return_saved` makes the forward return (state, saved) to record.
    """
    n = state["o"].x.shape[0]
    zero = V3.zeros(n)
    o, d = state["o"], state["d"]
    ids = state["ids"]
    alive = state["alive"]
    beta = state["throughput"]
    radiance = state["radiance"]

    if saved is not None:
        hit = jax.tree_util.tree_map(jax.lax.stop_gradient, saved["hit"])
    else:
        hit = intersect.closest_hit(scene, o, d, alive)
    found = hit.valid & alive
    missed = alive & ~hit.valid

    # ---- escaped rays: background -------------------------------------
    bg = lights_mod.eval_background(scene, d)
    if lights_mod.background_enabled(scene):
        if cfg.mis:
            # MIS counterweight for the env light reached by BSDF
            # sampling (selection pmf matches sample_one's mode).
            _, pmf_bg = lights_mod.selection_pmf(scene,
                                                 cfg.power_lights)
            pdf_l = lights_mod.background_pdf(scene, d) * pmf_bg
            w_bg = jnp.where(
                state["can_hit_light"], 1.0,
                balance_heuristic(state["prev_pdf"], pdf_l))
        else:
            # canHitLight gating, as for area lights: NEE already
            # accounted for the env at the previous vertex.  (The
            # reference adds the background unconditionally AND
            # un-weighted by throughput, Renderer.h:390 — a double
            # count; not reproduced.)
            w_bg = state["can_hit_light"].astype(jnp.float32)
    else:
        w_bg = jnp.ones(n)  # pure miss colour, not a sampled light
    radiance = radiance + vwhere(missed, beta * bg * w_bg, zero)

    sh = shading_data(scene, hit, o, d, geom_grads=cfg.geom_grads)

    # ---- emissive hit: add Le, terminate ------------------------------
    # One-sided via the canonical gn (AreaLight::evaluate); the
    # flipped gn is vacuously front-facing and would emit the back.
    hit_le = sh.mp.emission
    one_sided = d.dot(sh.gn_raw) < 0.0
    is_light = found & sh.mp.is_emissive
    if cfg.mis:
        pdf_l = lights_mod.hit_light_pdf_solid(
            scene, sh.light_id, o, sh.x, sh.gn_raw,
            power=cfg.power_lights)
        w_le = jnp.where(state["can_hit_light"], 1.0,
                         balance_heuristic(state["prev_pdf"], pdf_l))
    else:
        w_le = state["can_hit_light"].astype(jnp.float32)
    add_le = is_light & one_sided
    if not cfg.debug_no_emission:
        radiance = radiance + vwhere(add_le, beta * hit_le * w_le, zero)

    shade = found & ~is_light  # reference terminates on lights

    # ---- NEE -----------------------------------------------------------
    r_pick = rng.uniform_ids(key, depth, rng.LIGHT_PICK, ids)
    r_lu = rng.uniform_ids(key, depth, rng.LIGHT_POS_U, ids)
    r_lv = rng.uniform_ids(key, depth, rng.LIGHT_POS_V, ids)
    r_aux = rng.uniform_ids(key, depth, rng.LIGHT_AUX, ids)
    direct, occ = compute_direct(
        scene, sh, shade, r_pick, r_lu, r_lv, cfg.mis, cfg.mat_types,
        r3=r_aux, geom_grads=cfg.geom_grads,
        saved_occ=None if saved is None else saved["occ"],
        return_occ=True, power=cfg.power_lights)
    if not cfg.debug_no_nee:
        radiance = radiance + beta * direct
    if cfg.boundary_grads and scene.num_lights:
        # Zero-primal NEE visibility boundary term (edge sampling):
        # forward value is exactly 0 (images bit-unchanged); jax.grad
        # sees the silhouette edge integral the detached estimator
        # misses (integrators/boundary.py).
        from .boundary import boundary_direct
        bnd = boundary_direct(scene, sh, shade, key, depth, ids, cfg)
        radiance = radiance + beta * bnd

    # ---- depth cutoff / RR / BSDF continuation -------------------------
    cont = shade & (depth <= cfg.max_depth)
    if cfg.rr:
        # The survival probability is part of the *sampling*
        # distribution: stop-gradient it (detached estimator), else
        # the 1/p weight leaks a spurious gradient term.
        rr_p = jax.lax.stop_gradient(
            jnp.minimum(beta.lum(), cfg.rr_cap))
        r_rr = rng.uniform_ids(key, depth, rng.RR, ids)
        survive = cont & (r_rr < rr_p)
        beta = vwhere(survive, beta / jnp.maximum(rr_p, 1e-9), beta)
    else:
        survive = cont

    r1 = rng.uniform_ids(key, depth, rng.BSDF_U, ids)
    r2 = rng.uniform_ids(key, depth, rng.BSDF_V, ids)
    rl = rng.uniform_ids(key, depth, rng.BSDF_LOBE, ids)
    wi_local, colour, pdf, ok = bsdf_mod.sample(
        sh.mp, sh.wo_local, r1, r2, rl, cfg.mat_types)
    specular = bsdf_mod.is_specular(sh.mp.mtype)
    # throughput update (Renderer.h:362-374): specular lanes skip the
    # cosine (their colour/pdf already account for it)
    cos_term = jnp.where(specular, 1.0, jnp.abs(wi_local.z))
    weight = colour * (cos_term / jnp.maximum(pdf, 1e-9))
    alive_next = survive & ok & (weight.max_comp() > 0.0)
    beta = vwhere(alive_next, beta * weight, beta)

    wi = sh.frame.to_world(wi_local)
    new_o = sh.x + wi * EPSILON
    out = dict(
        o=vwhere(alive_next, new_o, o),
        d=vwhere(alive_next, wi, d),
        ids=ids,
        throughput=beta,
        radiance=radiance,
        alive=alive_next,
        can_hit_light=jnp.where(alive_next, specular,
                                state["can_hit_light"]),
        prev_pdf=jnp.where(alive_next, pdf, state["prev_pdf"]),
    )
    if return_saved:
        return out, {"hit": hit, "occ": occ}
    return out


def trace_radiance(scene: Scene, o: V3, d: V3, key: jax.Array,
                   cfg: RenderConfig) -> V3:
    """Estimate radiance along a batch of primary rays (one sample/ray)."""
    state = init_state(o, d)

    def bounce(state, depth):
        return bounce_step(scene, state, depth, key, cfg), None

    n_bounces = cfg.max_depth + 2  # depths 0..max_depth+1 (see docstring)
    body = bounce
    if cfg.remat:
        # Checkpointed backward (SURVEY §5): per-bounce residuals are
        # ONLY the traversal results (tagged in geometry/intersect.py);
        # reverse-mode recomputes shading/NEE/BSDF math from the carried
        # ray state and the saved hits, and the BVH walk itself is
        # dead-code under the recompute (its outputs are saved).
        body = jax.checkpoint(
            bounce,
            policy=jax.checkpoint_policies.save_only_these_names(
                "ray_hit", "ray_occ"),
            prevent_cse=False)
    state, _ = jax.lax.scan(body, state,
                            jnp.arange(n_bounces, dtype=jnp.int32))
    return state["radiance"]
