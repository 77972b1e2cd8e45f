"""Batched ray-scene intersection: brute force oracle + flat-BVH traversal.

Replaces the reference's recursive pointer-chasing traversal
(RTBase/Geometry.h:399-462) with data-parallel forms:

- `closest_hit_brute` / `any_hit_brute`: Moller-Trumbore over all
  triangles, chunked via lax.scan so the (rays, triangles) block stays
  bounded.  This is the correctness oracle and the path for small scenes
  (cornell-box's 36 triangles are one fused broadcast).
- `closest_hit_bvh` / `any_hit_bvh`: the XLA traversal of the flattened
  BVH, a jax.lax.while_loop over the whole ray batch.  It is the CPU path
  and the plain reference of the CUDA kernel (ops/traverse.py), which
  `closest_hit` / `occluded` select for BVH scenes on the GPU.

Triangle test is Moller-Trumbore on (p0, e1, e2); barycentric mapping to
the reference convention (alpha->v0, beta->v1, gamma->v2, Geometry.h:
89-105,106-112) is alpha = 1-u-v, beta = u, gamma = v.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.vec import V3
from ..scene.types import BVH, Triangles

MAX_STACK = 64
DET_EPS = 1e-12
BIG_T = 3.4e38


class Hit(NamedTuple):
    t: jax.Array      # (N,) hit distance (BIG_T if miss)
    tri: jax.Array    # (N,) int32 triangle id (-1 if miss)
    u: jax.Array      # (N,) barycentric beta (weight of v1)
    v: jax.Array      # (N,) barycentric gamma (weight of v2)

    @property
    def valid(self) -> jax.Array:
        return self.tri >= 0


def _mt_test(tris: Triangles, idx, o: V3, d: V3):
    """Moller-Trumbore for rays (N,) against gathered triangles idx (N,)
    or broadcast (N, C).  Returns (t, u, v, hit)."""
    p0 = tris.p0.gather(idx)
    e1 = tris.e1.gather(idx)
    e2 = tris.e2.gather(idx)
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    # double-where: 1/det must never be evaluated at det≈0, or its
    # backward produces 0*inf=NaN on degenerate lanes (geom_grads
    # re-solves this differentiably, common.shading_data)
    bad = jnp.abs(det) < DET_EPS
    inv_det = jnp.where(bad, 0.0, 1.0 / jnp.where(bad, 1.0, det))
    tvec = o - p0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    hit = ((jnp.abs(det) >= DET_EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > 0.0))
    return t, u, v, hit


def miss_all(n_ray: int) -> Hit:
    return Hit(jnp.full(n_ray, BIG_T, jnp.float32),
               jnp.full(n_ray, -1, jnp.int32),
               jnp.zeros(n_ray, jnp.float32),
               jnp.zeros(n_ray, jnp.float32))


def closest_hit_brute(tris: Triangles, o: V3, d: V3,
                      chunk: int = 4096) -> Hit:
    n_tri = tris.count
    n_ray = o.x.shape[0]
    if n_tri == 0:
        return miss_all(n_ray)
    chunk = min(chunk, n_tri)
    # Derive the carry from the ray arrays (not fresh constants) so its
    # device-varying axes match under shard_map.
    best = Hit(jnp.full_like(o.x, BIG_T),
               jnp.full_like(o.x, -1.0).astype(jnp.int32),
               jnp.zeros_like(o.x), jnp.zeros_like(o.x))
    n_chunks = max(1, -(-n_tri // chunk))
    pad = n_chunks * chunk

    def body(carry, start):
        idx = start + jnp.arange(chunk, dtype=jnp.int32)
        valid_tri = idx < n_tri
        safe = jnp.minimum(idx, n_tri - 1)
        t, u, v, hit = _mt_test(
            tris, safe[None, :],
            V3(o.x[:, None], o.y[:, None], o.z[:, None]),
            V3(d.x[:, None], d.y[:, None], d.z[:, None]))
        hit = hit & valid_tri[None, :] & (t < carry.t[:, None])
        t = jnp.where(hit, t, BIG_T)
        j = jnp.argmin(t, axis=1)
        tj = jnp.take_along_axis(t, j[:, None], 1)[:, 0]
        better = tj < carry.t
        sel = jnp.take_along_axis
        new = Hit(
            jnp.where(better, tj, carry.t),
            jnp.where(better, safe[j], carry.tri).astype(jnp.int32),
            jnp.where(better, sel(u, j[:, None], 1)[:, 0], carry.u),
            jnp.where(better, sel(v, j[:, None], 1)[:, 0], carry.v))
        return new, None

    starts = jnp.arange(0, pad, chunk, dtype=jnp.int32)
    best, _ = jax.lax.scan(body, best, starts)
    return best


def any_hit_brute(tris: Triangles, o: V3, d: V3, max_t: jax.Array,
                  chunk: int = 4096) -> jax.Array:
    """True where segment [0, max_t] is occluded."""
    hit = closest_hit_brute(tris, o, d, chunk)
    return hit.valid & (hit.t < max_t)


def _slab(lo, hi, o: V3, inv_d: V3, t_max):
    """Ray-AABB slab test (reference AABB::rayAABB, Geometry.h:151-183).
    lo/hi are (..., 3) gathered node bounds."""
    t0x = (lo[..., 0] - o.x) * inv_d.x
    t1x = (hi[..., 0] - o.x) * inv_d.x
    t0y = (lo[..., 1] - o.y) * inv_d.y
    t1y = (hi[..., 1] - o.y) * inv_d.y
    t0z = (lo[..., 2] - o.z) * inv_d.z
    t1z = (hi[..., 2] - o.z) * inv_d.z
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                   jnp.minimum(t0y, t1y)),
                       jnp.minimum(t0z, t1z))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                   jnp.maximum(t0y, t1y)),
                       jnp.maximum(t0z, t1z))
    return tmin, (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_max)


def traverse_xla(bvh: BVH, tris: Triangles, o: V3, d: V3, t_init,
                 any_hit: bool):
    """The XLA traversal — the CPU path and the CUDA kernel's plain
    reference: a lockstep while_loop over the whole batch.

    Every lane keeps its own stack (an (N, MAX_STACK) array) and visits
    the nearer child first, pruning boxes beyond its best hit; the loop
    runs until the last lane's stack is empty.  On an H100 it measured
    2.5x faster than a stackless skip-link walk in fixed DFS order on
    1080p primaries, 2.8x on bounce rays and level on shadow rays
    (PERF.md, PR 1)."""
    n = o.x.shape[0]
    inv_d = V3(1.0 / jnp.where(jnp.abs(d.x) < 1e-20, 1e-20, d.x),
               1.0 / jnp.where(jnp.abs(d.y) < 1e-20, 1e-20, d.y),
               1.0 / jnp.where(jnp.abs(d.z) < 1e-20, 1e-20, d.z))
    lane = jnp.arange(n)

    # Root box test seeds the stack.  Carries derive from the ray arrays
    # (not fresh constants) so their device-varying axes match under
    # shard_map.
    _, root_hit = _slab(bvh.lo[0], bvh.hi[0], o, inv_d, t_init)
    zero = jnp.zeros_like(o.x).astype(jnp.int32)
    stack = zero[:, None] + jnp.zeros((1, MAX_STACK), jnp.int32)
    sp = root_hit.astype(jnp.int32)

    # Termination is structurally guaranteed (children indices strictly
    # increase in the DFS layout), but a hard iteration cap bounds the
    # worst case.
    max_iters = 4 * bvh.right.shape[0] + 64

    init = (jnp.int32(0), stack, sp,
            Hit(t_init, zero - 1, jnp.zeros_like(o.x),
                jnp.zeros_like(o.x)))

    def cond(state):
        it, _, sp, _ = state
        return jnp.any(sp > 0) & (it < max_iters)

    def body(state):
        it, stack, sp, best = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[lane, top]
        sp = jnp.where(active, sp - 1, sp)
        is_leaf = bvh.right[node] == -1

        # --- leaf: test up to leaf_max triangles -----------------------
        start = bvh.start[node]
        count = bvh.count[node]
        leaf_active = active & is_leaf
        t_b, tri_b, u_b, v_b = best
        for k in range(bvh.leaf_max):
            tri_idx = jnp.minimum(start + k, tris.count - 1)
            t, u, v, hit = _mt_test(tris, tri_idx, o, d)
            hit = hit & leaf_active & (k < count) & (t < t_b)
            t_b = jnp.where(hit, t, t_b)
            tri_b = jnp.where(hit, tri_idx, tri_b).astype(jnp.int32)
            u_b = jnp.where(hit, u, u_b)
            v_b = jnp.where(hit, v, v_b)
        best = Hit(t_b, tri_b, u_b, v_b)
        if any_hit:
            # Early out: once occluded, clear the stack.
            sp = jnp.where(best.tri >= 0, 0, sp)

        # --- inner: test both children, push far then near -------------
        inner_active = active & ~is_leaf
        left = node + 1
        right = bvh.right[node]
        lt, lhit = _slab(bvh.lo[left], bvh.hi[left], o, inv_d, best.t)
        rt, rhit = _slab(bvh.lo[right], bvh.hi[right], o, inv_d, best.t)
        lhit = lhit & inner_active
        rhit = rhit & inner_active
        near_is_left = lt <= rt
        first = jnp.where(near_is_left, left, right)
        second = jnp.where(near_is_left, right, left)
        first_hit = jnp.where(near_is_left, lhit, rhit)
        second_hit = jnp.where(near_is_left, rhit, lhit)
        # push far child first so the near child pops first
        stack = stack.at[lane, jnp.minimum(sp, MAX_STACK - 1)].set(
            jnp.where(second_hit, second, stack[lane, jnp.minimum(
                sp, MAX_STACK - 1)]))
        sp = sp + second_hit.astype(jnp.int32)
        stack = stack.at[lane, jnp.minimum(sp, MAX_STACK - 1)].set(
            jnp.where(first_hit, first, stack[lane, jnp.minimum(
                sp, MAX_STACK - 1)]))
        sp = sp + first_hit.astype(jnp.int32)
        return it + 1, stack, sp, best

    _, _, _, best = jax.lax.while_loop(cond, body, init)
    return best


def closest_hit_bvh(bvh: BVH, tris: Triangles, o: V3, d: V3) -> Hit:
    n = o.x.shape[0]
    return traverse_xla(bvh, tris, o, d, jnp.full(n, BIG_T), False)


def any_hit_bvh(bvh: BVH, tris: Triangles, o: V3, d: V3,
                max_t: jax.Array) -> jax.Array:
    return traverse_xla(bvh, tris, o, d, max_t, True).tri >= 0


def _sort_key(scene, o: V3, d: V3, active) -> jax.Array:
    """Coherence key for wavefront ray sorting: [active | direction
    octant | 6-bit-per-axis Morton cell of the origin].

    Bounce/shadow rays arrive in pixel order but point anywhere;
    regrouping them by (octant, origin cell) lets neighbouring lanes
    (a GPU warp, or the XLA traversal's whole batch) walk similar node
    sequences.  Inactive rays sort to the back, and the wavefront
    integrator slices them off before the next bounce.
    This replaces the reference's tile queue locality (its threads get
    coherence for free from screen-space tiles, Renderer.h:795-853) —
    and is the wavefront "sort/compact rays by liveness" step SURVEY §7
    plans.
    """
    c = scene.bounds.centre
    r = jnp.maximum(scene.bounds.radius, 1e-6)
    def cell(x, cx):
        q = jnp.clip((x - cx) / (2.0 * r) + 0.5, 0.0, 0.999)
        return (q * 64.0).astype(jnp.uint32)          # 6 bits
    def spread3(v):
        # classic 10-bit Morton spread (bit i -> bit 3i); inputs are 6-bit
        v = (v | (v << 16)) & jnp.uint32(0x30000FF)
        v = (v | (v << 8)) & jnp.uint32(0x300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x30C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x9249249)
        return v
    morton = (spread3(cell(o.x, c.x))
              | (spread3(cell(o.y, c.y)) << 1)
              | (spread3(cell(o.z, c.z)) << 2))       # 18 bits
    octant = ((d.x > 0).astype(jnp.uint32)
              | ((d.y > 0).astype(jnp.uint32) << 1)
              | ((d.z > 0).astype(jnp.uint32) << 2))  # 3 bits
    key = (octant << 18) | morton
    return jnp.where(active, key, jnp.uint32(0x7FFFFFFF))


def _bvh_hit(bvh: BVH, tris: Triangles, o: V3, d: V3, t_init,
             any_hit: bool) -> Hit:
    """BVH traversal: the CUDA kernel (ops/traverse.py) where the
    computation is lowered for CUDA, the XLA traversal everywhere else.
    Misses keep t = t_init."""
    from ..ops import traverse

    def xla(o, d, t):
        return tuple(traverse_xla(bvh, tris, o, d, t, any_hit))

    if not traverse.cuda_present():
        return Hit(*xla(o, d, t_init))
    traverse.register()
    return Hit(*jax.lax.platform_dependent(
        o, d, t_init, cpu=xla,
        cuda=lambda o, d, t: traverse.traverse(bvh, tris, o, d, t,
                                               any_hit)))


def closest_hit(scene, o: V3, d: V3, active=None) -> Hit:
    """Scene-level dispatch (reference Scene::traverse, Scene.h:107-130).

    `active` marks live lanes; inactive lanes return misses without
    paying traversal (their search radius is negative).  Rays are
    traversed in the order given: on an H100 a coherence sort of 2M
    bounce rays saved the CUDA kernel 0.14 ms, less than the sort costs
    (PERF.md, PR 1); the wavefront integrator sorts for compaction
    anyway.

    Outputs are stop-gradiented: hit structure (ids, t, barycentrics) is
    discrete path structure under the detached-sampling differentiation
    strategy (SURVEY.md §7), and neither traversal is reverse-mode
    differentiable anyway.
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    n = o.x.shape[0]
    tris = jax.lax.stop_gradient(scene.triangles)
    t_init = jnp.full(n, BIG_T, jnp.float32)
    if active is not None:
        t_init = jnp.where(jax.lax.stop_gradient(active), t_init, -1.0)
    from ..parallel.scene_shard import ShardedBVH, traverse_sharded
    if isinstance(scene.bvh, ShardedBVH):
        h = traverse_sharded(scene.bvh, o, d, t_init)
    elif scene.bvh is not None and scene.triangles.count > 64:
        h = _bvh_hit(scene.bvh, tris, o, d, t_init, False)
        h = h._replace(t=jnp.where(h.tri >= 0, h.t, BIG_T))
    else:
        h = closest_hit_brute(tris, o, d)
        if active is not None:
            dead = ~jax.lax.stop_gradient(active)
            h = Hit(jnp.where(dead, BIG_T, h.t),
                    jnp.where(dead, -1, h.tri), h.u, h.v)
    h = jax.tree_util.tree_map(jax.lax.stop_gradient, h)
    # Residual tag for the remat policy (config.RenderConfig.remat): the
    # checkpointed backward saves exactly these and recomputes the rest,
    # so the BVH walk never runs twice.
    from jax.ad_checkpoint import checkpoint_name
    return jax.tree_util.tree_map(
        lambda a: checkpoint_name(a, "ray_hit"), h)


def occluded(scene, o: V3, d: V3, max_t: jax.Array) -> jax.Array:
    """Scene-level any-hit (reference Scene::visible, Scene.h:161-169).
    Boolean visibility is non-differentiable by nature; stop-gradiented.
    Lanes with max_t < 0 are inactive and skip traversal."""
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    max_t = jax.lax.stop_gradient(max_t)
    tris = jax.lax.stop_gradient(scene.triangles)
    from jax.ad_checkpoint import checkpoint_name
    from ..parallel.scene_shard import ShardedBVH, traverse_sharded
    if isinstance(scene.bvh, ShardedBVH):
        occ = traverse_sharded(scene.bvh, o, d, max_t, any_hit=True).tri >= 0
    elif scene.bvh is not None and scene.triangles.count > 64:
        occ = _bvh_hit(scene.bvh, tris, o, d, max_t, True).tri >= 0
    else:
        occ = any_hit_brute(tris, o, d, max_t)
    return checkpoint_name(occ, "ray_occ")
