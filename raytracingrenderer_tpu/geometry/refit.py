"""Host-side BVH refit after geometry optimization steps.

`diff.train_step` moves `tri_p0` (the per-triangle anchor vertex; e1/e2
ride along, so each triangle translates rigidly).  The BVH node bounds
— and the light table's detached copy of emitter geometry — were
computed from the ORIGINAL positions at load, so an optimizer loop with
a real learning rate would silently render against a stale acceleration
structure (rays miss geometry that moved out of its leaf box).  This
module turns that footgun into an API: call `refit(scene)` after every
step (or every K steps) that moves vertices.

Refit recomputes node bounds bottom-up over the existing topology
(reference rebuilds from scratch per scene load, Geometry.h:393; a
refit is the standard cheap alternative when connectivity is unchanged).
Partition quality degrades if triangles travel far from their build
positions — rebuild via scene.loader for large motions.

All numpy on host: the flat DFS layout stores children at strictly
larger indices than their parent, so a per-depth-level reverse sweep
(levels cached per topology) is a handful of vectorized passes.  The
CUDA traversal kernel's node rows (ops/traverse.pack_nodes) are packed
from bvh.lo/hi inside each traced render, so they pick up the new
bounds with no extra work here.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.types import BVH, Scene, SceneBounds
from ..core.vec import V3

# levels cache: content fingerprint of the `right` topology array ->
# level index lists.  Keyed by (size, blake2b(right.tobytes())), NOT by
# id(): np.asarray(bvh.right) creates a fresh wrapper each call, so an
# id() key never legitimately hits AND can alias a different topology
# after GC reuses the address (advisor r4) — silently corrupt bounds.
# Hashing 660k int32 (~2.6 MB) costs ~1 ms, far below the O(B*depth)
# level computation it saves.
_LEVELS_CACHE: Dict[Tuple[int, bytes], List[np.ndarray]] = {}


def _internal_levels(right: np.ndarray) -> List[np.ndarray]:
    """Internal-node index arrays grouped by depth, deepest first.

    Depth via vectorized ancestor-chasing on the parent array (children
    of DFS node i are i+1 and right[i], both > i), O(B * tree_depth)
    numpy — milliseconds for the 660k-node bathroom tree, cached per
    topology (refit never changes topology).
    """
    import hashlib
    right = np.ascontiguousarray(right)
    key = (right.shape[0],
           hashlib.blake2b(right.tobytes(), digest_size=16).digest())
    hit = _LEVELS_CACHE.get(key)
    if hit is not None:
        return hit
    b = right.shape[0]
    parent = np.full(b, -1, np.int64)
    ii = np.nonzero(right >= 0)[0]
    parent[ii + 1] = ii
    parent[right[ii]] = ii
    depth = np.zeros(b, np.int32)
    jmp = parent.copy()
    while (jmp >= 0).any():
        live = jmp >= 0
        depth += live
        jmp = np.where(live, parent[np.maximum(jmp, 0)], -1)
    is_int = right >= 0
    levels = []
    for d in range(int(depth.max()) if b else 0, -1, -1):
        idx = np.nonzero(is_int & (depth == d))[0]
        if idx.size:
            levels.append(idx)
    _LEVELS_CACHE[key] = levels
    return levels


def refit_bvh(bvh: BVH, tris) -> BVH:
    """Recompute node bounds from the (possibly moved) triangle SoA.

    Topology (right/start/count) is unchanged; only lo/hi are
    rewritten.  Host-side: arrays must be concrete.
    """
    right = np.asarray(bvh.right)
    start = np.asarray(bvh.start)
    count = np.asarray(bvh.count)
    b = right.shape[0]
    p0 = np.stack([np.asarray(tris.p0.x), np.asarray(tris.p0.y),
                   np.asarray(tris.p0.z)], axis=-1)
    p1 = p0 + np.stack([np.asarray(tris.e1.x), np.asarray(tris.e1.y),
                        np.asarray(tris.e1.z)], axis=-1)
    p2 = p0 + np.stack([np.asarray(tris.e2.x), np.asarray(tris.e2.y),
                        np.asarray(tris.e2.z)], axis=-1)
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    t_count = tri_lo.shape[0]

    lo = np.array(np.asarray(bvh.lo), copy=True)
    hi = np.array(np.asarray(bvh.hi), copy=True)

    leaf = np.nonzero(right < 0)[0]
    acc_lo = np.full((leaf.size, 3), np.inf, np.float32)
    acc_hi = np.full((leaf.size, 3), -np.inf, np.float32)
    for k in range(int(bvh.leaf_max)):
        m = (k < count[leaf])[:, None]
        t = np.minimum(start[leaf] + k, max(t_count - 1, 0))
        acc_lo = np.where(m, np.minimum(acc_lo, tri_lo[t]), acc_lo)
        acc_hi = np.where(m, np.maximum(acc_hi, tri_hi[t]), acc_hi)
    lo[leaf] = acc_lo
    hi[leaf] = acc_hi

    for idx in _internal_levels(right):
        l, r = idx + 1, right[idx]
        lo[idx] = np.minimum(lo[l], lo[r])
        hi[idx] = np.maximum(hi[r], hi[l])
    return BVH(jnp.asarray(lo), jnp.asarray(hi), bvh.right, bvh.start,
               bvh.count, leaf_max=bvh.leaf_max, depth=bvh.depth)


def refit(scene: Scene) -> Scene:
    """Refresh every position-derived cache after `tri_p0` moved:

    - BVH node bounds (bottom-up refit over the fixed topology),
    - the light table's detached copy of emitter geometry (p0/e1/e2/gn
      are re-gathered from the triangle SoA via LightTable.tri),
    - scene bounds (centre/radius from the new root box — infinite
      lights and the wavefront sort key consume these).

    Call between diff.train_step steps when optimizing geometry.
    No-op for BVH-less / sharded scenes beyond the light-table refresh.
    """
    out = scene
    if scene.num_lights:
        lt = scene.lights
        ti = lt.tri
        tr = scene.triangles
        g = lambda c: c.gather(ti)
        e1, e2 = g(tr.e1), g(tr.e2)
        # area/power recomputed too (advisor r4): today only tri_p0 is
        # a parameter (rigid translation, area-preserving), but if
        # e1/e2 ever join the surface, stale areas would silently skew
        # NEE pdfs and power-weighted selection.  power matches the
        # loader: Lum(Le) * area (Rec.709 weights).
        cr = e1.cross(e2)
        area = 0.5 * jnp.sqrt(cr.dot(cr))
        out = out._replace(lights=lt._replace(
            p0=g(tr.p0), e1=e1, e2=e2, gn=g(tr.gn), area=area,
            power=lt.le.lum() * area))
    bvh = scene.bvh
    if isinstance(bvh, BVH):
        bvh = refit_bvh(bvh, scene.triangles)
        lo0 = np.asarray(bvh.lo[0])
        hi0 = np.asarray(bvh.hi[0])
        centre = (lo0 + hi0) * 0.5
        radius = float(np.linalg.norm(hi0 - centre))
        out = out._replace(
            bvh=bvh,
            bounds=SceneBounds(centre=V3.of(*centre),
                               radius=jnp.float32(max(radius, 1e-6))))
    return out
