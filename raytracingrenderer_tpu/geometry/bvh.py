"""Host-side binned-SAH BVH build -> flat arrays (numpy).

The reference builds a pointer-tree BVH with a full std::sort per split
(O(n log^2 n), RTBase/Geometry.h:325-398) and declares —
but never uses — binned-SAH constants (Geometry.h:241-243).  Here the
build is the real binned SAH (16 bins, largest centroid axis, or 64 bins
over all axes for scene loads), emitted directly as flattened
depth-first arrays for the traversal kernels:
node i's left child is i+1; `right` holds the right-child index or -1
for leaves.  Builds are per-scene, not per-frame, so host numpy is the
right tool; a C++ builder can slot in behind the same array contract.
"""
from __future__ import annotations

import sys
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..scene.types import BVH

NUM_BINS = 16
# Leaf size of scene loads.  On an H100 (700 W) the CUDA kernel walked the
# 332k-triangle interior fastest with leaves of 4 (primaries 0.78 ms,
# one bounce 1.49 ms, shadows 1.33 ms for 2M rays) against 8 (0.85 /
# 1.77 / 1.51 ms) and 14 (0.98 / 2.27 / 1.82 ms); whole 1080p renders
# were level within noise (PERF.md, PR 1).
MAX_LEAF = 4
TRAVERSE_COST = 1.0
TRIANGLE_COST = 2.0


def build(tp: np.ndarray, max_leaf: int = MAX_LEAF, bins: int = NUM_BINS,
          all_axes: bool = False) -> Tuple[BVH, np.ndarray]:
    """tp: (T, 3, 3) triangle vertex positions.

    Returns (flat BVH, triangle order) — triangles must be reordered by
    `order` so leaves reference contiguous ranges.

    bins/all_axes: SAH quality knobs.  The default (16 bins, largest
    centroid axis) mirrors the reference's declared constants; all_axes
    sweeps every axis's bins and takes the global best.
    """
    t_count = len(tp)
    cent = tp.mean(axis=1).astype(np.float64)
    tri_lo = tp.min(axis=1).astype(np.float64)
    tri_hi = tp.max(axis=1).astype(np.float64)
    order = np.arange(t_count)
    lo_list, hi_list, right_list, start_list, count_list = [], [], [], [], []

    def emit(lo, hi, right, start, count) -> int:
        lo_list.append(lo)
        hi_list.append(hi)
        right_list.append(right)
        start_list.append(start)
        count_list.append(count)
        return len(lo_list) - 1

    def node_bounds(ids):
        return tri_lo[ids].min(axis=0), tri_hi[ids].max(axis=0)

    def surface(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    sys.setrecursionlimit(10000)

    def rec(ids: np.ndarray, start: int) -> int:
        lo, hi = node_bounds(ids)
        n = len(ids)
        if n <= max_leaf:
            order[start:start + n] = ids
            return emit(lo, hi, -1, start, n)
        c = cent[ids]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        axes = (range(3) if all_axes
                else (int(np.argmax(cmax - cmin)),))
        root_area = max(surface(lo, hi), 1e-30)
        best_cost, best_mask = np.inf, None
        for axis in axes:
            extent = cmax[axis] - cmin[axis]
            if extent < 1e-12:
                continue
            rel = (c[:, axis] - cmin[axis]) / extent
            bix = np.minimum((rel * bins).astype(np.int64), bins - 1)
            # Per-bin counts and bounds
            counts = np.bincount(bix, minlength=bins)
            bin_lo = np.full((bins, 3), np.inf)
            bin_hi = np.full((bins, 3), -np.inf)
            for b in range(bins):
                m = bix == b
                if counts[b]:
                    bin_lo[b] = tri_lo[ids[m]].min(axis=0)
                    bin_hi[b] = tri_hi[ids[m]].max(axis=0)
            # Prefix/suffix sweep of areas (same sweep idea as the
            # reference's per-object SAH, but over bins).
            lcnt = np.cumsum(counts)[:-1]
            rcnt = n - lcnt
            l_lo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
            l_hi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
            r_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
            r_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]
            l_area = np.array([surface(l_lo[i], l_hi[i])
                               for i in range(bins - 1)])
            r_area = np.array([surface(r_lo[i], r_hi[i])
                               for i in range(bins - 1)])
            with np.errstate(invalid="ignore"):
                cost = (TRAVERSE_COST + TRIANGLE_COST
                        * (l_area * lcnt + r_area * rcnt) / root_area)
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            b = int(np.argmin(cost))
            if np.isfinite(cost[b]) and cost[b] < best_cost:
                best_cost = float(cost[b])
                best_mask = bix <= b
        if best_mask is None:
            # Degenerate: all centroids coincide — split evenly.
            half = n // 2
            left_ids, right_ids = ids[:half], ids[half:]
        elif best_cost >= TRIANGLE_COST * n and n <= max_leaf:
            # Leaf is cheaper than the best split (cost-based cutoff
            # the reference declares but never applies).
            order[start:start + n] = ids
            return emit(lo, hi, -1, start, n)
        else:
            left_ids, right_ids = ids[best_mask], ids[~best_mask]
        node = emit(lo, hi, 0, 0, 0)  # patched below
        rec(left_ids, start)
        right_idx = rec(right_ids, start + len(left_ids))
        right_list[node] = right_idx
        return node

    if t_count:
        rec(order.copy(), 0)
    else:
        emit(np.zeros(3), np.zeros(3), -1, 0, 0)

    right_np = np.asarray(right_list, np.int32)
    from ..scene.types import tree_depth
    return BVH(
        lo=jnp.asarray(np.asarray(lo_list), jnp.float32),
        hi=jnp.asarray(np.asarray(hi_list), jnp.float32),
        right=jnp.asarray(right_np),
        start=jnp.asarray(start_list, jnp.int32),
        count=jnp.asarray(count_list, jnp.int32),
        leaf_max=int(max((c for c in count_list), default=0)) or 1,
        depth=tree_depth(right_np),
    ), order


def sah_cost(bvh: BVH) -> float:
    """Total SAH cost of a flat tree (root-area-normalised expected
    traversal cost; the builder's own objective — a host-side quality
    metric for A/B'ing build variants without the chip)."""
    lo = np.asarray(bvh.lo, np.float64)
    hi = np.asarray(bvh.hi, np.float64)
    right = np.asarray(bvh.right)
    count = np.asarray(bvh.count)
    d = np.maximum(hi - lo, 0.0)
    area = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                  + d[:, 2] * d[:, 0])
    root = max(area[0], 1e-30)
    leaf = right == -1
    return float((np.where(leaf, TRIANGLE_COST * count, TRAVERSE_COST)
                  * area).sum() / root)


def validate(bvh: BVH, tp_reordered: np.ndarray) -> None:
    """Host-side invariant check: every triangle inside its leaf bounds,
    children inside parents. Raises AssertionError on violation."""
    lo = np.asarray(bvh.lo)
    hi = np.asarray(bvh.hi)
    right = np.asarray(bvh.right)
    start = np.asarray(bvh.start)
    count = np.asarray(bvh.count)
    eps = 1e-3
    covered = np.zeros(len(tp_reordered), bool)
    for i in range(len(lo)):
        if right[i] == -1:
            s, c = start[i], count[i]
            covered[s:s + c] = True
            if c:
                t = tp_reordered[s:s + c].reshape(-1, 3)
                assert (t >= lo[i] - eps).all() and (t <= hi[i] + eps).all(), i
        else:
            for ch in (i + 1, right[i]):
                assert (lo[ch] >= lo[i] - eps).all(), (i, ch)
                assert (hi[ch] <= hi[i] + eps).all(), (i, ch)
    assert covered.all(), "leaf ranges must cover every triangle"
